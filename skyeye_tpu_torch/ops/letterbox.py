"""On-device letterbox: aspect-preserving bilinear resize plus gray padding.

Port of ``letterbox_params`` and ``letterbox_jax``/``letterbox_batch_jax`` in
``skyeye_tpu/ops/letterbox.py``. The resize is the same two one-dimensional
gathers and lerps (rows first, then columns) with the same sample positions, so
it matches the JAX version; ``F.interpolate`` samples differently and is not
used. The host letterbox (``cv2``) is not part of the port yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

PAD_VALUE = 114


def letterbox_params(in_shape, out_shape, scaleup: bool = True):
    """Static letterbox geometry: (gain, pad_w, pad_h) for in (h,w) -> out (h,w)."""
    r = min(out_shape[0] / in_shape[0], out_shape[1] / in_shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = int(round(in_shape[1] * r)), int(round(in_shape[0] * r))
    dw, dh = (out_shape[1] - new_w) / 2, (out_shape[0] - new_h) / 2
    return r, dw, dh


def _axis_samples(n_out: int, n_in: int, pad: float, r: float, device):
    """Source indices and lerp weights along one axis, plus the in-image mask."""
    f32 = torch.float32
    pos = (torch.arange(n_out, dtype=f32, device=device) - torch.tensor(pad, dtype=f32)
           + 0.5) / torch.tensor(r, dtype=f32) - 0.5
    valid = (pos >= -0.5) & (pos <= n_in - 0.5)
    i0 = torch.floor(pos).clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(0, n_in - 1)
    w = (pos - i0).clamp(0.0, 1.0)
    return i0.long(), i1.long(), w, valid


def letterbox_batch(ims: torch.Tensor, out_shape: Tuple[int, int], scaleup: bool = True,
                    pad_value: float = float(PAD_VALUE)) -> torch.Tensor:
    """(B, H, W, C) uint8/float frames -> (B, out_h, out_w, C) float32 on their device."""
    _, in_h, in_w, _ = ims.shape
    out_h, out_w = out_shape
    r, dw, dh = letterbox_params((in_h, in_w), (out_h, out_w), scaleup)
    y0, y1, wy, vy = _axis_samples(out_h, in_h, dh, r, ims.device)
    x0, x1, wx, vx = _axis_samples(out_w, in_w, dw, r, ims.device)

    im = ims.float()
    rows0 = im[:, y0]  # (B, out_h, in_w, C)
    rows1 = im[:, y1]
    rows = rows0 + wy[None, :, None, None] * (rows1 - rows0)  # vertical lerp
    cols0 = rows[:, :, x0]  # (B, out_h, out_w, C)
    cols1 = rows[:, :, x1]
    out = cols0 + wx[None, None, :, None] * (cols1 - cols0)  # horizontal lerp

    mask = (vy[:, None] & vx[None, :])[None, :, :, None]
    return torch.where(mask, out, torch.full((), pad_value, dtype=out.dtype, device=out.device))
