"""Letterbox: aspect-preserving resize plus gray padding, on the host and on the device.

Port of ``skyeye_tpu/ops/letterbox.py``. ``letterbox`` is the host version
(numpy, the dataset's path): JAX's cv2 branch, ``cv2.resize(INTER_LINEAR)`` then
``cv2.copyMakeBorder``, with ``data.imageio.resize_linear`` for the resize (bit
for bit the same). ``letterbox_params`` and ``letterbox_batch`` are the device
version (``letterbox_jax``/``letterbox_batch_jax``): the same two
one-dimensional gathers and lerps (rows first, then columns) with the same
sample positions, so it matches the JAX version; ``F.interpolate`` samples
differently and is not used.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PAD_VALUE = 114


def letterbox(im: np.ndarray, new_shape=(640, 640), color=(PAD_VALUE, PAD_VALUE, PAD_VALUE),
              auto: bool = True, scale_fill: bool = False, scaleup: bool = True,
              stride: int = 32):
    """Host letterbox of an (H, W, C) uint8 image with the reference's semantics.

    Returns (img, (rw, rh), (dw, dh)), as JAX's ``letterbox`` with cv2 does."""
    from ..data.imageio import resize_linear

    shape = im.shape[:2]  # (h, w)
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:  # only scale down (better val mAP)
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # minimum rectangle: pad only to a stride multiple
        dw, dh = dw % stride, dh % stride
    elif scale_fill:  # stretch
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        im = resize_linear(im, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    h, w = im.shape[:2]
    out = np.empty((top + h + bottom, left + w + right) + im.shape[2:], im.dtype)
    out[...] = np.asarray(color[: im.shape[2]] if im.ndim == 3 else color[0], im.dtype)
    out[top: top + h, left: left + w] = im
    return out, ratio, (dw, dh)


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
