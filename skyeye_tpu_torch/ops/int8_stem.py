"""Int8 serving stem: the packed stem conv as an int8 product, exact on its input.

Port of ``skyeye_tpu/ops/int8_stem.py``. The serving input is already uint8, so
quantizing the activation is free and exact; only the weights quantize
(symmetric int8, per output channel). The int8 product wants signed operands:
the input shifts to s8 = u8 - 128 and the epilogue adds back the exact
correction 128 * sum over the valid taps of the dequantized kernel. It is
constant per output channel inside the frame and differs only on the
one-pixel border ring (3x3 conv, zero padding of the shifted input), so it is
9 per-channel tap sums (``tap_sums``) combined under border masks. The
weights come after ``fold_input_scale``, so the module reads frames in 0..255.

``Int8PackedStem`` takes the s2d4-packed frames as NCHW (B, 16 C, H/4, W/4)
uint8 (or float values that are integers in 0..255, the tests' path) and
returns an NCHW view of NHWC memory in ``dtype``. Its buffers come from
``quantize_stem_variables``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .int8_stage import P1, int8_conv


class Int8PackedStem(nn.Module):
    """Serving-only packed stem conv (3x3/1 on the s2d4 input) in int8, then the
    folded bias and SiLU."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.zeros((3, 3, in_channels, out_channels),
                                                     dtype=torch.int8))
        self.register_buffer("w_scale", torch.zeros(out_channels))
        self.register_buffer("bias", torch.zeros(out_channels))
        # tap_sums[r, s, o] = 128 * sum_c kq[r, s, c, o] * ws[o]: tap (r, s)'s share
        # of the +128 correction
        self.register_buffer("tap_sums", torch.zeros((3, 3, out_channels)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("Int8PackedStem is a serving-only path")
        x = x.permute(0, 2, 3, 1)
        if x.dtype == torch.uint8:
            xq = (x.to(torch.int16) - 128).to(torch.int8)
        else:
            xq = (torch.round(x.float()) - 128.0).to(torch.int8)
        y = int8_conv(xq, self.kernel_q, 1, P1).float() * self.w_scale
        _, H, W, _ = y.shape
        h = torch.arange(H, device=y.device).view(1, H, 1, 1)
        w = torch.arange(W, device=y.device).view(1, 1, W, 1)
        top, bot, left, right = h == 0, h == H - 1, w == 0, w == W - 1
        t = self.tap_sums
        zero = torch.zeros((), device=y.device)
        corr = (t.sum((0, 1))
                - torch.where(top, t[0].sum(0), zero)
                - torch.where(bot, t[2].sum(0), zero)
                - torch.where(left, t[:, 0].sum(0), zero)
                - torch.where(right, t[:, 2].sum(0), zero)
                + torch.where(top & left, t[0, 0], zero)
                + torch.where(top & right, t[0, 2], zero)
                + torch.where(bot & left, t[2, 0], zero)
                + torch.where(bot & right, t[2, 2], zero))
        y = y + corr + self.bias
        y = y * torch.sigmoid(y)  # SiLU
        return y.to(self.dtype).permute(0, 3, 1, 2)


def quantize_stem_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The serving stem (after ``fuse_conv_bn``, ``pack_stem_variables`` and
    ``fold_input_scale``) -> ``Int8PackedStem``'s buffers: ``backbone.stem.*``
    becomes ``kernel_q``, ``w_scale``, ``bias`` and ``tap_sums``. Returns a new
    dict."""
    stem = "backbone.stem"
    k = state[f"{stem}.conv.weight"].detach().cpu().numpy().transpose(2, 3, 1, 0)
    k = np.asarray(k, np.float32)
    bias = state[f"{stem}.bn.bias"].detach().cpu().numpy().astype(np.float32)
    if not np.allclose(state[f"{stem}.bn.weight"].detach().cpu().numpy(), 1.0):
        raise ValueError("quantize_stem_variables expects fuse_conv_bn to have run first")
    ws = np.abs(k).reshape(-1, k.shape[-1]).max(0) / 127.0
    ws = np.where(ws == 0.0, 1.0, ws).astype(np.float32)
    kq = np.clip(np.round(k / ws), -127, 127).astype(np.int8)
    k_deq = kq.astype(np.float32) * ws
    taps = 128.0 * k_deq.sum(axis=2)  # (3, 3, cout)
    out = {key: v for key, v in state.items() if not key.startswith(f"{stem}.")}
    out.update({f"{stem}.kernel_q": torch.from_numpy(np.ascontiguousarray(kq)),
                f"{stem}.w_scale": torch.from_numpy(ws),
                f"{stem}.bias": torch.from_numpy(bias.copy()),
                f"{stem}.tap_sums": torch.from_numpy(taps.astype(np.float32))})
    return out
