"""Primitive building blocks (NCHW): conv+BN+SiLU, bottleneck, CSP, SPP, Focus.

Port of ``skyeye_tpu/models/blocks.py`` on its serving path. Module and
attribute names follow the flax module names, so a flax variable path maps to
a ``state_dict`` key one to one (``utils/checkpoint.py``).

``dtype`` is flax's: parameters and the ``state_dict`` stay float32 and the
compute runs in ``dtype``. Convs and dense layers cast their input and weights
to it (``Conv2d``, ``Linear``). ``nn.BatchNorm2d`` takes the conv's output in
``dtype`` beside its float32 statistics and parameters, normalises in float32
and returns ``dtype``, as flax's ``_normalize`` does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in ``compute_dtype``
    (flax's ``nn.Conv(dtype=..., param_dtype=float32)``)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``compute_dtype``
    (flax's ``nn.Dense(dtype=..., param_dtype=float32)``)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)


class ConvBlock(nn.Module):
    """Conv2d (no bias) + BatchNorm (eps 1e-5) + SiLU, symmetric k//2 padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding=kernel_size // 2, bias=False, compute_dtype=dtype)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with a residual when the channel counts match."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 expansion: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.cv1 = ConvBlock(in_channels, hidden, 1, dtype=dtype)
        self.cv2 = ConvBlock(hidden, out_channels, 3, dtype=dtype)
        self.add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CSPBlock(nn.Module):
    """Cross-stage-partial: split -> N bottlenecks || bypass -> concat -> 1x1."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.cv1 = ConvBlock(in_channels, hidden, 1, dtype=dtype)
        self.cv2 = ConvBlock(in_channels, hidden, 1, dtype=dtype)
        self.num_blocks = num_blocks
        for i in range(num_blocks):  # named m0, m1, ... as in flax
            self.add_module(f"m{i}", Bottleneck(hidden, hidden, shortcut, 1.0, dtype=dtype))
        self.cv3 = ConvBlock(2 * hidden, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cv1(x)
        for i in range(self.num_blocks):
            y1 = getattr(self, f"m{i}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class SPPBlock(nn.Module):
    """Spatial pyramid pooling: stride-1 max pools (k = 5, 9, 13), concat, 1x1."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_channels // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.cv1 = ConvBlock(in_channels, hidden, 1, dtype=dtype)
        self.cv2 = ConvBlock(hidden * (len(self.kernel_sizes) + 1), out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        # max_pool2d pads with -inf, as flax's max_pool does
        pools = [x] + [F.max_pool2d(x, k, stride=1, padding=k // 2) for k in self.kernel_sizes]
        return self.cv2(torch.cat(pools, dim=1))


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), patches in the order
    [top-left, bottom-left, top-right, bottom-right] (the JAX layout and order)."""
    return torch.cat(
        [x[:, ::2, ::2, :], x[:, 1::2, ::2, :], x[:, ::2, 1::2, :], x[:, 1::2, 1::2, :]],
        dim=-1,
    )


class FocusBlock(nn.Module):
    """Focus stem as one fused conv: space-to-depth 2x2 followed by a k x k conv
    equals a 2k x 2k stride-2 conv on the raw image with permuted weights."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kf = 2 * kernel_size
        self.conv = Conv2d(in_channels, out_channels, kf, stride=2,
                           padding=2 * (kernel_size // 2), bias=False, compute_dtype=dtype)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))
