"""FPN/PAN feature neck (NCHW).

Port of ``skyeye_tpu/models/neck.py``. Every CSP here has 3 bottlenecks,
whatever the depth multiple, as in the JAX neck. The top-down laterals read
the raw P4/P5 and the bottom-up P5 concat uses the raw P5, as there. With
``remat`` each CSP block is recomputed in the backward pass (``blocks.remat``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ConvBlock, CSPBlock, remat as recompute

NECK_BLOCKS = 3


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NCHW nearest-neighbour 2x upsample: each pixel becomes a 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FeatureNeck(nn.Module):
    """FPN top-down + PAN bottom-up fusion over [P3, P4, P5]."""

    def __init__(self, in_channels: Sequence[int], dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        c3, c4, c5 = in_channels
        self.in_channels = tuple(in_channels)
        self.lateral5 = ConvBlock(c5, c4, 1, dtype=dtype)
        self.lateral4 = ConvBlock(c4, c3, 1, dtype=dtype)
        self.fpn4 = CSPBlock(2 * c4, c4, NECK_BLOCKS, dtype=dtype)
        self.fpn3 = CSPBlock(2 * c3, c3, NECK_BLOCKS, dtype=dtype)
        self.down3 = ConvBlock(c3, c3, 3, stride=2, dtype=dtype)
        self.pan4 = CSPBlock(c3 + c4, c4, NECK_BLOCKS, dtype=dtype)
        self.down4 = ConvBlock(c4, c4, 3, stride=2, dtype=dtype)
        self.pan5 = CSPBlock(c4 + c5, c5, NECK_BLOCKS, dtype=dtype)

    @property
    def out_channels(self) -> List[int]:
        return list(self.in_channels)

    def _csp(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return recompute(block, x) if self.remat else block(x)

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        p3, p4, p5 = features
        p5_td = self.lateral5(p5)
        p4_td = self.lateral4(p4)
        p4_processed = self._csp(self.fpn4, torch.cat([upsample_nearest_2x(p5_td), p4], dim=1))
        p3_processed = self._csp(self.fpn3, torch.cat([upsample_nearest_2x(p4_td), p3], dim=1))
        p4_out = self._csp(self.pan4, torch.cat([self.down3(p3_processed), p4_processed], dim=1))
        p5_out = self._csp(self.pan5, torch.cat([self.down4(p4_out), p5], dim=1))
        return [p3_processed, p4_out, p5_out]
