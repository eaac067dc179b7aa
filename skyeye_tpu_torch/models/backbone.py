"""CSP-Darknet backbone with CBAM and SPP (NCHW), canonical serving path.

Port of ``skyeye_tpu/models/backbone.py``: Focus + conv/2 + CSP(3d) -> conv/2 +
CSP(9d) [P3/8] -> conv/2 + CSP(9d) + CBAM [P4/16] -> conv/2 + CSP(3d) + SPP
[P5/32], with depth/width multipliers, computing in ``dtype``. ``fused_csp``
swaps stage-1's CSP for ``FusedCSPBlock`` (the fused kernel, serving only), as
the JAX flag does.

``remat`` is JAX's training memory lever (``blocks.remat``): "block" (or True)
recomputes each CSP and SPP block in the backward pass, "stage" each of the
four stages (stem to down2, csp2, down3 to CBAM, down4 to SPP), keeping only
the stage boundaries. The fused-CSP serving mode never recomputes, as in JAX.
"""
from __future__ import annotations

from typing import List, Union

import torch
from torch import nn

from ..ops.fused_csp import FusedCSPBlock
from .attention import CBAM
from .blocks import ConvBlock, CSPBlock, FocusBlock, SPPBlock, remat as recompute


def scaled_channels(x: float, width_multiple: float) -> int:
    return max(round(x * width_multiple), 1)


def scaled_depth(x: int, depth_multiple: float) -> int:
    return max(round(x * depth_multiple), 1)


def feature_channels(base_channels: int, width_multiple: float) -> List[int]:
    """Actual [P3, P4, P5] channel counts emitted by the backbone."""
    return [
        scaled_channels(base_channels * 4, width_multiple),
        scaled_channels(base_channels * 8, width_multiple),
        scaled_channels(base_channels * 16, width_multiple),
    ]


class CSPDarknet(nn.Module):
    """Four-stage CSP-Darknet emitting [P3 (/8), P4 (/16), P5 (/32)]."""

    def __init__(self, base_channels: int = 64, depth_multiple: float = 1.0,
                 width_multiple: float = 1.0, in_channels: int = 3, fused_csp: bool = False,
                 dtype: torch.dtype = torch.float32, remat: Union[bool, str] = False):
        super().__init__()
        self.remat = "" if fused_csp else remat_level(remat)
        w, d = width_multiple, depth_multiple
        c1, c2, c3, c4, c5 = (scaled_channels(base_channels * m, w) for m in (1, 2, 4, 8, 16))
        self.stem = FocusBlock(in_channels, c1, kernel_size=3, dtype=dtype)
        self.down1 = ConvBlock(c1, c2, 3, stride=2, dtype=dtype)
        csp1 = FusedCSPBlock if fused_csp else CSPBlock
        self.csp1 = csp1(c2, c2, scaled_depth(3, d), dtype=dtype)
        self.down2 = ConvBlock(c2, c3, 3, stride=2, dtype=dtype)
        self.csp2 = CSPBlock(c3, c3, scaled_depth(9, d), dtype=dtype)
        self.down3 = ConvBlock(c3, c4, 3, stride=2, dtype=dtype)
        self.csp3 = CSPBlock(c4, c4, scaled_depth(9, d), dtype=dtype)
        self.cbam3 = CBAM(c4, dtype=dtype)
        self.down4 = ConvBlock(c4, c5, 3, stride=2, dtype=dtype)
        self.csp4 = CSPBlock(c5, c5, scaled_depth(3, d), dtype=dtype)
        self.spp4 = SPPBlock(c5, c5, dtype=dtype)

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return recompute(block, x) if self.remat == "block" else block(x)

    def _stage1(self, x: torch.Tensor) -> torch.Tensor:
        return self.down2(self._block(self.csp1, self.down1(self.stem(x))))

    def _stage2(self, x: torch.Tensor) -> torch.Tensor:
        return self._block(self.csp2, x)

    def _stage3(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbam3(self._block(self.csp3, self.down3(x)))

    def _stage4(self, x: torch.Tensor) -> torch.Tensor:
        return self._block(self.spp4, self._block(self.csp4, self.down4(x)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        stage = recompute if self.remat == "stage" else (lambda fn, t: fn(t))
        p3 = stage(self._stage2, stage(self._stage1, x))
        p4 = stage(self._stage3, p3)
        p5 = stage(self._stage4, p4)
        return [p3, p4, p5]


def remat_level(remat: Union[bool, str]) -> str:
    """JAX's remat values: False or "" (off), True or "block", "stage"."""
    level = "block" if remat is True else (remat or "")
    if level not in ("", "block", "stage"):
        raise ValueError(f"remat {remat!r}: one of '', 'block', 'stage'")
    return level
