"""CSP-Darknet backbone with CBAM and SPP (NCHW), canonical serving path.

Port of ``skyeye_tpu/models/backbone.py``: Focus + conv/2 + CSP(3d) -> conv/2 +
CSP(9d) [P3/8] -> conv/2 + CSP(9d) + CBAM [P4/16] -> conv/2 + CSP(3d) + SPP
[P5/32], with depth/width multipliers, computing in ``dtype``. ``fused_csp``
swaps stage-1's CSP for ``FusedCSPBlock`` (the fused kernel, serving only), as
the JAX flag does.

The serving layouts of the int8 modes (``ops/packed_stem.py``): with
``packed_stem`` the stem is a 3x3/1 conv from the 4x4 space-to-depth packed
frame (48 channels) to 4 c1 and down1 a 2x2/1 conv with ((1, 0), (1, 0))
padding; a raw (B, 3, H, W) input is packed on the device, a (B, 48, H/4, W/4)
one is taken as it is. ``int8_stem`` makes that stem ``Int8PackedStem`` and
``int8_early`` runs stages 1-2 as ``Int8EarlyStage`` (both need
``packed_stem``). JAX puts an ``optimization_barrier`` after the packed stem:
it is a hint to XLA's scheduler (keep the stem's output in memory instead of
recomputing it inside down1's fusion) and has no counterpart here, where each
module's output is materialised anyway.

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
from ..ops.int8_stage import Int8EarlyStage
from ..ops.int8_stem import Int8PackedStem
from ..ops.packed_stem import s2d4_device
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
                 dtype: torch.dtype = torch.float32, remat: Union[bool, str] = False,
                 packed_stem: bool = False, int8_early: bool = False, int8_stem: bool = False):
        super().__init__()
        if (int8_early or int8_stem) and not packed_stem:
            raise ValueError("int8_early and int8_stem require the packed-stem layout")
        serving_only = fused_csp or packed_stem
        self.remat = "" if serving_only else remat_level(remat)
        self.in_channels, self.packed_stem, self.early_int8 = in_channels, packed_stem, int8_early
        w, d = width_multiple, depth_multiple
        c1, c2, c3, c4, c5 = (scaled_channels(base_channels * m, w) for m in (1, 2, 4, 8, 16))
        if int8_early:
            self.int8_early = Int8EarlyStage(c1, c2, c3, scaled_depth(3, d), scaled_depth(9, d),
                                             dtype=dtype)
        else:
            if int8_stem:
                self.stem = Int8PackedStem(16 * in_channels, 4 * c1, dtype=dtype)
            elif packed_stem:
                self.stem = ConvBlock(16 * in_channels, 4 * c1, 3, dtype=dtype)
            else:
                self.stem = FocusBlock(in_channels, c1, kernel_size=3, dtype=dtype)
            self.down1 = (ConvBlock(4 * c1, c2, 2, padding=((1, 0), (1, 0)), dtype=dtype)
                          if packed_stem else ConvBlock(c1, c2, 3, stride=2, dtype=dtype))
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
        if self.packed_stem and x.shape[1] == self.in_channels:  # a raw frame: pack it here
            x = s2d4_device(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        if self.early_int8:
            p3 = self.int8_early(x)
        else:
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
