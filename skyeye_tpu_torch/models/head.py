"""Anchor-based detection head and the anchor decode.

Port of ``skyeye_tpu/models/head.py``. The head takes NCHW features and
returns the JAX layout, (B, H, W, na, nc + 5) raw logits per level, in the
head's ``dtype``; decode runs in float32, as in JAX, and gives (B, N, nc + 5) with xywh in input pixels and sigmoided obj/cls. With
``transformer_heads`` a ``TransformerLayer`` (named ``transformer{i}``) refines
the last level's H*W tokens, in row-major (h, w) order, before its conv;
under spatial sharding it runs on the gathered tokens of the whole map, and
each rank keeps its rows of the result.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..parallel.spatial import gather_spatial, split_spatial
from .attention import TransformerLayer
from .blocks import Conv2d

TRANSFORMER_HEADS = 4  # attention heads of the P5 transformer, as in flax


class DetectionHead(nn.Module):
    """Per-level 1x1 prediction convs -> (B, H, W, na, nc + 5) raw logits."""

    def __init__(self, in_channels: Sequence[int], num_classes: int, num_anchors: int = 3,
                 transformer_heads: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.no = num_classes + 5
        self.num_anchors = num_anchors
        self.num_levels = len(in_channels)
        self.transformer_level = self.num_levels - 1 if transformer_heads else -1
        for i, c in enumerate(in_channels):  # pred0, pred1, transformer2, pred2 as in flax
            if i == self.transformer_level:
                self.add_module(f"transformer{i}",
                                TransformerLayer(c, TRANSFORMER_HEADS, dtype=dtype))
            self.add_module(f"pred{i}", Conv2d(c, num_anchors * self.no, 1, compute_dtype=dtype))

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outputs = []
        for i, feat in enumerate(features):
            if i == self.transformer_level:
                feat = gather_spatial(feat)
                b, c, h, w = feat.shape
                tokens = feat.permute(0, 2, 3, 1).reshape(b, h * w, c)
                tokens = getattr(self, f"transformer{i}")(tokens)
                feat = split_spatial(tokens.reshape(b, h, w, c).permute(0, 3, 1, 2))
            x = getattr(self, f"pred{i}")(feat)
            b, _, h, w = x.shape
            outputs.append(x.permute(0, 2, 3, 1).reshape(b, h, w, self.num_anchors, self.no))
        return outputs


def decode_predictions(outputs: Sequence[torch.Tensor], anchors, input_shape: Tuple[int, int],
                       anchor_major: bool = True) -> torch.Tensor:
    """Decode (B, H, W, na, nc + 5) raw logits per level into (B, N, nc + 5).

    xy = (2 sig - 0.5 + grid) * stride, wh = (2 sig)^2 * anchor * stride, with
    stride = max(in_h / H, in_w / W). ``anchor_major`` emits rows in the
    reference's (na, H, W) order; serving passes False and skips the transpose.
    """
    dev = outputs[0].device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    in_h, in_w = input_shape
    decoded = []
    for i, out in enumerate(outputs):
        b, h, w, na, no = out.shape
        stride = max(in_h / h, in_w / w)
        out = torch.sigmoid(out.float())
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]  # (H, W, 1, 2)
        xy = (out[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (out[..., 2:4] * 2.0) ** 2 * (anchors[i][None, None, :, :] * stride)
        dec = torch.cat([xy, wh, out[..., 4:]], dim=-1)
        if anchor_major:
            dec = dec.permute(0, 3, 1, 2, 4)
        decoded.append(dec.reshape(b, na * h * w, no))
    return torch.cat(decoded, dim=1)


def to_reference_layout(outputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """(B, H, W, na, no) -> the reference's (B, na, H, W, no)."""
    return [o.permute(0, 3, 1, 2, 4) for o in outputs]
