"""Tiled inference on 4K frames: overlapping tiles through the detector in one
batch, per-tile NMS, then one class-aware merge NMS per frame.

Port of ``tile_grid``, ``slice_tiles``, ``merge_tile_detections`` and
``detect_tiled`` in ``skyeye_tpu/ops/tiling.py`` (BASELINE.json config #3).
The grid is fixed by the frame shape; tiles are stacked tiles-major (every
frame's tile 0, then tile 1, ...). The merge shifts each tile's detections by
its origin, scores empty slots -1, offsets classes by 7680 px and suppresses
all frames of a batch in one launch of K1, then gathers the kept rows.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import nms
from ..models.head import decode_predictions

_MAX_WH = 7680.0  # class offset of the merge, as in ops/nms.py


def tile_grid(frame_hw: Tuple[int, int], tile: int, overlap: float = 0.2) -> np.ndarray:
    """Tile origins (T, 2) [y, x] covering the frame with at least ``overlap``."""
    h, w = frame_hw
    stride = max(int(tile * (1.0 - overlap)), 1)

    def starts(size):
        if size <= tile:
            return [0]
        s = list(range(0, size - tile, stride))
        s.append(size - tile)  # always cover the far edge exactly
        return sorted(set(s))

    return np.array([[y, x] for y in starts(h) for x in starts(w)], np.int32)


def slice_tiles(frames: torch.Tensor, origins: np.ndarray, tile: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * T, tile, tile, C), tiles-major."""
    return torch.cat([frames[:, y: y + tile, x: x + tile] for y, x in origins.tolist()], dim=0)


def merge_tile_detections(det: torch.Tensor, n: torch.Tensor, origins: np.ndarray, batch: int,
                          iou_thres: float = 0.45, max_det: int = 300
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile detections (B * T, md, 6) in tile pixels, tiles-major, with valid
    counts (B * T,) -> ((B, max_det, 6) in frame pixels, (B,) int32 counts)."""
    t, md = origins.shape[0], det.shape[1]
    det = det.reshape(t, batch, md, 6)
    n = n.reshape(t, batch)
    yx = torch.as_tensor(origins, dtype=torch.float32, device=det.device)
    shift = torch.stack([yx[:, 1], yx[:, 0], yx[:, 1], yx[:, 0]], dim=-1)  # (T, 4) xyxy
    shifted = torch.cat([det[..., :4] + shift[:, None, None, :], det[..., 4:]], dim=-1)
    valid = torch.arange(md, device=det.device) < n[:, :, None]
    shifted = torch.where(valid[..., None], shifted, torch.zeros((), device=det.device))
    per_frame = shifted.permute(1, 0, 2, 3).reshape(batch, t * md, 6)

    scores = torch.where(per_frame[..., 4] > 0, per_frame[..., 4],
                         torch.full((), -1.0, device=det.device))
    offset_boxes = per_frame[..., :4] + (per_frame[..., 5] * _MAX_WH)[..., None]
    keep_idx, keep_valid = nms.greedy_nms_batched(offset_boxes, scores, iou_thres, max_det)
    out = torch.gather(per_frame, 1, keep_idx.long()[..., None].expand(-1, -1, 6))
    out = torch.where(keep_valid[..., None], out, torch.zeros((), device=det.device))
    return out, keep_valid.sum(dim=1).int()


@torch.inference_mode()
def detect_tiled(module, anchors, frames: torch.Tensor, tile: int = 1280,
                 overlap: float = 0.2, conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, max_det_tile: int = 300,
                 on_stage: Optional[Callable[[str], None]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 frames on the module's device -> ((B, max_det, 6)
    detections in frame pixels, (B,) int32 counts). The tiles run through
    ``module`` in its ``dtype`` as one batch of B * T; K1 runs twice: on every
    tile's candidates, then on the merge. ``on_stage``, as the facade's, is
    called with each stage's name as it is issued (slice, model, decode, nms,
    merge)."""
    stage = on_stage or (lambda name: None)
    b, h, w, _ = frames.shape
    origins = tile_grid((h, w), tile, overlap)
    x = slice_tiles(frames, origins, tile).to(module.dtype) / 255.0
    stage("slice")
    outs = module(x.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
    stage("model")
    dec = decode_predictions(outs, anchors, (tile, tile))
    stage("decode")
    det, n = nms.nms_batched(dec, conf_thres=conf_thres, iou_thres=iou_thres, multi_label=False,
                             agnostic=False, max_det=max_det_tile,
                             max_nms=nms.serving_max_nms(conf_thres))
    stage("nms")
    out = merge_tile_detections(det, n, origins, b, iou_thres, max_det)
    stage("merge")
    return out
