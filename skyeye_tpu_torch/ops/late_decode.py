"""Late decode: the pre-NMS candidate cut on the raw head logits, decoding only
the survivors.

Port of ``level_quotas``, ``topk_candidates`` and ``late_decode_nms`` in
``skyeye_tpu/ops/late_decode.py``, the JAX facade's default single-label
serving path. Per level, score = sigmoid(obj) * sigmoid(max cls logit) with the
reference's gate (obj > conf and score > conf, the first compared on the
logit), an exact top-k of that level's quota (equal scores keep the lower
index, as ``jax.lax.top_k``), then the sigmoid/grid/anchor decode of the k
survivors only. The card has no approximate top-k, so this is JAX's
``approx_topk=False`` cut; JAX's ``SKYEYE_FLAT_DECODE`` and
``SKYEYE_TOPK_RECALL`` tuning switches have no counterpart.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from .boxes import xywh2xyxy
from .nms import suppress_candidates_batched, topk_stable


def level_quotas(counts: Sequence[int], max_nms: int) -> List[int]:
    """Per-level candidate quotas, proportional to each level's anchor count,
    rounded to multiples of 128, at least 128, at most the level's size."""
    total = float(sum(counts))
    ks = []
    for c in counts:
        k = int(round(max_nms * c / total / 128.0)) * 128
        ks.append(min(c, max(128, k)))
    return ks


def topk_candidates(outputs: Sequence[torch.Tensor], anchors, input_shape: Tuple[int, int],
                    conf_thres: float = 0.25, max_nms: int = 4096,
                    class_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W, na, no) raw logits per level -> the top candidates: boxes
    (B, K, 4) xyxy in input pixels, scores (B, K) with invalid = -1, classes
    (B, K) as floats; K is the sum of the level quotas. ``class_mask`` (nc,)
    drops candidates whose argmax class it excludes."""
    dev = outputs[0].device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    in_h, in_w = input_shape
    conf_logit = math.log(conf_thres / (1.0 - conf_thres)) if conf_thres > 0 else -math.inf
    quotas = level_quotas([o.shape[1] * o.shape[2] * o.shape[3] for o in outputs], max_nms)

    all_boxes, all_scores, all_cls = [], [], []
    for i, out in enumerate(outputs):
        b, h, w, na, _ = out.shape
        stride = max(in_h / h, in_w / w)
        obj_l = out[..., 4].float()                       # (B, H, W, na)
        cls_l = out[..., 5:].float()                      # (B, H, W, na, nc)
        score = torch.sigmoid(obj_l) * torch.sigmoid(cls_l.amax(dim=-1))
        valid = (obj_l > conf_logit) & (score > conf_thres)
        if class_mask is not None:
            valid &= class_mask[cls_l.argmax(dim=-1)]
        score = torch.where(valid, score, torch.full((), -1.0, device=dev)).reshape(b, -1)

        top_scores, top_idx = topk_stable(score, quotas[i])   # flat idx = (y W + x) na + a
        a = top_idx % na
        pix = top_idx // na
        rows = out[torch.arange(b, device=dev)[:, None], pix // w, pix % w, a].float()
        sr = torch.sigmoid(rows)                          # (B, k, no)
        grid = torch.stack([(pix % w).float(), (pix // w).float()], dim=-1)
        xy = (sr[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (sr[..., 2:4] * 2.0) ** 2 * (anchors[i][a] * stride)
        all_boxes.append(xywh2xyxy(torch.cat([xy, wh], dim=-1)))
        all_scores.append(torch.where(top_scores > conf_thres, top_scores,
                                      torch.full((), -1.0, device=dev)))
        all_cls.append(rows[..., 5:].argmax(dim=-1).float())
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1), torch.cat(all_cls, dim=1)


def late_decode_nms(outputs: Sequence[torch.Tensor], anchors, input_shape: Tuple[int, int],
                    conf_thres: float = 0.25, iou_thres: float = 0.45, agnostic: bool = False,
                    max_det: int = 300, max_nms: int = 4096,
                    class_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head logits -> ((B, max_det, 6) detections, (B,) int32 counts): the
    cut of ``topk_candidates``, then one batched suppression (K1 on the card)."""
    boxes, scores, cls = topk_candidates(outputs, anchors, input_shape, conf_thres=conf_thres,
                                         max_nms=max_nms, class_mask=class_mask)
    return suppress_candidates_batched(boxes, scores, cls, iou_thres=iou_thres,
                                       max_det=max_det, agnostic=agnostic)
