"""Fixed-shape non-maximum suppression on torch tensors.

Port of ``skyeye_tpu/ops/nms.py``: a confidence gate and an exact top-k
candidate cut per image, then class-offset greedy suppression of the whole
batch in one launch of the hand-written kernel (``nms_kernel``), and a
``(B, max_det, 6)`` output ``[x1, y1, x2, y2, conf, cls]`` with valid counts.

The cut ranks with a stable descending sort, so equal scores keep the lower
index first, as XLA's exact top-k does; PyTorch has no ``approx_max_k``, so the
JAX counterpart of every function here is its ``approx_topk=False`` path.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import nms_kernel
from .boxes import xywh2xyxy

# Class offset for class-aware suppression in one greedy pass.
_MAX_WH = 7680.0

# Pre-NMS candidate budgets: serving confidences keep 1024, eval-like ones 4096.
SERVING_MAX_NMS = 1024
EVAL_MAX_NMS = 4096


def serving_max_nms(conf_thres: float) -> int:
    """Candidate budget for a serving pipeline at the given confidence gate."""
    return SERVING_MAX_NMS if conf_thres >= 0.1 else EVAL_MAX_NMS


def greedy_nms(offset_boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy suppression of one image: the K2 kernel on a CUDA tensor."""
    return nms_kernel.greedy_nms(offset_boxes.contiguous(), scores.contiguous(),
                                 iou_thres, max_det)


def greedy_nms_batched(offset_boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                       max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy suppression of a batch, (B, k, 4) + (B, k) -> (B, max_det) x2:
    one launch of the K1 kernel on a CUDA tensor."""
    return nms_kernel.batched_greedy_nms(offset_boxes.contiguous(), scores.contiguous(),
                                         iou_thres, max_det)


def _class_offset(cand_boxes, cand_cls, agnostic: bool):
    if agnostic:
        return cand_boxes
    return cand_boxes + (cand_cls * _MAX_WH)[..., None]


def suppress_candidates_batched(cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
                                cand_cls: torch.Tensor, iou_thres: float, max_det: int,
                                agnostic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, k, ...) candidates -> ((B, max_det, 6), (B,) int32 valid counts)."""
    offset_boxes = _class_offset(cand_boxes, cand_cls, agnostic)
    keep_idx, keep_valid = greedy_nms_batched(offset_boxes, cand_scores, iou_thres, max_det)
    idx = keep_idx.long()
    out_boxes = torch.gather(cand_boxes, 1, idx[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(cand_scores, 1, idx)
    out_cls = torch.gather(cand_cls, 1, idx)
    det = torch.cat([out_boxes, out_scores[..., None], out_cls[..., None]], dim=-1)
    det = torch.where(keep_valid[..., None], det, torch.zeros_like(det))
    return det, keep_valid.sum(dim=1).int()


def suppress_candidates(cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
                        cand_cls: torch.Tensor, iou_thres: float, max_det: int,
                        agnostic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image's candidates (k, ...) -> ((max_det, 6), () int32 valid count)."""
    offset_boxes = _class_offset(cand_boxes, cand_cls, agnostic)
    keep_idx, keep_valid = greedy_nms(offset_boxes, cand_scores, iou_thres, max_det)
    idx = keep_idx.long()
    det = torch.cat([cand_boxes[idx], cand_scores[idx, None], cand_cls[idx, None]], dim=1)
    det = torch.where(keep_valid[:, None], det, torch.zeros_like(det))
    return det, keep_valid.sum().int()


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis; equal values keep the lower index first."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _candidate_cut(prediction: torch.Tensor, conf_thres: float, multi_label: bool,
                   max_nms: int, class_mask: Optional[torch.Tensor] = None):
    """Confidence gate + exact top-k cut of decoded predictions.

    prediction (..., N, 5 + nc) post-sigmoid [cx, cy, w, h, obj, cls...], with
    any leading batch dims. Returns cand_boxes (..., k, 4) xyxy, cand_scores
    (..., k) with invalid = -1, and cand_cls (..., k) float class ids.
    """
    nc = prediction.shape[-1] - 5
    obj = prediction[..., 4]
    cls_scores = prediction[..., 5:] * obj[..., None]  # conf = obj * cls
    boxes = xywh2xyxy(prediction[..., :4])
    obj_ok = obj > conf_thres
    neg = torch.full((), -1.0, dtype=cls_scores.dtype, device=cls_scores.device)

    if multi_label and nc > 1:
        scores_full = torch.where(obj_ok[..., None] & (cls_scores > conf_thres), cls_scores, neg)
        if class_mask is not None:
            scores_full = torch.where(class_mask, scores_full, neg)
        flat = scores_full.flatten(-2)
        k = min(max_nms, flat.shape[-1])
        top_scores, top_flat_idx = topk_stable(flat, k)
        box_idx = top_flat_idx // nc
        cand_cls = (top_flat_idx % nc).float()
        cand_boxes = torch.gather(boxes, -2, box_idx[..., None].expand(*box_idx.shape, 4))
        cand_scores = torch.where(top_scores > conf_thres, top_scores, neg)
    else:
        best_score = cls_scores.max(dim=-1).values
        best_cls = torch.argmax(cls_scores, dim=-1)  # ties to the lowest class
        score = torch.where(obj_ok & (best_score > conf_thres), best_score, neg)
        if class_mask is not None:
            score = torch.where(class_mask[best_cls], score, neg)
        k = min(max_nms, score.shape[-1])
        cand_scores, top_idx = topk_stable(score, k)
        cand_boxes = torch.gather(boxes, -2, top_idx[..., None].expand(*top_idx.shape, 4))
        cand_cls = torch.gather(best_cls, -1, top_idx).float()
    return cand_boxes, cand_scores, cand_cls


def nms_single(prediction: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
               multi_label: bool = False, agnostic: bool = False, max_det: int = 300,
               max_nms: int = 4096, class_mask: Optional[torch.Tensor] = None):
    """NMS for one image's decoded predictions (N, 5 + nc).

    Returns ((max_det, 6) [x1, y1, x2, y2, conf, cls] zero-padded, () int32 count).
    """
    cut = _candidate_cut(prediction, conf_thres=conf_thres, multi_label=multi_label,
                         max_nms=max_nms, class_mask=class_mask)
    return suppress_candidates(*cut, iou_thres=iou_thres, max_det=max_det, agnostic=agnostic)


def nms_batched(predictions: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                multi_label: bool = False, agnostic: bool = False, max_det: int = 300,
                max_nms: int = 4096, class_mask: Optional[torch.Tensor] = None):
    """Batched NMS: (B, N, 5 + nc) -> ((B, max_det, 6), (B,) int32).

    The cut runs on the whole batch at once; suppression is one kernel launch."""
    cut = _candidate_cut(predictions, conf_thres=conf_thres, multi_label=multi_label,
                         max_nms=max_nms, class_mask=class_mask)
    return suppress_candidates_batched(*cut, iou_thres=iou_thres, max_det=max_det,
                                       agnostic=agnostic)


def non_max_suppression(prediction, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        classes=None, agnostic: bool = False, multi_label: bool = False,
                        max_det: int = 300, max_nms: int = 4096) -> List[np.ndarray]:
    """Reference-signature API: a list of per-image numpy arrays (n_i, 6)."""
    prediction = torch.as_tensor(prediction)
    nc = prediction.shape[2] - 5
    class_mask = None
    if classes is not None:
        class_mask = torch.zeros(nc, dtype=torch.bool, device=prediction.device)
        class_mask[torch.as_tensor(classes, device=prediction.device).long()] = True
    det, n = nms_batched(prediction, conf_thres=conf_thres, iou_thres=iou_thres,
                         multi_label=multi_label, agnostic=agnostic, max_det=max_det,
                         max_nms=max_nms, class_mask=class_mask)
    det = det.cpu().numpy()
    n = n.cpu().numpy()
    return [det[i, : n[i]] for i in range(det.shape[0])]
