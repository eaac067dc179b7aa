"""COCO-protocol mAP in numpy, with pycocotools' semantics.

Port of ``skyeye_tpu/utils/coco_eval.py``, the same arithmetic:

  * greedy per-(image, category) matching in score order; each prediction matches
    the unmatched GT with the highest IoU >= threshold (ties to earlier GT);
  * 10 IoU thresholds 0.5:0.05:0.95;
  * 101-point interpolated precision over recall thresholds 0:0.01:1;
  * area ranges all / small(<32^2) / medium(32^2..96^2) / large(>96^2), maxDets 100;
  * AP averaged over categories present in the GT, then thresholds.

Inputs use the dict schema ``cli/validate.py``'s ``save_one_json`` writes
({"image_id", "category_id", "bbox" [x, y, w, h], "score"}) and a matching GT
list, so ``evaluate_coco(gt, dt)`` reads predictions.json as it is.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou_xywh(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU between (D, 4) and (G, 4) [x, y, w, h] boxes."""
    if not len(dt) or not len(gt):
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0:1], dt[:, 1:2]
    dx2, dy2 = dx1 + dt[:, 2:3], dy1 + dt[:, 3:4]
    gx1, gy1 = gt[None, :, 0], gt[None, :, 1]
    gx2, gy2 = gx1 + gt[None, :, 2], gy1 + gt[None, :, 3]
    iw = np.clip(np.minimum(dx2, gx2) - np.maximum(dx1, gx1), 0, None)
    ih = np.clip(np.minimum(dy2, gy2) - np.maximum(dy1, gy1), 0, None)
    inter = iw * ih
    union = dt[:, 2:3] * dt[:, 3:4] + (gt[None, :, 2] * gt[None, :, 3]) - inter
    return inter / np.maximum(union, 1e-9)


def _match_one(
    dt_boxes: np.ndarray, dt_scores: np.ndarray, gt_boxes: np.ndarray,
    gt_ignore: np.ndarray, max_dets: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pycocotools evaluateImg for one (image, category).

    Returns (dt_matched (T, D) bool, dt_ignore (T, D) bool, dt_scores (D,)) with
    D = min(len(dt), max_dets), T = len(IOU_THRS).
    """
    order = np.argsort(-dt_scores, kind="stable")[:max_dets]
    dt_boxes, dt_scores = dt_boxes[order], dt_scores[order]
    D, G, T = len(dt_boxes), len(gt_boxes), len(IOU_THRS)
    # unignored GT first (pycocotools sorts by _ignore)
    g_order = np.argsort(gt_ignore, kind="stable")
    gt_boxes, gt_ignore = gt_boxes[g_order], gt_ignore[g_order]
    ious = _iou_xywh(dt_boxes, gt_boxes)

    dt_m = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    for ti, thr in enumerate(IOU_THRS):
        gt_used = np.zeros(G, bool)
        for di in range(D):
            best, best_iou = -1, thr - 1e-10
            for gi in range(G):
                # pycocotools: an already-matched GT blocks re-matching only if it
                # is a real (non-ignored) GT — crowd/ignored GT may absorb any
                # number of detections (cocoeval.py evaluateImg's
                # `gtm>0 and not iscrowd` check)
                if gt_used[gi] and not gt_ignore[gi]:
                    continue
                # once we reach ignored GT, a real match already found wins outright
                if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best, best_iou = gi, ious[di, gi]
            if best > -1:
                gt_used[best] = True
                dt_m[ti, di] = True
                dt_ig[ti, di] = gt_ignore[best]
    return dt_m, dt_ig, dt_scores


def evaluate_coco(
    gt: Sequence[Dict], dt: Sequence[Dict], max_dets: int = 100,
    area_rng: str = "all",
) -> Dict[str, float]:
    """COCO bbox evaluation.

    gt: list of {"image_id", "category_id", "bbox" [x,y,w,h]} ground-truth dicts.
    dt: list of {"image_id", "category_id", "bbox", "score"} prediction dicts
        (the schema cli/validate.py save_one_json writes).

    Returns {"AP", "AP50", "AP75", "AR", "per_class": {cat: AP}}.
    """
    lo, hi = AREA_RANGES[area_rng]
    cats = sorted({g["category_id"] for g in gt})
    imgs = sorted({g["image_id"] for g in gt} | {d["image_id"] for d in dt})

    gt_by_key: Dict[Tuple, List] = {}
    for g in gt:
        gt_by_key.setdefault((g["image_id"], g["category_id"]), []).append(g)
    dt_by_key: Dict[Tuple, List] = {}
    for d in dt:
        dt_by_key.setdefault((d["image_id"], d["category_id"]), []).append(d)

    T, R = len(IOU_THRS), len(REC_THRS)
    precision = np.full((T, R, len(cats)), -1.0)
    recall = np.full((T, len(cats)), -1.0)

    for ci, cat in enumerate(cats):
        matched, ignored, scores = [], [], []
        n_gt = 0
        for img in imgs:
            g = gt_by_key.get((img, cat), [])
            d = dt_by_key.get((img, cat), [])
            g_boxes = np.array([x["bbox"] for x in g], float).reshape(-1, 4)
            areas = g_boxes[:, 2] * g_boxes[:, 3]
            g_ignore = ~((areas >= lo) & (areas < hi))
            g_ignore |= np.array([bool(x.get("iscrowd") or x.get("ignore"))
                                  for x in g], bool) if g else np.zeros(0, bool)
            n_gt += int((~g_ignore).sum())
            if not d:
                continue
            d_boxes = np.array([x["bbox"] for x in d], float).reshape(-1, 4)
            d_scores = np.array([x["score"] for x in d], float)
            m, ig, s = _match_one(d_boxes, d_scores, g_boxes, g_ignore, max_dets)
            # unmatched detections outside the area range are ignored too
            d_areas = d_boxes[:, 2] * d_boxes[:, 3]
            order = np.argsort(-d_scores, kind="stable")[:max_dets]
            out_rng = ~((d_areas[order] >= lo) & (d_areas[order] < hi))
            ig = ig | (~m & out_rng[None, :])
            matched.append(m)
            ignored.append(ig)
            scores.append(s)
        if n_gt == 0:
            continue
        if not scores:
            precision[:, :, ci] = 0.0
            recall[:, ci] = 0.0
            continue
        m = np.concatenate(matched, axis=1)
        ig = np.concatenate(ignored, axis=1)
        s = np.concatenate(scores)
        order = np.argsort(-s, kind="stable")
        m, ig = m[:, order], ig[:, order]

        tp = (m & ~ig).astype(float)
        fp = (~m & ~ig).astype(float)
        tp_cum = np.cumsum(tp, axis=1)
        fp_cum = np.cumsum(fp, axis=1)
        for ti in range(T):
            rc = tp_cum[ti] / n_gt
            pr = tp_cum[ti] / np.maximum(tp_cum[ti] + fp_cum[ti], 1e-9)
            recall[ti, ci] = rc[-1] if len(rc) else 0.0
            # monotone precision envelope (right-to-left max), then 101-pt sample
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            idx = np.searchsorted(rc, REC_THRS, side="left")
            q = np.zeros(R)
            valid = idx < len(pr)
            q[valid] = pr[idx[valid]]
            precision[ti, :, ci] = q

    def _mean(x):
        x = x[x > -1]
        return float(x.mean()) if x.size else 0.0

    per_class = {}
    for ci, cat in enumerate(cats):
        p = precision[:, :, ci]
        per_class[cat] = _mean(p)
    return {
        "AP": _mean(precision),
        "AP50": _mean(precision[0]),
        "AP75": _mean(precision[5]),
        "AR": _mean(recall),
        "per_class": per_class,
    }


def gt_from_labels(labels_per_image: Sequence[np.ndarray],
                   shapes: Sequence[Tuple[int, int]]) -> List[Dict]:
    """Build COCO GT dicts from YOLO-normalized labels [(cls, x, y, w, h), ...]
    with per-image (width, height) pixel shapes. image_id is 1-based to match
    cli/validate.py's `seen` counter."""
    out = []
    for i, (lab, (w, h)) in enumerate(zip(labels_per_image, shapes), start=1):
        for cls, x, y, bw, bh in np.asarray(lab, float).reshape(-1, 5):
            out.append({
                "image_id": i,
                "category_id": int(cls),
                "bbox": [(x - bw / 2) * w, (y - bh / 2) * h, bw * w, bh * h],
            })
    return out
