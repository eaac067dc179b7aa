"""Evaluation metrics: AP, the confusion matrix, matching predictions to labels.

Port of ``skyeye_tpu/utils/metrics.py``, host numpy, the same arithmetic in the
same order (the validation test holds each function to JAX's at 1e-12):

  box_iou_np      pairwise IoU for eval matching
  compute_ap      AP from the precision envelope, 101-point interpolation
  ap_per_class    PR curves at 1000 points, AP per IoU threshold, the max-F1
                  operating point
  process_batch   per-image matching at 10 IoU thresholds with greedy dedup
  ConfusionMatrix conf > 0.25 / IoU > 0.45 greedy matching, background row and
                  column

The figures (``ap_per_class(plot=True)``, ``ConfusionMatrix.plot``) belong to
the plotting slice, which the port does not have yet (ROADMAP.md, Queue 1
item 15): they log a warning saying so, and the numbers are returned all the same.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .general import LOGGER

PLOTS_NOT_PORTED = ("the port has no plotting yet (ROADMAP.md, Queue 1 item 15: "
                    "plot_* of utils/visualization.py)")


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU (N, 4) x (M, 4) xyxy -> (N, M), host numpy."""
    a1, a2 = np.split(box1[:, None, :], 2, axis=2)
    b1, b2 = np.split(box2[None, :, :], 2, axis=2)
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(2)
    area1 = np.clip(a2 - a1, 0, None).prod(2)
    area2 = np.clip(b2 - b1, 0, None).prod(2)
    return inter / (area1 + area2 - inter + eps)


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """AP from PR points via the interpolated precision envelope.
    Returns (ap, precision_envelope, recall_curve)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)  # 101-point interp (COCO)
    # np.trapezoid is NumPy>=2.0; fall back to the old spelling on 1.x
    ap = getattr(np, "trapezoid", np.trapz)(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
    plot: bool = False,
    save_dir: str = ".",
    names: Sequence[str] = (),
    eps: float = 1e-16,
):
    """Per-class AP across IoU thresholds.

    Args:
      tp: (n_pred, n_iou) bool — prediction correctness at each IoU threshold.
      conf, pred_cls: (n_pred,), target_cls: (n_gt,).

    Returns (tp_count, fp_count, p, r, f1, ap, unique_classes) where p/r/f1 are at the
    max-F1 operating point and ap is (n_cls, n_iou).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))

    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)

        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)

        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)

        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = int(f1_curve.mean(0).argmax())  # max-F1 operating point

    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()

    if plot:
        LOGGER.warning("PR/F1/P/R curves not drawn in %s: %s", save_dir, PLOTS_NOT_PORTED)

    return tp_count, fp_count, p, r, f1, ap, unique_classes.astype(int)


def process_batch(detections: np.ndarray, labels: np.ndarray, iouv: np.ndarray) -> np.ndarray:
    """Match detections to GT at each IoU threshold with greedy dedup.

    detections: (n, 6) [x1, y1, x2, y2, conf, cls]; labels: (m, 5) [cls, x1, y1, x2, y2].
    Returns correct: (n, len(iouv)) bool.
    """
    correct = np.zeros((detections.shape[0], iouv.shape[0]), bool)
    if detections.shape[0] == 0 or labels.shape[0] == 0:
        return correct
    iou = box_iou_np(labels[:, 1:], detections[:, :4])
    cls_match = labels[:, 0:1] == detections[None, :, 5]
    for i, thr in enumerate(iouv):
        gt_idx, det_idx = np.where((iou >= thr) & cls_match)
        if len(gt_idx):
            matches = np.stack([gt_idx, det_idx, iou[gt_idx, det_idx]], 1)
            if len(gt_idx) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


class ConfusionMatrix:
    """Detection confusion matrix with background FP/FN rows."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: Optional[np.ndarray], labels: np.ndarray):
        """detections (n, 6) [xyxy, conf, cls]; labels (m, 5) [cls, xyxy]."""
        if detections is None or len(detections) == 0:
            for gc in labels[:, 0].astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        # Detections whose class id is outside this dataset's range (e.g. a
        # model with more classes than the eval set) can't land anywhere in
        # the (nc+1, nc+1) matrix — drop them instead of indexing out of
        # bounds. The reference's ConfusionMatrix (metrics.py) has the same
        # crash; counted-as-nothing matches its semantics for foreign classes.
        detections = detections[detections[:, 5] < self.nc]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)

        if len(labels):
            iou = box_iou_np(labels[:, 1:], detections[:, :4])
            gt_idx, det_idx = np.where(iou > self.iou_thres)
            if len(gt_idx):
                matches = np.stack([gt_idx, det_idx, iou[gt_idx, det_idx]], 1)
                if len(gt_idx) > 1:
                    matches = matches[matches[:, 2].argsort()[::-1]]
                    matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                    matches = matches[matches[:, 2].argsort()[::-1]]
                    matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            else:
                matches = np.zeros((0, 3))
        else:
            matches = np.zeros((0, 3))

        n = len(matches) > 0
        m0, m1, _ = matches.T.astype(int) if n else (np.zeros(0, int),) * 3
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1  # correct/confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for i, dc in enumerate(det_classes):
            if not n or not (m1 == i).any():
                self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self) -> Tuple[np.ndarray, np.ndarray]:
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]

    def plot(self, normalize: bool = True, save_dir: str = ".", names: Sequence[str] = ()):
        LOGGER.warning("confusion matrix not drawn in %s: %s", save_dir, PLOTS_NOT_PORTED)

    def print(self):
        for row in self.matrix:
            print(" ".join(f"{int(v)}" for v in row))
