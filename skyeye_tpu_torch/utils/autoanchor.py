"""Anchor fitting: k-means over the dataset's box shapes, and the anchors' check.

Port of ``skyeye_tpu/utils/autoanchor.py`` (numpy, seeded as JAX seeds it:
``np.random.default_rng(seed)``). Anchors are grid units per level, as
``config.DEFAULT_ANCHORS``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .general import LOGGER


def anchor_fitness(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0) -> float:
    """Mean best-anchor ratio metric (higher is better), YOLOv5 convention."""
    r = wh[:, None, :] / anchors[None, :, :]
    x = np.minimum(r, 1.0 / r).min(2)  # worst-axis ratio per pair
    best = x.max(1)
    return float((best * (best > 1.0 / thr)).mean())


def check_anchors(dataset_wh_px: np.ndarray, anchors_grid, strides: Sequence[int],
                  img_size: int = 640, thr: float = 4.0) -> float:
    """Best-possible-recall style check: fraction of dataset boxes matched by at
    least one anchor within the ratio threshold.

    dataset_wh_px: (n, 2) box sizes in pixels at img_size scale.
    anchors_grid: (nl, na, 2) grid-unit anchors.
    """
    anchors_px = np.concatenate(
        [np.asarray(a) * s for a, s in zip(anchors_grid, strides)], 0
    )
    r = dataset_wh_px[:, None, :] / anchors_px[None, :, :]
    x = np.minimum(r, 1.0 / r).min(2)
    bpr = float((x.max(1) > 1.0 / thr).mean())
    LOGGER.info("anchor check: best-possible recall %.4f (thr %.1f)", bpr, thr)
    return bpr


def kmean_anchors(dataset_wh_px: np.ndarray, n: int = 9, img_size: int = 640,
                  thr: float = 4.0, iterations: int = 300,
                  seed: int = 0) -> np.ndarray:
    """Fit n anchors to dataset box sizes with k-means (IoU-ratio metric) + a
    genetic refinement pass. Returns (n, 2) pixel anchors sorted by area."""
    wh = dataset_wh_px[(dataset_wh_px >= 2.0).all(1)]  # ignore sub-2px boxes
    if len(wh) < n:
        raise ValueError(f"need at least {n} boxes, got {len(wh)}")
    rng = np.random.default_rng(seed)

    # k-means init: log-space quantiles, then Lloyd iterations under ratio metric
    k = wh[rng.choice(len(wh), n, replace=False)].astype(np.float64)
    for _ in range(50):
        r = wh[:, None, :] / k[None, :, :]
        d = 1.0 - np.minimum(r, 1.0 / r).min(2)  # distance = 1 - worst ratio
        assign = d.argmin(1)
        for j in range(n):
            sel = wh[assign == j]
            if len(sel):
                k[j] = sel.mean(0)

    # genetic refinement (mutate, keep improvements)
    f = anchor_fitness(wh, k, thr)
    shape = k.shape
    for _ in range(iterations):
        mutation = np.ones(shape)
        while (mutation == 1).all():
            mutation = (
                (rng.random(shape) < 0.9) * rng.normal(1, 0.1, shape)
            ).clip(0.3, 3.0)
            mutation[mutation == 0] = 1.0
        kg = (k * mutation).clip(2.0, img_size)
        fg = anchor_fitness(wh, kg, thr)
        if fg > f:
            f, k = fg, kg
    k = k[np.argsort(k.prod(1))]
    LOGGER.info("kmean_anchors: fitness %.4f, anchors:\n%s", f, np.round(k, 1))
    return k.astype(np.float32)


def fit_anchors_for_dataset(dataset, img_size: int = 640,
                            strides: Sequence[int] = (8, 16, 32),
                            na_per_level: int = 3, thr: float = 4.0):
    """Fit per-level grid-unit anchors from an AerialDataset's labels."""
    whs = []
    for labels, shape in zip(dataset.labels, dataset.shapes):
        if len(labels):
            w0, h0 = shape  # (w, h)
            scale = img_size / max(w0, h0)
            whs.append(labels[:, 3:5] * np.array([w0, h0]) * scale)
    wh = np.concatenate(whs, 0) if whs else np.zeros((0, 2))
    k_px = kmean_anchors(wh, n=na_per_level * len(strides), img_size=img_size, thr=thr)
    levels = []
    for i, s in enumerate(strides):
        level = k_px[i * na_per_level : (i + 1) * na_per_level] / s
        levels.append(tuple(tuple(float(v) for v in a) for a in level))
    return tuple(levels)
