"""Hyperparameter evolution: mutate, train briefly, keep the fittest.

Port of ``skyeye_tpu/train/evolve.py`` (YOLOv5's ``--evolve``). Each
generation mutates the best hyperparameters so far within per-key bounds,
runs a short training through ``train_fn`` and appends its fitness and
hyperparameters to ``evolve.csv``; the best row wins. The first generation
of a fresh ``evolve.csv`` trains the base hyperparameters unmutated. With the
same seed the mutations are JAX's: both draw from ``np.random.default_rng``.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

from ..utils.general import LOGGER

# key: (mutation gain, min, max), YOLOv5's bounds
EVOLVE_META: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1.0, 1e-5, 0.1),
    "lrf": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_epochs": (1.0, 0.0, 5.0),
    "warmup_momentum": (1.0, 0.0, 0.95),
    "warmup_bias_lr": (1.0, 0.0, 0.2),
    "box": (1.0, 0.02, 0.2),
    "cls": (1.0, 0.2, 4.0),
    "obj": (1.0, 0.2, 4.0),
    "fl_gamma": (0.0, 0.0, 2.0),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "degrees": (1.0, 0.0, 45.0),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.9),
    "shear": (1.0, 0.0, 10.0),
    "flipud": (1.0, 0.0, 1.0),
    "fliplr": (0.0, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
    "mixup": (1.0, 0.0, 1.0),
}


def mutate_hyp(hyp: Dict[str, float], rng: np.random.Generator,
               mp: float = 0.8, sigma: float = 0.2) -> Dict[str, float]:
    """Gaussian mutation of the hyp values within their bounds (each key with
    probability mp; drawn again until at least one key changes)."""
    out = dict(hyp)
    keys = [k for k in EVOLVE_META if k in hyp]
    factors = np.ones(len(keys))
    while (factors == 1).all():
        gains = np.array([EVOLVE_META[k][0] for k in keys])
        factors = np.where(
            (rng.random(len(keys)) < mp) & (gains > 0),
            (rng.normal(1.0, sigma, len(keys)) * gains).clip(0.3, 3.0) ** 1.0,
            1.0,
        )
    for k, f in zip(keys, factors):
        lo, hi = EVOLVE_META[k][1], EVOLVE_META[k][2]
        out[k] = float(np.clip(hyp[k] * f, lo, hi))
    return out


def load_evolve_results(path: Path):
    """(header, rows of floats) of an ``evolve.csv``; ([], []) where there is none."""
    if not path.exists():
        return [], []
    rows = list(csv.reader(path.open()))
    header = rows[0]
    data = [[float(v) for v in r] for r in rows[1:]]
    return header, data


def evolve(train_fn: Callable, base_hyp: Dict[str, float], generations: int = 10,
           save_dir: Path = Path("runs/evolve"), seed: int = 0) -> Dict[str, float]:
    """Run ``generations`` of evolution; ``train_fn(hyp) -> fitness``. Returns the
    best hyp found; the history is ``save_dir/evolve.csv``, which a later call
    continues from."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    csv_path = save_dir / "evolve.csv"
    rng = np.random.default_rng(seed)
    keys = [k for k in EVOLVE_META if k in base_hyp]

    header, data = load_evolve_results(csv_path)
    if not header:
        csv_path.write_text(",".join(["fitness"] + keys) + "\n")

    best_hyp, best_fit = dict(base_hyp), -1.0
    if data:
        best_row = max(data, key=lambda r: r[0])
        best_fit = best_row[0]
        for i, k in enumerate(keys):
            best_hyp[k] = best_row[1 + i]

    for gen in range(generations):
        cand = dict(base_hyp)
        cand.update(best_hyp)
        if best_fit >= 0 or data:
            cand = mutate_hyp(cand, rng)
        fit = float(train_fn(cand))
        with csv_path.open("a", newline="") as f:
            csv.writer(f).writerow([fit] + [cand[k] for k in keys])
        LOGGER.info("evolve gen %d/%d: fitness %.4f (best %.4f)",
                    gen + 1, generations, fit, max(fit, best_fit))
        if fit > best_fit:
            best_fit, best_hyp = fit, cand
    LOGGER.info("evolution complete: best fitness %.4f", best_fit)
    return best_hyp
