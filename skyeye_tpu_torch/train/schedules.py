"""Learning-rate schedules: warmup, then cosine or linear to ``lrf * lr0``.

Port of ``skyeye_tpu/train/schedules.py``. The trainer reads ``host_schedule``:
plain floats for an optimizer step (lr, the bias group's lr, momentum).
``one_cycle_cosine`` and ``linear_schedule`` are the per-step forms, here as
plain Python functions of the step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional


def one_cycle_cosine(lr0: float, lrf: float, epochs: int, steps_per_epoch: int,
                     warmup_steps: int = 0, warmup_init: float = 0.0) -> Callable:
    """Per-step schedule: linear warmup, then cosine decay to lr0 * lrf."""
    def schedule(step) -> float:
        step = float(step)
        e = step / steps_per_epoch
        cos_lr = lr0 * (lrf + (1.0 - lrf) * (1.0 + math.cos(math.pi * e / epochs)) / 2.0)
        if warmup_steps > 0 and step < warmup_steps:
            w = min(max(step / warmup_steps, 0.0), 1.0)
            return warmup_init + w * (lr0 - warmup_init)
        return cos_lr

    return schedule


def linear_schedule(lr0: float, lrf: float, epochs: int, steps_per_epoch: int,
                    warmup_steps: int = 0, warmup_init: float = 0.0) -> Callable:
    """Per-step schedule: linear warmup, then linear decay to lr0 * lrf."""
    def schedule(step) -> float:
        step = float(step)
        e = step / steps_per_epoch
        lin = lr0 * ((1.0 - e / epochs) * (1.0 - lrf) + lrf)
        if warmup_steps > 0 and step < warmup_steps:
            w = min(max(step / warmup_steps, 0.0), 1.0)
            return warmup_init + w * (lr0 - warmup_init)
        return lin

    return schedule


def host_schedule(hyp: Dict[str, float], epochs: int, steps_per_epoch: int,
                  cos_lr: bool = True, warmup_steps: Optional[int] = None) -> Callable:
    """f(opt_step) -> {"lr", "bias_lr", "momentum"} as plain floats: the main
    schedule, and during warmup lr from 0, the bias group's lr from
    ``warmup_bias_lr`` and momentum from ``warmup_momentum``, linearly to lr0
    and ``momentum``."""
    if warmup_steps is None:
        warmup_steps = max(int(round(hyp.get("warmup_epochs", 3.0) * steps_per_epoch)), 100)
    lr0, lrf = float(hyp["lr0"]), float(hyp["lrf"])
    momentum = float(hyp.get("momentum", 0.937))
    warm_mom = float(hyp.get("warmup_momentum", 0.8))
    warm_bias_lr = float(hyp.get("warmup_bias_lr", 0.1))

    def main_lr(step: float) -> float:
        e = step / steps_per_epoch
        if cos_lr:
            return lr0 * (lrf + (1.0 - lrf) * (1.0 + math.cos(math.pi * e / epochs)) / 2.0)
        return lr0 * ((1.0 - e / epochs) * (1.0 - lrf) + lrf)

    def values(opt_step: int) -> Dict[str, float]:
        s = float(opt_step)
        lr = main_lr(s)
        bias_lr, mom = lr, momentum
        if warmup_steps > 0 and s < warmup_steps:
            w = min(s / warmup_steps, 1.0)
            lr = w * lr0
            bias_lr = warm_bias_lr + w * (lr0 - warm_bias_lr)
            mom = warm_mom + w * (momentum - warm_mom)
        return {"lr": lr, "bias_lr": bias_lr, "momentum": mom}

    return values


def make_lr_schedule(hyp: Dict[str, float], epochs: int, steps_per_epoch: int,
                     cos_lr: bool = True, warmup_steps: Optional[int] = None) -> Callable:
    """The per-step lr schedule; ``steps_per_epoch`` and ``warmup_steps`` count
    OPTIMIZER steps (micro-steps divided by the accumulation)."""
    if warmup_steps is None:
        warmup_steps = max(int(round(hyp.get("warmup_epochs", 3.0) * steps_per_epoch)), 100)
    maker = one_cycle_cosine if cos_lr else linear_schedule
    return maker(hyp["lr0"], hyp["lrf"], epochs, steps_per_epoch,
                 warmup_steps=warmup_steps, warmup_init=0.0)
