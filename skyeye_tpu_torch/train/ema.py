"""Exponential moving average of the model's parameters.

Port of ``skyeye_tpu/train/ema.py``: d = decay * (1 - exp(-updates / tau)) in
float32, ema = ema * d + p * (1 - d) over the parameters only (BatchNorm's
running statistics are not averaged; validation reads the model's own).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from .optimizer import split_by_kind


@dataclass
class EMAState:
    params: Dict[str, torch.Tensor]  # name -> float32 tensor, as named_parameters
    updates: int = 0


def ema_init(model: nn.Module) -> EMAState:
    return EMAState({k: p.detach().clone() for k, p in model.named_parameters()}, 0)


@torch.no_grad()
def ema_update(state: EMAState, model: nn.Module, decay: float = 0.9999,
               tau: float = 2000.0) -> EMAState:
    """One update with the model's current parameters, in place; returns state."""
    state.updates += 1
    f32 = np.float32
    d = f32(decay) * (f32(1.0) - np.exp(-f32(state.updates) / f32(tau)))
    named = dict(model.named_parameters())
    for part in split_by_kind(list(state.params), named):  # FSDP shards apart
        ema = [state.params[k] for k in part]
        params = [named[k].detach() for k in part]
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, torch._foreach_mul(params, float(f32(1.0) - d)))
    return state


def ema_weights(state: EMAState, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` with the EMA parameters in place of its own
    (buffers, BatchNorm's statistics among them, are the model's)."""
    sd = dict(model.state_dict())
    sd.update(state.params)
    return sd
