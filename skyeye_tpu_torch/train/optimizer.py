"""Optimizer: SGD-nesterov or Adam in YOLOv5's parameter groups, gradients
accumulated to the nominal batch.

Port of ``build_optimizer_runtime`` in ``skyeye_tpu/train/optimizer.py`` (an
optax chain under ``inject_hyperparams`` and ``MultiSteps``), written out on
tensors with the chain's order of operations:

  * groups: a parameter named ``*.bias`` is in the *bias* group (lr
    ``bias_lr``); every other one in *other* (lr ``lr``). Weight decay
    reaches the conv and dense kernels only, not BatchNorm's or LayerNorm's
    scale (torch's ``weight`` of a norm) or any bias: three groups in torch
    terms;
  * decay is coupled (``add_decayed_weights`` before the momentum), at
    ``weight_decay * batch_size * accumulate / 64``;
  * SGD is ``optax.trace(nesterov=True)``: t = g + m t, u = g + m t; Adam is
    ``scale_by_adam`` (b1 = hyp momentum, b2 0.999, eps 1e-8, bias-corrected);
    then p += -lr u;
  * lr, bias_lr and momentum are set for each optimizer step by the caller
    (``schedules.host_schedule``), as float32 like JAX's injected values;
  * accumulation is ``MultiSteps``: the micro-steps' gradients are averaged
    (acc += (g - acc) / (n + 1)), and the parameters change only at the
    k-th micro-step.

Under FSDP (``parallel/fsdp.py``) the parameters, their gradients and this
state are DTensors sharded alike, and the same foreach arithmetic runs on
each rank's shard; ``state_dict`` gathers them whole.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

NOMINAL_BATCH = 64
RUNTIME_HYPERPARAMS = ("lr", "bias_lr", "momentum")
ADAM_B2, ADAM_EPS = 0.999, 1e-8


def accumulation_steps(batch_size: int, nominal: int = NOMINAL_BATCH) -> int:
    return max(round(nominal / batch_size), 1)


def parameter_groups(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """Parameter name -> (group, decayed): group "bias" or "other"; decayed for
    the kernels of convs and dense layers (JAX's ``bias_labels`` and
    ``decay_mask`` over the same parameters)."""
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            decayed = leaf == "weight" and isinstance(mod, (nn.Conv2d, nn.Linear))
            out[name] = ("bias" if leaf == "bias" else "other", decayed)
    return out


def split_by_kind(names: List[str], tensors: Dict[str, torch.Tensor]) -> List[List[str]]:
    """``names`` in at most two lists, in order: those whose tensors are FSDP
    shards (DTensors) and the rest; a foreach op takes tensors of one kind."""
    from torch.distributed.tensor import DTensor

    sharded = [k for k in names if isinstance(tensors[k], DTensor)]
    whole = [k for k in names if not isinstance(tensors[k], DTensor)]
    return [part for part in (sharded, whole) if part]


class RuntimeOptimizer:
    """The optimizer and its state: per parameter the momentum trace (SGD) or
    Adam's moments, Adam's step count, and the accumulation's mean gradient,
    ``mini_step`` and ``gradient_step`` (``MultiSteps``'s counters)."""

    def __init__(self, model: nn.Module, hyp: Dict[str, float], adam: bool = False,
                 batch_size: int = 16, accumulate: Optional[int] = None):
        self.accumulate = accumulate if accumulate is not None else accumulation_steps(batch_size)
        self.weight_decay = hyp["weight_decay"] * batch_size * self.accumulate / NOMINAL_BATCH
        self.adam = adam
        self.b1 = float(hyp["momentum"])
        self.hyperparams = {"lr": float(hyp["lr0"]), "bias_lr": float(hyp["lr0"]),
                            "momentum": float(hyp["momentum"])}
        groups = parameter_groups(model)
        self.names: List[str] = [k for k, _ in model.named_parameters()]
        self.group = {k: groups[k][0] for k in self.names}
        self.decayed = {k: groups[k][1] for k in self.names}
        params = dict(model.named_parameters())
        zeros = lambda: {k: torch.zeros_like(params[k], memory_format=torch.preserve_format)  # noqa: E731
                         for k in self.names}
        if adam:
            self.mu, self.nu = zeros(), zeros()
            self.count = 0
        else:
            self.trace = zeros()
        self.acc_grads = zeros() if self.accumulate > 1 else None
        self.mini_step = 0
        self.gradient_step = 0

    def set_hyperparams(self, values: Dict[str, float]) -> None:
        """This step's lr, bias_lr and momentum, rounded to float32 as JAX injects them."""
        for k in RUNTIME_HYPERPARAMS:
            if k in values:
                self.hyperparams[k] = float(np.float32(values[k]))

    @torch.no_grad()
    def step(self, model: nn.Module) -> bool:
        """One micro-step with the gradients in ``.grad`` (None counts as zero).
        Returns True when the parameters changed (the k-th micro-step)."""
        params = dict(model.named_parameters())
        grads = {k: params[k].grad if params[k].grad is not None else torch.zeros_like(params[k])
                 for k in self.names}
        if self.acc_grads is not None:
            n = self.mini_step
            for part in split_by_kind(self.names, params):
                acc = [self.acc_grads[k] for k in part]
                diff = torch._foreach_sub([grads[k] for k in part], acc)
                torch._foreach_div_(diff, float(n + 1))
                torch._foreach_add_(acc, diff)
            emit = n == self.accumulate - 1
            self.mini_step = (n + 1) % self.accumulate
            if not emit:
                return False
            grads = {k: self.acc_grads[k].clone() for k in self.names}
            for t in self.acc_grads.values():
                t.zero_()
        self._apply(params, grads)
        self.gradient_step += 1
        return True

    def _apply(self, params, grads) -> None:
        hp = self.hyperparams
        if self.adam:
            self.count += 1
        for group, lr in (("bias", hp["bias_lr"]), ("other", hp["lr"])):
            for names in split_by_kind([k for k in self.names if self.group[k] == group],
                                       params):
                self._apply_part(names, params, grads, lr)

    def _apply_part(self, names, params, grads, lr) -> None:
        """The update of the parameters ``names`` (one group, one kind) at ``lr``."""
        hp = self.hyperparams
        g = [grads[k] for k in names]
        p = [params[k].detach() for k in names]
        dec = [i for i, k in enumerate(names) if self.decayed[k]]
        if dec and self.weight_decay:
            decayed = torch._foreach_mul([p[i] for i in dec], self.weight_decay)
            summed = torch._foreach_add([g[i] for i in dec], decayed)
            for i, t in zip(dec, summed):
                g[i] = t
        if self.adam:
            u = self._adam(names, g)
        else:
            m = hp["momentum"]
            t = [self.trace[k] for k in names]
            torch._foreach_mul_(t, m)
            torch._foreach_add_(t, g)                 # t = g + m t
            u = torch._foreach_add(g, torch._foreach_mul(t, m))  # u = g + m t
        torch._foreach_add_(p, torch._foreach_mul(u, -lr))

    def _adam(self, names, g):
        b1, b2 = self.b1, ADAM_B2
        mu = [self.mu[k] for k in names]
        nu = [self.nu[k] for k in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        f32 = np.float32
        c1 = float(f32(1.0) - f32(b1) ** f32(self.count))
        c2 = float(f32(1.0) - f32(b2) ** f32(self.count))
        mu_hat = torch._foreach_div(mu, c1)
        nu_hat = torch._foreach_div(nu, c2)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, ADAM_EPS)
        return torch._foreach_div(mu_hat, denom)

    # -- state, for checkpoints ---------------------------------------------------

    def state_dict(self) -> Dict:
        out = {"hyperparams": dict(self.hyperparams), "mini_step": self.mini_step,
               "gradient_step": self.gradient_step, "accumulate": self.accumulate,
               "adam": self.adam}
        if self.adam:
            out.update(mu=self.mu, nu=self.nu, count=self.count)
        else:
            out.update(trace=self.trace)
        if self.acc_grads is not None:
            out["acc_grads"] = self.acc_grads
        from ..parallel.fsdp import whole

        return {k: ({n: whole(t).detach().cpu() for n, t in v.items()} if isinstance(v, dict)
                    and k != "hyperparams" else v) for k, v in out.items()}

    def load_state_dict(self, state: Dict) -> None:
        """Raises ValueError when the state is of another optimizer (Adam against
        SGD, another accumulation, other parameters)."""
        if bool(state.get("adam")) != self.adam or \
                int(state.get("accumulate", 1)) != self.accumulate:
            raise ValueError("optimizer state of another configuration")
        tensors = ("mu", "nu") if self.adam else ("trace",)
        tensors += ("acc_grads",) if self.acc_grads is not None else ()
        for name in tensors:
            mine = getattr(self, name)
            theirs = state[name]
            if set(theirs) != set(mine) or any(tuple(theirs[k].shape) != tuple(mine[k].shape)
                                               for k in mine):
                raise ValueError(f"optimizer state {name!r} holds other parameters")
        for name in tensors:
            for k, t in getattr(self, name).items():
                t.copy_(state[name][k])
        self.hyperparams.update(state.get("hyperparams", {}))
        self.mini_step = int(state.get("mini_step", 0))
        self.gradient_step = int(state.get("gradient_step", 0))
        if self.adam:
            self.count = int(state.get("count", 0))
