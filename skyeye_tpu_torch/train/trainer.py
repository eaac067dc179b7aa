"""The train step and its state; fitness and early stopping.

Port of ``skyeye_tpu/train/trainer.py``. JAX carries params, BatchNorm
statistics, the optimizer state and the EMA as one pytree through a jitted
step; here the model holds its parameters and statistics, and the step runs
the micro-step in order: uint8 frames normalised on the device, the device
augmentation, the image-index column filled from the row, the forward in
train mode (BatchNorm's statistics of this micro-step kept, flax's way), the
loss with the loader's wrap-around rows weighted 0, the backward, the
optimizer (which changes the parameters at the k-th micro-step only) and the
EMA, on every micro-step.

Over a mesh (``parallel.create_mesh`` in a process group), the step is JAX's
step over a batch sharded on the data axis: each rank is handed its rows of
the global batch; the device augmentation gathers the global batch's uint8
frames and renders this rank's rows from the global batch's draws;
forward and backward run in ``parallel.data_parallel``, so BatchNorm takes
global-batch statistics and the loss divides by global-batch sums; the
ranks' gradients and metrics are then summed in one collective (a
parameter FSDP shards arrives summed already). Every rank then applies the
same update to the same state, so the state stays identical on every rank.

Over a mesh with a spatial axis (``create_mesh(n_data, n_spatial)``), each
rank is handed its rows of its data share's frames (``shard_batch(...,
spatial=True)``) and the whole share's targets. The device augmentation
gathers the whole frames (the spatial group, then the data group), renders
the data share and keeps this rank's rows. Forward and backward run in
``parallel.spatial.spatial_parallel`` and in ``data_parallel`` over the
world, so BatchNorm and the loss's normalisers take every rank's rows, and
the gradients and metrics are summed over the world.
"""
from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel.collectives import all_reduce_flat, data_parallel, gather_rows
from ..parallel.spatial import spatial_parallel
from .ema import EMAState, ema_init, ema_update
from .optimizer import RuntimeOptimizer


@dataclass
class TrainState:
    model: nn.Module          # parameters and BatchNorm statistics
    opt: RuntimeOptimizer     # momenta or moments, accumulation counters
    ema: EMAState
    step: int = 0             # micro-steps taken


def create_train_state(model: nn.Module, opt: RuntimeOptimizer) -> TrainState:
    return TrainState(model=model, opt=opt, ema=ema_init(model), step=0)


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every dropout of the model the generator its masks come from."""
    for m in model.modules():
        if hasattr(m, "generator") and hasattr(m, "p"):
            m.generator = generator


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator for one micro-step, from a seed and the step (JAX folds the
    step into its key)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def make_train_step(module: nn.Module, loss_fn, tx: RuntimeOptimizer,
                    ema_decay: float = 0.9999, device_augment: Optional[Callable] = None,
                    dropout_seed: int = 0,
                    on_stage: Optional[Callable[[str], None]] = None,
                    mesh=None) -> Callable:
    """The train step, JAX's ``make_train_step``.

    loss_fn(predictions, targets, mask[, img_weight]) -> (loss, aux[3]).
    batch: dict(images=(B, H, W, 3) uint8 or float on the device, targets=(B,
    M, 6), mask=(B, M) bool); optional n_valid (rows from n_valid on get loss
    weight 0), opt_hyperparams ({"lr", "bias_lr", "momentum"}) and, with
    ``device_augment(images, targets, mask, generator)``, aug_generator.
    Dropout draws from a generator made from ``dropout_seed`` and the step.
    ``on_stage(name)``, when given, is called after "augment", "forward",
    "loss", "backward" and "optimizer" (the optimizer and the EMA).

    ``mesh`` (a ``parallel.Mesh`` over a process group): the batch holds this
    rank's rows of the global batch (data rank r the r-th share; with a spatial
    axis, the spatial rank's image rows of it), n_valid counts the global
    batch's valid rows, ``device_augment`` takes a ``rows`` keyword, and the
    metrics are the global batch's.

    step(state, batch) -> (state, metrics) with metrics loss, box, obj, cls as
    0-d tensors on the device; the state is updated in place.
    """
    try:
        target = loss_fn if inspect.isfunction(loss_fn) else loss_fn.__call__
        takes_img_weight = "img_weight" in inspect.signature(target).parameters
    except (TypeError, ValueError):
        takes_img_weight = False
    # uint8 frames are normalised in bf16 only for a bf16 model that runs no
    # augmentation (JAX's rule); else in float32
    norm_dtype = getattr(module, "dtype", torch.float32)
    if device_augment is not None or norm_dtype != torch.bfloat16:
        norm_dtype = torch.float32
    mark = on_stage or (lambda name: None)
    group = mesh.group if mesh is not None else None  # the data axis
    world = mesh.world_group if mesh is not None else None  # BatchNorm, loss, gradients
    n_sp = mesh.n_spatial if mesh is not None else 1

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        images = batch["images"]
        targets, mask = batch["targets"], batch["mask"]
        B = targets.shape[0]
        first = mesh.rank * B if group is not None else 0  # this rank's first global row
        if device_augment is not None and group is not None:
            # mosaic and mixup read other ranks' rows: the global batch's whole frames, uint8
            if n_sp > 1:
                images = gather_rows(images.transpose(0, 1), mesh.spatial_group).transpose(0, 1)
            images, targets, mask = (gather_rows(t, group) for t in (images, targets, mask))
        if images.dtype == torch.uint8:
            images = images.to(norm_dtype) / 255.0
        if device_augment is not None:
            if group is not None:
                rows = torch.arange(first, first + B, device=images.device)
                images, targets, mask = device_augment(images, targets, mask,
                                                       batch["aug_generator"], rows=rows)
                if n_sp > 1:  # this rank's image rows
                    h = images.shape[1] // n_sp
                    images = images[:, mesh.spatial_rank * h:(mesh.spatial_rank + 1) * h]
            else:
                images, targets, mask = device_augment(images, targets, mask,
                                                       batch["aug_generator"])
        mark("augment")
        M = targets.shape[1]
        flat_targets = targets.reshape(B * M, 6).clone()
        flat_targets[:, 0] = torch.arange(B, dtype=flat_targets.dtype,
                                          device=flat_targets.device).repeat_interleave(M)
        flat_mask = mask.reshape(B * M)
        n_valid = batch.get("n_valid")
        img_weight = None
        if n_valid is not None and takes_img_weight:
            img_weight = (torch.arange(first, first + B, device=images.device)
                          < torch.as_tensor(n_valid, device=images.device)).float()

        model.train()
        set_dropout_generator(model, step_generator(dropout_seed, state.step, images.device))
        for p in model.parameters():
            p.grad = None
        spatial = (spatial_parallel(mesh.spatial_group, n_sp, mesh.spatial_rank)
                   if n_sp > 1 else contextlib.nullcontext())
        with data_parallel(world), spatial:
            outs = model(images.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
            mark("forward")
            if img_weight is not None:
                loss, aux = loss_fn(outs, flat_targets, flat_mask, img_weight=img_weight)
            else:
                loss, aux = loss_fn(outs, flat_targets, flat_mask)
            mark("loss")
            loss.backward()
        loss = loss.detach()
        if world is not None:
            loss, aux = _sum_gradients_and_metrics(model, loss, aux, world)
        mark("backward")
        set_dropout_generator(model, None)

        if batch.get("opt_hyperparams") is not None:
            tx.set_hyperparams(batch["opt_hyperparams"])
        tx.step(model)
        ema_update(state.ema, model, decay=ema_decay)
        state.step += 1
        mark("optimizer")
        metrics = {"loss": loss, "box": aux[0], "obj": aux[1], "cls": aux[2]}
        return state, metrics

    return step_fn


def _sum_gradients_and_metrics(model: nn.Module, loss, aux, group):
    """Sum over ``group``, in one flat collective, every gradient that FSDP does
    not sum (every one, without FSDP) and the metrics; the sums are JAX's global
    gradient and loss (the partial losses sum to the global batch's).
    Returns the summed (loss, aux)."""
    from torch.distributed.tensor import DTensor

    whole = [p for p in model.parameters() if not isinstance(p, DTensor)]
    for p in whole:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    metrics = torch.cat([loss.float().reshape(1), aux.float()])
    all_reduce_flat([p.grad for p in whole] + [metrics], group)
    return metrics[0].to(loss.dtype), metrics[1:].to(aux.dtype)


def fitness(metrics: Dict[str, float]) -> float:
    """0.1 mAP@.5 + 0.9 mAP@.5:.95."""
    return 0.1 * float(metrics.get("map50", 0.0)) + 0.9 * float(metrics.get("map", 0.0))


class EarlyStopping:
    """Stop after ``patience`` epochs without a fitness improvement."""

    def __init__(self, patience: int = 30):
        self.patience = patience or float("inf")
        self.best_fitness = 0.0
        self.best_epoch = 0

    def __call__(self, epoch: int, fit: float) -> bool:
        if fit >= self.best_fitness:
            self.best_fitness = fit
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience
