"""Training: the epoch loop with per-epoch validation on EMA weights,
checkpoints, resume, early stopping and hyperparameter evolution.

Port of ``skyeye_tpu/cli/train.py``. By default, as in JAX, the loader
augments on the host (``augment=True``: mosaic, mixup, the affine or
perspective warp, HSV and flips, ``data/augment.py``); with ``device_aug``
the loader only letterboxes and those run on the card inside the step
(``data/device_aug.py``). ``ComputeLoss`` with YOLOv5 targets;
SGD-nesterov or Adam in two groups (bias, other) with a decay mask, lr, bias
lr and momentum set each optimizer step from ``host_schedule``; gradients
accumulated to the nominal batch 64; EMA; after each epoch, validation on the
EMA weights (K1 in its NMS) with the validation loss; ``results.csv`` with
JAX's header, ``last.pt``/``best.pt`` (their weights the EMA's that were
validated, so the facade and ``validate`` serve them as
they are), resume and early stopping.

The step runs on the card: batches come through the pinned prefetch ring
(``data/prefetch.py``), the uint8 frames are normalised there, and nothing
waits for the host until an epoch ends. ``remat`` ("block" or "stage")
recomputes activations in the backward pass (``models/blocks.py``). ``evolve=N``
runs N generations of short trainings over the same arguments
(``train/evolve.py``): ``<project>/evolve/evolve.csv`` and
``hyp_evolved.yaml``.

Multi-device, as JAX: the data axis is the largest divisor of the batch that
fits the visible cards; with more than one, ``train`` starts one worker
process per card (``parallel/launch.py``, NCCL) and each runs the same
``train`` in the process group. Under ``torchrun`` (or any process group
already joined) the group's world size is the data axis, and a batch it
does not divide raises. Each rank loads its share of every global batch,
the step is the data-parallel step (``train/trainer.py``: synced
BatchNorm, the global batch's loss normalisers, summed gradients), and
``fsdp`` shards the training state (``parallel/fsdp.py``). Rank 0 makes the
run directory, validates on the EMA weights and writes ``results.csv`` and
the checkpoints; the others wait for its fitness, so every rank stops at the
same epoch. ``spatial_shards`` N splits each frame's rows over N ranks
(``parallel/spatial.py``): the world is data axis x N (the data axis is then
the largest divisor of the batch that fits the visible cards / N), the N
ranks of a data share load the same batch and each takes its rows of it
(``shard_batch(..., spatial=True)``'s split; JAX's CLI places the batch
without ``spatial=True`` and lets GSPMD split where it propagates, which
gives the same step). Where the world exceeds the visible cards (two ranks
on one card), the ranks talk over gloo. ``fsdp`` with a data axis above 1
and ``spatial_shards > 1`` raises NotImplementedError (ROADMAP item 8c).
``packed_stem`` is a TPU
lane remap of the stem that JAX calls numerically equivalent: the port trains
the canonical stem for either value (ROADMAP Queue 1 item 9); JAX turns it
off under spatial sharding. The figures of
``plot_results`` are not drawn (a warning; the plotting slice, Queue 1 item 15).

Usage: python -m skyeye_tpu_torch.cli.train --cfg skyeye_s --data drone.yaml \\
           --epochs 100 --batch-size 16 [--device-aug] [--remat stage] [--evolve 10]
"""
from __future__ import annotations

import argparse
import copy
import csv
import dataclasses
import inspect
import os
import time
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import dump_flat_yaml, load_hyp, load_model_config
from ..losses import ComputeLoss
from ..train import (
    EarlyStopping, RuntimeOptimizer, create_train_state, ema_weights, fitness,
    host_schedule, make_train_step,
)
from ..train.optimizer import accumulation_steps
from ..utils.checkpoint import (
    load_torch_checkpoint, merge_matching, restore_train_state, save_train_checkpoint,
)
from ..utils.general import (
    LOGGER, check_dataset, check_img_size, get_latest_run, increment_path, init_seeds,
    labels_to_class_weights, print_args, resolve_device,
)

RESULTS_HEADER = [
    "epoch", "train/box_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision", "metrics/recall", "metrics/mAP_0.5", "metrics/mAP_0.5:0.95",
    "val/box_loss", "val/obj_loss", "val/cls_loss", "lr",
]


def train(
    cfg="skyeye_s",
    data: str = "",
    hyp: Optional[str] = None,
    epochs: int = 100,
    batch_size: int = 16,
    img_size: int = 640,
    weights: str = "",
    resume: bool = False,
    adam: bool = False,
    linear_lr: bool = False,
    max_labels: int = 300,
    workers: int = 4,
    project: str = "runs/train",
    name: str = "exp",
    exist_ok: bool = False,
    patience: int = 30,
    seed: int = 0,
    save_period: int = -1,
    noval: bool = False,
    cache_images: bool = False,
    half: bool = False,
    spatial_shards: int = 1,
    device_aug: bool = False,
    accumulate: int = 0,
    autoanchor: bool = False,
    evolve: int = 0,
    debug_nans: bool = False,
    ref_exact_cross_attn: Optional[bool] = None,
    remat: str = "",
    fsdp: bool = False,
    packed_stem: bool = True,
    device="cuda",
):
    """JAX's ``train`` signature and defaults, plus ``device`` (CUDA unless the
    caller asks for the CPU). Returns (final_results, save_dir): the last
    epoch's (P, R, mAP@.5, mAP@.5:.95, val box, obj, cls).

    ``packed_stem`` is accepted and changes nothing: JAX's packed stem is a lane
    layout for the TPU, numerically the canonical stem with the same weights,
    and the port trains the canonical stem (ROADMAP Queue 1 item 9).

    With ``evolve`` it returns (None, ``<project>/evolve``)."""
    if evolve:  # short trainings, the fittest hyp kept (JAX's --evolve)
        from ..train.evolve import evolve as run_evolve

        evolve_dir = Path(project) / "evolve"
        kwargs = dict(
            cfg=cfg, data=data, epochs=epochs, batch_size=batch_size,
            img_size=img_size, weights=weights, adam=adam, linear_lr=linear_lr,
            max_labels=max_labels, workers=workers, project=project,
            patience=patience, seed=seed, cache_images=cache_images, half=half,
            spatial_shards=spatial_shards, device_aug=device_aug,
            accumulate=accumulate, packed_stem=packed_stem, device=device,
        )

        def short_train(cand_hyp):
            path = evolve_dir / "hyp_candidate.yaml"
            path.write_text(dump_flat_yaml(cand_hyp))
            res, _ = train(hyp=str(path), name="evolve_gen", exist_ok=True, **kwargs)
            return 0.1 * res[2] + 0.9 * res[3]

        evolve_dir.mkdir(parents=True, exist_ok=True)
        best = run_evolve(short_train, load_hyp(hyp), generations=evolve,
                          save_dir=evolve_dir, seed=seed)
        (evolve_dir / "hyp_evolved.yaml").write_text(dump_flat_yaml(best))
        return None, evolve_dir
    from ..parallel.fsdp import fsdp_with_spatial_not_ported
    from ..parallel.mesh import check_spatial_rows

    check_spatial_rows(img_size, spatial_shards)
    if not dist.is_initialized():
        from ..parallel.launch import launch, under_torchrun

        n_data = _data_axis(batch_size, device, spatial_shards)
        n_world = n_data * spatial_shards
        if fsdp and n_data > 1 and spatial_shards > 1:
            raise fsdp_with_spatial_not_ported()
        if n_world > 1 or under_torchrun():
            args = {k: v for k, v in locals().items() if k in _TRAIN_ARGS}
            on_cpu = torch.device(device).type == "cpu"
            shared = not on_cpu and n_world > torch.cuda.device_count()  # ranks share a card
            return launch(train, n_world, kwargs=args,
                          backend="gloo" if on_cpu or shared else None,
                          device="cpu" if on_cpu else None)[0]
    from ..data.dataset import create_dataloader
    from ..data.device_aug import augment_batch_device
    from ..data.prefetch import device_prefetch
    from ..models.detector import create_detector
    from .validate import validate

    from ..parallel import (
        create_mesh, is_main_process, jit_fsdp_step, local_batch_size, replicate_multihost,
        shard_train_state,
    )
    from ..parallel.collectives import broadcast_object
    from ..parallel.fsdp import full_tensors

    opt_dump = {k: v for k, v in locals().items() if isinstance(v, (int, float, str, bool))}
    main = is_main_process()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # a worker's own card
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = (create_mesh(n_spatial=spatial_shards, devices=[dev]) if dist.is_initialized()
            else None)
    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)  # the data axis
    if mesh is not None:
        local_batch_size(batch_size, mesh)  # JAX's error where the world does not divide
        if fsdp and world > 1 and mesh.n_spatial > 1:
            raise fsdp_with_spatial_not_ported()

    # -- run dir + config dump (rank 0 names it)
    save_dir = (increment_path(Path(project) / name, exist_ok=exist_ok or resume, mkdir=True)
                if main else None)
    save_dir = Path(broadcast_object(str(save_dir) if main else None))
    wdir = save_dir / "weights"
    hyp_dict = load_hyp(hyp)
    if main:
        wdir.mkdir(parents=True, exist_ok=True)
        (save_dir / "hyp.yaml").write_text(dump_flat_yaml(hyp_dict))
        (save_dir / "opt.yaml").write_text(dump_flat_yaml(opt_dump))
    print_args(opt_dump)
    if debug_nans:  # stop at the first NaN with a traceback of the forward that made it
        torch.autograd.set_detect_anomaly(True)

    init_seeds(seed)
    data_cfg = check_dataset(data)
    nc = data_cfg.nc

    # -- model (packed_stem: the canonical stem either way, see the module docstring)
    dtype = torch.bfloat16 if half else torch.float32
    config = load_model_config(cfg)
    if ref_exact_cross_attn is not None:
        config = dataclasses.replace(config, ref_exact_cross_attn=ref_exact_cross_attn)
    model = create_detector(config, num_classes=nc, dtype=dtype, device=dev, seed=seed,
                            remat=remat)
    config = model.config
    stride = int(max(config.strides))
    img_size = check_img_size(img_size, stride)

    if weights:
        if not str(weights).endswith((".pt", ".pth")):
            raise ValueError(f"{weights}: the port reads .pt weights (an orbax directory "
                             "needs orbax; export it with skyeye_tpu.cli.export)")
        state_in, _ = load_torch_checkpoint(weights)  # a port checkpoint: its EMA weights
        merged, n_l, n_t = merge_matching(model.state_dict(), state_in)
        model.load_state_dict(merged, strict=True)
        LOGGER.info("transferred %d/%d tensors from %s", n_l, n_t, weights)

    # -- data: the loader augments on the host, or with device_aug only letterboxes
    # and augmentation runs in the step
    train_loader, train_ds = create_dataloader(
        data_cfg.train, img_size=img_size, batch_size=batch_size, stride=stride,
        augment=not device_aug, hyp=hyp_dict, workers=workers, max_labels=max_labels,
        cache_images=cache_images, seed=seed, shuffle=True, rank=rank, world=world,
    )
    steps_per_epoch = len(train_loader)
    labels_to_class_weights(train_ds.labels, nc)

    if autoanchor:
        from ..utils.autoanchor import check_anchors, fit_anchors_for_dataset

        whs = [l[:, 3:5] * np.array(s_) * (img_size / max(s_))
               for l, s_ in zip(train_ds.labels, train_ds.shapes) if len(l)]
        if whs:
            bpr = check_anchors(np.concatenate(whs, 0), config.anchors, config.strides,
                                img_size)
            if bpr < 0.98:
                LOGGER.info("refitting anchors (best-possible recall %.3f < 0.98)", bpr)
                config = dataclasses.replace(
                    config, anchors=fit_anchors_for_dataset(train_ds, img_size, config.strides))
                model = create_detector(config, dtype=dtype, device=dev, seed=seed,
                                        remat=remat)
    LOGGER.info("train: %d images, %d steps/epoch", len(train_ds), steps_per_epoch)

    # -- optimizer + schedules, in optimizer steps
    accumulate = accumulate or accumulation_steps(batch_size)
    opt_steps_per_epoch = max(steps_per_epoch // accumulate, 1)
    warmup_steps = max(int(round(hyp_dict.get("warmup_epochs", 3.0) * steps_per_epoch)), 100)
    warmup_opt_steps = max(warmup_steps // accumulate, 1)
    lr_sched = host_schedule(hyp_dict, epochs, opt_steps_per_epoch, cos_lr=not linear_lr,
                             warmup_steps=warmup_opt_steps)
    tx = RuntimeOptimizer(model, hyp_dict, adam=adam, batch_size=batch_size,
                          accumulate=accumulate)
    # SKYEYE_DENSE_LOSS=1: the dense form of the loss, as in JAX
    loss_fn = ComputeLoss(config.anchors, nc, hyp=hyp_dict,
                          dense=bool(os.environ.get("SKYEYE_DENSE_LOSS")))
    state = create_train_state(model, tx)
    start_epoch, best_fit = 0, 0.0

    if resume:
        last = get_latest_run(project) or str(wdir / "last.pt")
        if Path(last).exists():
            ckpt = torch.load(last, map_location="cpu", weights_only=False)
            restore_train_state(state, ckpt)
            start_epoch = int(ckpt.get("epoch", -1)) + 1
            best_fit = float(ckpt.get("best_fitness", 0.0))
            # the loader's shuffles of the epochs already run, so the resumed epochs
            # see the batches an uninterrupted run sees (JAX's loader starts over)
            for _ in range(start_epoch):
                train_loader.rng.shuffle(np.arange(len(train_ds)))
            LOGGER.info("resumed from %s at epoch %d", last, start_epoch)

    if mesh is not None:  # every rank starts from rank 0's state (the same seed's)
        model.load_state_dict(replicate_multihost(mesh, model.state_dict()))
    aug_fn = (partial(augment_batch_device, hyp=hyp_dict,
                      use_mosaic=hyp_dict.get("mosaic", 1.0) > 0) if device_aug else None)
    step_fn = make_train_step(model, loss_fn, tx, device_augment=aug_fn, mesh=mesh)
    eval_model = copy.deepcopy(model).eval()  # validation loads the EMA weights into it
    if fsdp and mesh is not None and world > 1:
        # ZeRO-3: parameters, momenta and EMA sharded over the data axis
        shard_train_state(mesh, state)
        step_fn = jit_fsdp_step(step_fn, mesh, state)
        LOGGER.info("FSDP: training state sharded over the data axis (%d-way)", world)
    elif fsdp:
        LOGGER.info("FSDP: a data axis of 1 has nothing to shard; training unsharded")
    stopper = EarlyStopping(patience=patience)
    results_file = save_dir / "results.csv"
    if main and not results_file.exists():
        with open(results_file, "w", newline="") as f:
            csv.writer(f).writerow(RESULTS_HEADER)

    n_sp, sp_rank = (mesh.n_spatial, mesh.spatial_rank) if mesh is not None else (1, 0)
    if n_sp > 1 and packed_stem:
        LOGGER.info("packed-stem training disabled (untested with --spatial-shards), as in JAX")
    LOGGER.info("starting training for %d epochs (accumulate=%d, device=%s, data axis %d, "
                "spatial axis %d)", epochs, accumulate, dev, world, n_sp)
    final_results = (0, 0, 0, 0, 0, 0, 0)
    py_step = int(state.step)
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses = []
        for batch in device_prefetch(train_loader, size=2, device=dev,
                                     keys=("images", "targets", "mask")):
            if aug_fn is not None:
                batch["aug_generator"] = torch.Generator(device=dev).manual_seed(
                    seed * 1_000_003 + py_step)
            batch["opt_hyperparams"] = lr_sched(py_step // accumulate)
            batch["n_valid"] = int(batch.get("n_valid", batch["images"].shape[0]))
            if n_sp > 1:  # this rank's image rows of its data share's frames
                h = batch["images"].shape[1] // n_sp
                batch["images"] = batch["images"][:, sp_rank * h:(sp_rank + 1) * h]
            state, metrics = step_fn(state, batch)
            losses.append(torch.stack([metrics["box"], metrics["obj"], metrics["cls"]]))
            py_step += 1
        mloss = (torch.stack(losses).mean(0).cpu().numpy().astype(np.float64)
                 if losses else np.zeros(3))
        lr_now = lr_sched(py_step // accumulate)["lr"]
        LOGGER.info("epoch %d/%d: box %.4f obj %.4f cls %.4f (%.1fs, lr %.5f)",
                    epoch + 1, epochs, *mloss, time.time() - t0, lr_now)

        results = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        if not noval and data_cfg.val:
            weights_now = full_tensors(ema_weights(state.ema, state.model))  # every rank
            if main:
                results, _, _ = validate(
                    data_cfg, batch_size=batch_size, img_size=img_size,
                    model=(eval_model, weights_now), plots=False,
                    save_dir=save_dir, compute_loss=loss_fn, device=dev,
                )
            if mesh is not None:  # rank 0's figures, so every rank stops alike
                results = tuple(broadcast_object(tuple(float(r) for r in results)))
        fit = fitness({"map50": results[2], "map": results[3]})
        best_fit = max(best_fit, fit)
        final_results = results
        if main:
            with open(results_file, "a", newline="") as f:
                csv.writer(f).writerow([epoch, *mloss, *results[:4], *results[4:7], lr_now])

        # last every epoch (every save_period with noval, and the final one); best
        # by fitness
        ckpt_every = save_period if (noval and save_period > 0) else 1
        if epoch % ckpt_every == 0 or epoch == epochs - 1:
            save_train_checkpoint(wdir / "last.pt", state, epoch, best_fit, config)
            if fit >= best_fit and not noval:
                save_train_checkpoint(wdir / "best.pt", state, epoch, best_fit, config)
            if save_period > 0 and not noval and epoch % save_period == 0:
                save_train_checkpoint(wdir / f"epoch{epoch}.pt", state, epoch, best_fit, config)

        if stopper(epoch, fit):
            LOGGER.info("early stopping at epoch %d (no improvement for %d epochs)",
                        epoch + 1, patience)
            break

    if main:
        LOGGER.warning("results.png not drawn from %s: plot_results belongs to the "
                       "plotting slice (ROADMAP.md, Queue 1 item 15)", results_file)
    LOGGER.info("training complete; best fitness %.4f; weights in %s", best_fit, wdir)
    return final_results, save_dir


def _data_axis(batch_size: int, device, spatial_shards: int = 1) -> int:
    """JAX's data axis: the largest divisor of the batch that fits the visible
    cards over the spatial axis (1 on the CPU)."""
    n_dev = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    avail = max(n_dev // max(spatial_shards, 1), 1)
    return max(d for d in range(1, min(avail, batch_size) + 1) if batch_size % d == 0)


_TRAIN_ARGS = tuple(inspect.signature(train).parameters)


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="SkyEye training on PyTorch/CUDA")
    p.add_argument("--cfg", "--config", type=str, default="skyeye_s")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--hyp", type=str, default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", "--imgsz", type=int, default=640)
    p.add_argument("--weights", type=str, default="", help="initial weights (.pt)")
    p.add_argument("--resume", nargs="?", const=True, default=False)
    p.add_argument("--adam", action="store_true")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--project", default="runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-period", type=int, default=-1)
    p.add_argument("--noval", action="store_true")
    p.add_argument("--cache-images", action="store_true")
    p.add_argument("--half", action="store_true", help="bfloat16 activations")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="split each frame's rows over this many ranks (halo exchange)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters, momenta and EMA over the data axis (FSDP)")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop at the first NaN (torch.autograd.set_detect_anomaly)")
    p.add_argument("--evolve", type=int, nargs="?", const=10, default=0,
                   help="generations of hyperparameter evolution (short trainings)")
    p.add_argument("--autoanchor", action="store_true",
                   help="check and refit anchors to the dataset (kmeans)")
    p.add_argument("--accumulate", type=int, default=0,
                   help="gradient accumulation steps (0 = auto to nominal batch 64)")
    p.add_argument("--device-aug", action="store_true",
                   help="mosaic/HSV/affine augmentation on the card inside the step "
                        "(default: on the host, in the loader)")
    p.add_argument("--max-labels", type=int, default=300)
    p.add_argument("--no-packed-stem", dest="packed_stem", action="store_false",
                   help="accepted; the port trains the canonical stem either way")
    p.add_argument("--remat", nargs="?", const="stage", default="", choices=("block", "stage"),
                   help="recompute activations in the backward pass (training memory)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    import logging

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    opt = parse_opt(argv)
    return train(**vars(opt))


if __name__ == "__main__":
    main()
