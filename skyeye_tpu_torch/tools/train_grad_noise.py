"""How far a float32 train step's gradients are from float64's on the card, and
what SPP's pools and K4 add to that: the readings behind the gradient limits of
``chip_smoke.py``'s train phases.

    python3 -m skyeye_tpu_torch.tools.train_grad_noise [--batches 3]

Data: 32 seeded blocky 1080x1920 PNG frames with random labels (nc 10), read by
the train loader at 640 px, batch 16; batch ``s`` is the first batch of the
loader shuffled with seed ``s``, augmented on the card with DEFAULT_HYP from
``step_generator(s, 0)``.

skyeye_s (full width and depth, seeded weights, TF32 off): on each batch, one
train-mode forward and backward in float32 and in float64, gradient by
gradient (``max|g32 - g64| / max|g64|``: the worst five and the median), once
with SPP's train path as it ships (JAX's shift-max chains, which split the
gradient of tied maxima) and once with ``max_pool2d`` put in (one winner).
Beside them, SPP's windows at the float32 input: how many have a tied maximum,
and how many have another winner in float64. Then SPP's train forward and
backward at that input, timed with each pool.

skyeye_l_transformer (full width and depth, seeded weights, the same batches
without augmentation): the gradients with K4 against the same model with
``attention_reference`` put in (the limit of ``train_transformer``), and each
of the two against the model in float64 (its attention on the float64
einsums).

Prints one JSON line per reading and, last, the card's name and power limit.
Exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

NC, IMG, BATCH, FRAMES = 10, 640, 16, 32


def grad_errors(named_got, named_want):
    """Per parameter: max|got - want| / max|want| (0 where both are 0)."""
    out = {}
    for k, want in named_want.items():
        got, scale = named_got[k], float(want.abs().max())
        err = float((got.double() - want.double()).abs().max())
        out[k] = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
    return out


def error_summary(errs, n=5):
    """The n largest errors by name, and the median over all."""
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:n]
    return {"worst": worst, "median": float(np.median(list(errs.values())))}


def flat_targets(targets):
    """(B, M, 6) -> (B M, 6) with the image index in column 0, as the train
    step fills it."""
    B, M = targets.shape[:2]
    flat = targets.reshape(B * M, 6).clone()
    flat[:, 0] = torch.arange(B, dtype=flat.dtype, device=flat.device).repeat_interleave(M)
    return flat


def loss_and_grads(model, loss_fn, images_nhwc, targets, mask):
    """One train-mode forward and backward, dropout drawn from one fixed
    generator: (loss, aux, {name: grad})."""
    from ..train import set_dropout_generator, step_generator

    flat = flat_targets(targets)
    model.train()
    set_dropout_generator(model, step_generator(0, 0, images_nhwc.device))
    for p in model.parameters():
        p.grad = None
    outs = model(images_nhwc.permute(0, 3, 1, 2))
    loss, aux = loss_fn(outs, flat, mask.reshape(-1))
    loss.backward()
    set_dropout_generator(model, None)
    return float(loss.detach()), aux.tolist(), {k: p.grad.detach().clone()
                                                for k, p in model.named_parameters()}


def write_frames(root: Path) -> None:
    from ..data.imageio import imwrite_png

    (root / "images" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    rng = np.random.RandomState(7)
    for i in range(FRAMES):
        coarse = rng.randint(0, 256, (1080 // 32 + 1, 1920 // 32 + 1, 3), dtype=np.uint8)
        imwrite_png(root / "images" / "train" / f"f{i:02d}.png",
                    np.ascontiguousarray(coarse.repeat(32, 0).repeat(32, 1)[:1080, :1920]))
        lines = [f"{rng.randint(NC)} {rng.uniform(0.2, 0.8):.6f} {rng.uniform(0.2, 0.8):.6f} "
                 f"{rng.uniform(0.02, 0.2):.6f} {rng.uniform(0.02, 0.2):.6f}"
                 for _ in range(rng.randint(2, 9))]
        (root / "labels" / "train" / f"f{i:02d}.txt").write_text("\n".join(lines) + "\n")


def first_batch(root: Path, seed: int):
    from ..data.dataset import create_dataloader

    loader, _ = create_dataloader(root / "images" / "train", img_size=IMG, batch_size=BATCH,
                                  stride=32, augment=False, workers=4, seed=seed, shuffle=True)
    b = next(iter(loader))
    return {k: torch.from_numpy(np.asarray(b[k])).cuda() for k in ("images", "targets", "mask")}


def plain_pool(x, k):
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


def pool_patch(pool: str):
    """SPP's train pools as shipped ("shiftmax"), or ``max_pool2d`` put in."""
    from ..models import blocks

    if pool == "max_pool2d":
        return mock.patch.object(blocks, "maxpool_same_shiftmax", plain_pool)
    return contextlib.nullcontext()


def window_stats(x32, x64, kernel_sizes):
    """Per SPP kernel: windows whose float32 maximum is tied, and windows whose
    winner (first index of the maximum) differs between float32 and float64."""
    out = {}
    for k in kernel_sizes:
        ties = flips = 0
        for c0 in range(0, x32.shape[1], 64):  # 64 channels at a time
            w32 = F.unfold(F.pad(x32[:, c0:c0 + 64], (k // 2,) * 4, value=float("-inf")), k)
            w64 = F.unfold(F.pad(x64[:, c0:c0 + 64], (k // 2,) * 4, value=float("-inf")), k)
            b, _, n = w32.shape
            w32, w64 = w32.view(b, -1, k * k, n), w64.view(b, -1, k * k, n)
            m32 = w32.amax(2, keepdim=True)
            ties += int(((w32 == m32).sum(2) > 1).sum())
            flips += int((w32.argmax(2) != w64.argmax(2)).sum())
        out[k] = {"windows": int(x32.numel()), "tied": ties, "winner_differs": flips}
    return out


def cuda_ms(fn, runs=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def skyeye_s_readings(batches):
    from ..config import DEFAULT_HYP
    from ..data.device_aug import augment_batch_device
    from ..losses import ComputeLoss
    from ..models import blocks
    from ..models.detector import SkyEyeDetectorModule, create_detector
    from ..train import step_generator

    m32 = create_detector("skyeye_s", num_classes=NC, device="cuda", seed=0)
    m64 = SkyEyeDetectorModule(m32.config, dtype=torch.float64)
    m64.load_state_dict(m32.state_dict(), strict=True)
    m64 = m64.double().cuda()
    init = {k: v.clone() for k, v in m32.state_dict().items()}
    loss_fn = ComputeLoss(m32.config.anchors, NC)
    spp_in = {}

    def keep(name):
        def hook(module, args, out):
            spp_in[name] = out.detach()
        return hook

    for seed, batch in batches:
        images, t, m = augment_batch_device(batch["images"].float() / 255.0, batch["targets"],
                                            batch["mask"], step_generator(seed, 0, "cuda"),
                                            hyp=DEFAULT_HYP)
        row = {"model": "skyeye_s", "batch_seed": seed}
        for pool in ("shiftmax", "max_pool2d"):
            with pool_patch(pool):
                for model in (m32, m64):
                    model.load_state_dict(init, strict=True)  # train mode moves BN's stats
                h32 = m32.backbone.spp4.cv1.register_forward_hook(keep("f32"))
                h64 = m64.backbone.spp4.cv1.register_forward_hook(keep("f64"))
                l32, _, g32 = loss_and_grads(m32, loss_fn, images, t, m)
                l64, _, g64 = loss_and_grads(m64, loss_fn, images.double(), t, m)
                h32.remove()
                h64.remove()
            row[pool] = {"loss": [l32, l64], "loss_rel": abs(l32 - l64) / abs(l64),
                         **error_summary(grad_errors(g32, g64))}
            del g32, g64
        row["spp_windows"] = window_stats(spp_in["f32"], spp_in["f64"],
                                          m32.backbone.spp4.kernel_sizes)
        print(json.dumps(row), flush=True)

    # SPP's train forward and backward at the last batch's input, each pool
    spp = m32.backbone.spp4.train()
    x = spp_in["f32"].clone()
    timed = {}
    for pool in ("shiftmax", "max_pool2d"):
        pools_in = x.clone().requires_grad_(True)

        def fwd_bwd():
            outs = [pools_in]
            prev = 1
            for k in spp.kernel_sizes:  # SPPBlock.forward's pools, without its convs
                grow = k - prev + 1
                outs.append(blocks.maxpool_same_shiftmax(outs[-1], grow) if grow >= 2 and prev > 1
                            else blocks.maxpool_same_shiftmax(pools_in, k))
                prev = k
            torch.cat(outs, 1).sum().backward()

        with pool_patch(pool):
            timed[pool] = cuda_ms(fwd_bwd)
    print(json.dumps({"spp_pools_forward_backward_ms": timed, "input": list(x.shape)}),
          flush=True)
    del m32, m64


def transformer_readings(batches):
    from ..losses import ComputeLoss
    from ..models import attention as port_attention
    from ..models.detector import SkyEyeDetectorModule, create_detector
    from ..ops import attention_kernel

    model = create_detector("skyeye_l_transformer", num_classes=NC, device="cuda", seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    m64 = SkyEyeDetectorModule(model.config, dtype=torch.float64)
    m64.load_state_dict(init, strict=True)
    m64 = m64.double().cuda()
    loss_fn = ComputeLoss(model.config.anchors, NC)
    for seed, batch in batches:
        x = batch["images"].float() / 255.0
        args = (batch["targets"], batch["mask"])
        model.load_state_dict(init, strict=True)
        l_k4, _, g_k4 = loss_and_grads(model, loss_fn, x, *args)
        model.load_state_dict(init, strict=True)
        with mock.patch.object(port_attention, "flash_attention",
                               attention_kernel.attention_reference):
            l_ref, _, g_ref = loss_and_grads(model, loss_fn, x, *args)
        m64.load_state_dict(init, strict=True)
        with mock.patch.object(port_attention, "FLASH_MIN_TOKENS", 1 << 30):  # the einsums
            l64, _, g64 = loss_and_grads(m64, loss_fn, x.double(), *args)
        print(json.dumps({
            "model": "skyeye_l_transformer", "batch_seed": seed,
            "loss": {"k4": l_k4, "reference": l_ref, "float64": l64},
            "k4_vs_reference": error_summary(grad_errors(g_k4, g_ref)),
            "k4_vs_float64": error_summary(grad_errors(g_k4, g64)),
            "reference_vs_float64": error_summary(grad_errors(g_ref, g64))}), flush=True)
        del g_k4, g_ref, g64


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_grad_noise: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="skyeye_grad_noise_") as tmp:
        root = Path(tmp)
        write_frames(root)
        batches = [(s, first_batch(root, s)) for s in range(args.batches)]
    skyeye_s_readings(batches)
    torch.cuda.empty_cache()
    transformer_readings(batches)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
