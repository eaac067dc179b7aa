"""Peak memory and time of one train micro-step at each ``remat`` level.

    python3 -m skyeye_tpu_torch.tools.remat_memory [--cfg skyeye_l_transformer]
        [--img-size 1280] [--batch 16] [--levels none,block,stage]

For each level (``none`` is remat off): the model at full width and depth with
seeded weights (nc 10, float32, TF32 off) on the card, a batch of seeded
uint8 noise frames with 4 boxes each, and train-mode forward and backward
micro-steps (dropout from one fixed generator). Reports the first step's peak
allocated memory (``torch.cuda.max_memory_allocated``, reset before it) and
the median ms of three more steps (CUDA events), or, where the step does not
fit on the card, the allocator's out-of-memory message. This is how one reads
whether a size fits without remat, a reading, so it catches that error; the
smoke does not.

Prints one JSON line per level and, last, the card's name and power limit.
Exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

NC = 10


def batch(img: int, b: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8))
    targets = np.zeros((b, 8, 6), np.float32)
    mask = np.zeros((b, 8), bool)
    targets[:, :4, 1] = rng.integers(0, NC, (b, 4))
    targets[:, :4, 2:4] = rng.uniform(0.2, 0.8, (b, 4, 2))
    targets[:, :4, 4:6] = rng.uniform(0.02, 0.3, (b, 4, 2))
    mask[:, :4] = True
    return images.cuda(), torch.from_numpy(targets).cuda(), torch.from_numpy(mask).cuda()


def micro_step_reading(cfg: str, level: str, images, targets, mask) -> dict:
    from ..losses import ComputeLoss
    from ..models.detector import create_detector
    from .train_grad_noise import loss_and_grads

    model = create_detector(cfg, num_classes=NC, device="cuda", seed=0, remat=level)
    loss_fn = ComputeLoss(model.config.anchors, model.config.nc)
    x = images.float() / 255.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        loss, _, _ = loss_and_grads(model, loss_fn, x, targets, mask)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        times = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            loss_and_grads(model, loss_fn, x, targets, mask)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    except torch.cuda.OutOfMemoryError as e:
        return {"fits": False, "error": str(e).splitlines()[0]}
    finally:
        del model
        torch.cuda.empty_cache()
    return {"fits": True, "loss": loss, "peak_memory_gib": peak / 2 ** 30,
            "memory_before_gib": base / 2 ** 30, "ms": float(np.median(times))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default="skyeye_l_transformer")
    p.add_argument("--img-size", type=int, default=1280)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--levels", default="none,block,stage")
    opt = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("remat_memory: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, targets, mask = batch(opt.img_size, opt.batch)
    for level in opt.levels.split(","):
        reading = micro_step_reading(opt.cfg, "" if level == "none" else level,
                                     images, targets, mask)
        print(json.dumps({"cfg": opt.cfg, "img_size": opt.img_size, "batch": opt.batch,
                          "remat": level, **reading}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
