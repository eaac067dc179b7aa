"""K4's score-product precision, the compile-time choice of ``csrc/attention.cu``,
measured on the card.

    python3 -m skyeye_tpu_torch.tools.attention_precision [--seeds 16]

Builds the attention kernel twice: as shipped (``kScoreOnTensorCores``: q k^T in
3xTF32) and with ``-DSKYEYE_SCORE_FP32`` (q k^T on float32 FMAs; P V is 3xTF32
in both). Holds each build against ``attention_reference`` (float32 einsums,
TF32 off) at the tolerances of ``chip_smoke.py``, and measures how far each
build and that float32 reference are from the same einsums in float64, on:
``--seeds`` draws of the large-logit case (1, 128, 64), q and k of sigma 30, at
rtol 1e-3 / atol 1e-4; a seeded draw at the serving shape (64, 1600, 256) at
rtol 2e-4 / atol 2e-5; and the q, k and v that skyeye_l_transformer hands K4
when it serves 16 seeded 1080x1920 frames at 1280 px (the frames of
``chip_smoke.py``). Then it times both builds and
``scaled_dot_product_attention`` (a yardstick only) at the serving shape with
CUDA events. Prints one JSON line per case and, last, a summary with the card's
name and power limit. Exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import attention_kernel

BUILDS = {"3xtf32": (), "fp32_fma": ("-DSKYEYE_SCORE_FP32",)}


def _excess(got, ref, rtol, atol) -> float:
    """max(|got - ref| - (atol + rtol |ref|)): <= 0 when every element is within."""
    return float(((got - ref).abs() - (atol + rtol * ref.abs())).max())


def _ms(fn, runs: int = 10) -> float:
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


def compare(case: str, q, k, v, rtol: float, atol: float) -> dict:
    """Each build against the float32 reference (excess over the tolerance) and
    against float64 (max abs error), and the float32 reference against float64."""
    ref = attention_kernel.attention_reference(q, k, v)
    ref64 = attention_kernel.attention_reference(q.double(), k.double(), v.double())
    row = {"case": case, "shape": list(q.shape),
           "reference_f32_err_vs_f64": float((ref.double() - ref64).abs().max())}
    for name, flags in BUILDS.items():
        got = attention_kernel.run_kernel(q, k, v, flags)
        row[f"{name}_excess"] = _excess(got, ref, rtol, atol)
        row[f"{name}_err_vs_f64"] = float((got.double() - ref64).abs().max())
        row[f"{name}_excess_vs_f64"] = _excess(got.double(), ref64, rtol, atol)
    return row


def served_qkv():
    """The q, k, v skyeye_l_transformer hands K4 on one request of 16 frames."""
    from .. import SkyEyeDetector
    from ..models import attention as port_attention

    det = SkyEyeDetector("skyeye_l_transformer", img_size=1280, device="cuda", seed=0)
    rng = np.random.RandomState(1)
    coarse = rng.randint(0, 256, (16, 34, 60, 3), dtype=np.uint8)
    batch = list(np.ascontiguousarray(coarse.repeat(32, axis=1).repeat(32, axis=2)[:, :1080]))
    captured = []
    real = port_attention.flash_attention

    def record(q, k, v):
        captured[:] = [(q, k, v)]
        return real(q, k, v)

    with mock.patch.object(port_attention, "flash_attention", record):
        det(batch)
    del det
    return captured[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_precision: CUDA is not available", file=sys.stderr)
        return 1
    summary = {name: {"passed": 0, "passed_vs_f64": 0, "worst_err_vs_f64": 0.0}
               for name in BUILDS}
    summary["reference_f32"] = {"worst_err_vs_f64": 0.0}
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
        q, k = (torch.randn((1, 128, 64), generator=gen, device="cuda") * 30 for _ in range(2))
        v = torch.randn((1, 128, 64), generator=gen, device="cuda")
        row = compare("large_logits_b1_n128_hd64", q, k, v, 1e-3, 1e-4)
        row["seed"] = 1000 + seed
        for name in BUILDS:
            summary[name]["passed"] += row[f"{name}_excess"] <= 0
            summary[name]["passed_vs_f64"] += row[f"{name}_excess_vs_f64"] <= 0
            summary[name]["worst_err_vs_f64"] = max(summary[name]["worst_err_vs_f64"],
                                                    row[f"{name}_err_vs_f64"])
        summary["reference_f32"]["worst_err_vs_f64"] = max(
            summary["reference_f32"]["worst_err_vs_f64"], row["reference_f32_err_vs_f64"])
        print(json.dumps(row), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((64, 1600, 256), generator=gen, device="cuda") for _ in range(3))
    serving = compare("serving_b64_n1600_hd256", q, k, v, 2e-4, 2e-5)
    for name, flags in BUILDS.items():
        serving[f"{name}_ms"] = _ms(lambda: attention_kernel.run_kernel(q, k, v, flags))
    serving["sdpa_ms"] = _ms(lambda: F.scaled_dot_product_attention(q, k, v))
    print(json.dumps(serving), flush=True)
    del q, k, v
    print(json.dumps(compare("served_skyeye_l_transformer", *served_qkv(), 2e-4, 2e-5)),
          flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"large_logit_seeds": args.seeds, "summary": summary, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
