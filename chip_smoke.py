#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``skyeye_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; a failed phase raises and the script exits non-zero:

  device   the card, its power limit, and the torch/CUDA versions; no CUDA -> exit 1
  build    nvcc builds the NMS kernels (csrc/nms.cu) into a plain-C library
  kernels  K1 (batched greedy NMS) and K2 (single-image greedy NMS) against their
           plain PyTorch versions on the card, index for index, on seeded inputs
  serve    SkyEyeDetector("skyeye_s") at full width, seeded weights, float32 with
           TF32 off, serves 3 requests of 16 uint8 1080x1920 frames at 1280 px
           (conf 0.25, 0.001, 0.001; K1's launches counted over just these),
           then the per-image functional path (decode -> nms_single on each
           image; K2's launches counted over just that); every result is held
           against the same detector with the plain NMS put in, the kernels are
           timed on the inputs the serving path gave K1, and one request is
           split into its stages by the detector's ``on_stage`` hook

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power-limit line,
and, last, ``{"ok": true, "device": {...}}``. A watchdog ends a hung run with a
traceback and a non-zero exit. Imports torch, numpy and the port only.
"""
from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

WATCHDOG_S = 900
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# Operations per candidate and greedy step: the argmax compare, the IoU against
# the winner (2 min, 2 max, 2 sub, 2 clamp, 1 mul, 2 add, 1 sub, 1 div) and
# the suppression compare and select.
OPS_PER_CANDIDATE_STEP = 17

NMS_SOURCE = "skyeye_tpu_torch/csrc/nms.cu"
KERNELS = {  # wrapper -> the TPU kernel it replaces: K1, K2
    "batched_greedy_nms": "skyeye_tpu/ops/pallas/nms_kernel.py:220",
    "greedy_nms": "skyeye_tpu/ops/pallas/nms_kernel.py:105",
}
NOT_PORTED = [  # the repo's other TPU kernels, still to port (ROADMAP.md Queue 2)
    {"id": "K3", "fn": "skyeye_tpu/ops/pallas/csp_kernel.py:198 csp_fused_v2", "status": "to port"},
    {"id": "K3b", "fn": "skyeye_tpu/ops/pallas/csp_kernel.py:275 csp_fused", "status": "to port"},
    {"id": "K4", "fn": "skyeye_tpu/ops/pallas/attention_kernel.py:74 flash_attention",
     "status": "to port"},
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def candidates(rng, b, k, n_cls=80, invalid_frac=0.3):
    """Class-offset candidate sets shaped like the cut's output: clustered boxes
    so suppression happens, scores in (0, 1) with a share of invalid slots."""
    centers = np.round(rng.uniform(0, 1280, (b, k, 2)) / 64) * 64 + rng.normal(0, 8, (b, k, 2))
    wh = rng.uniform(16, 160, (b, k, 2))
    cls = rng.randint(0, n_cls, (b, k))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1) + (cls * 7680.0)[..., None]
    scores = rng.uniform(0.001, 1.0, (b, k))
    scores[rng.uniform(size=(b, k)) < invalid_frac] = -1.0
    return boxes.astype(np.float32), scores.astype(np.float32)


def special_candidates(rng):
    """An all-invalid row, identical boxes, tied scores, and a fully tied row."""
    boxes, scores = candidates(rng, 5, 200, n_cls=4)
    scores[1] = -1.0
    boxes[2, :50] = boxes[2, 0]
    scores[3, :60] = np.float32(0.5)
    boxes[3, 30:60] = boxes[3, :30]
    scores[4] = np.float32(0.7)
    return boxes, scores


def cuda_ms(fn, runs: int) -> float:
    """Median milliseconds of fn() over runs, each timed with CUDA events."""
    import torch

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


def nms_bound(boxes, scores, keep_valid, max_det: int):
    """Least time for this work: inputs read once and outputs written once over the
    memory rate, against the greedy steps these inputs need over the float32 rate."""
    k = scores.shape[-1]
    kept = keep_valid.reshape(-1, max_det).sum(dim=1).cpu().numpy()
    steps = np.minimum(kept + 1, max_det)  # the kept winners, then the step that finds none
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + keep_valid.numel() * (4 + 1)
    ops = float(steps.sum()) * k * OPS_PER_CANDIDATE_STEP
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, nms_kernel):
    """K1 and K2 against their plain versions on the card, index for index."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    cases = []
    for k in (1024, 4096):
        boxes, scores = candidates(rng, 16, k)
        for iou in (0.45, 0.7):
            cases.append((f"b16_k{k}_iou{iou}", boxes, scores, iou, 300))
    boxes, scores = candidates(rng, 3, 1000)
    cases.append(("ragged_b3_k1000", boxes, scores, 0.45, 300))
    boxes, scores = special_candidates(rng)
    cases.append(("special_b5_k200", boxes, scores, 0.5, 64))

    checked = []
    for name, boxes, scores, iou, md in cases:
        tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
        idx, valid = nms_kernel.batched_greedy_nms(tb, ts, iou, md)
        ref_idx, ref_valid = nms_kernel.batched_greedy_nms_plain(tb, ts, iou, md)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_idx) and torch.equal(valid, ref_valid)):
            bad = int((idx != ref_idx).sum() + (valid != ref_valid).sum())
            fail(f"K1 disagrees with its plain version on {name}: {bad} slots")
        rows_ok = 0
        for r in range(tb.shape[0]):
            idx1, valid1 = nms_kernel.greedy_nms(tb[r].contiguous(), ts[r].contiguous(), iou, md)
            if not (torch.equal(idx1, ref_idx[r]) and torch.equal(valid1, ref_valid[r])):
                fail(f"K2 disagrees with its plain version on {name}, row {r}")
            rows_ok += 1
        checked.append({"case": name, "B": int(tb.shape[0]), "k": int(tb.shape[1]), "iou": iou,
                        "max_det": md, "kept": valid.sum(dim=1).tolist(), "k2_rows": rows_ok})
    times = {}
    for name, boxes, scores, iou, md in cases[:4:2]:  # b16, k 1024 and 4096, iou 0.45
        tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
        times[name] = {
            "K1_ms": cuda_ms(lambda: nms_kernel.batched_greedy_nms(tb, ts, iou, md), 30),
            "K1_plain_ms": cuda_ms(lambda: nms_kernel.batched_greedy_nms_plain(tb, ts, iou, md), 20),
            "K2_ms": cuda_ms(lambda: nms_kernel.greedy_nms(tb[0], ts[0], iou, md), 30),
        }
    emit("kernels", index_exact=True, cases=checked, median_ms_generated_inputs=times,
         kernels=[{"id": "K1", "fn": KERNELS["batched_greedy_nms"], "status": "ported",
                   "source": NMS_SOURCE},
                  {"id": "K2", "fn": KERNELS["greedy_nms"], "status": "ported",
                   "source": NMS_SOURCE}] + NOT_PORTED)


def frames(seed: int, n: int = 16):
    """Blocky seeded uint8 BGR frames, 1080x1920: structure at many scales."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (n, 34, 60, 3), dtype=np.uint8)
    fine = coarse.repeat(32, axis=1).repeat(32, axis=2)[:, :1080]
    return [np.ascontiguousarray(f) for f in fine]


def check_detections(results, shape, nc):
    for d in results.xyxy:
        if d.ndim != 2 or d.shape[1] != 6 or not np.isfinite(d).all():
            fail(f"malformed detections {d.shape}")
        if len(d) and (d[:, [0, 2]].min() < 0 or d[:, [0, 2]].max() > shape[1]
                       or d[:, [1, 3]].min() < 0 or d[:, [1, 3]].max() > shape[0]
                       or d[:, 4].min() <= 0 or d[:, 4].max() > 1
                       or d[:, 5].min() < 0 or d[:, 5].max() >= nc):
            fail("detections outside the frame, the score range or the class range")


def stage_ms(torch, det, batch, conf: float):
    """One request through ``SkyEyeDetector.__call__`` split into its stages by the
    detector's ``on_stage`` hook, host clock with a synchronize at each stage
    (milliseconds); the second of two passes, so nothing is cold."""
    det.conf_thres = conf
    for _ in range(2):
        t, marks = time.perf_counter(), {}

        def mark(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            marks[name] = marks.get(name, 0.0) + (now - t) * 1e3
            t = now

        det.on_stage = mark
        t0 = time.perf_counter()
        det(batch)
        marks["request"] = (time.perf_counter() - t0) * 1e3
        det.on_stage = None
    return marks


def phase_serve(torch, gpu_line):
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.models.head import decode_predictions
    from skyeye_tpu_torch.ops import nms as port_nms
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.ops.letterbox import letterbox_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the reruns below see the same candidates
    torch.backends.cudnn.benchmark = False

    det = SkyEyeDetector("skyeye_s", img_size=1280, device="cuda", seed=0)
    batch = frames(seed=1)
    requests = [0.25, 0.001, 0.001]
    det(batch)  # warm-up: cuDNN handles and workspaces
    torch.cuda.synchronize()

    # -- the serving path, nothing patched: counts from 0 just before, read just after
    nms_kernel.reset_launch_counts()
    served, ms = [], []
    for conf in requests:
        det.conf_thres = conf
        t0 = time.perf_counter()
        served.append(det(batch))
        ms.append((time.perf_counter() - t0) * 1e3)
    serve_launches = dict(nms_kernel.LAUNCHES)
    # ---------------------------------------------------------------------------

    if serve_launches["batched_greedy_nms"] == 0:
        fail("the serving path never launched batched_greedy_nms")
    for r in served:
        check_detections(r, batch[0].shape[:2], det.config.nc)

    # -- what the serving path hands K1, from an untimed rerun of the same requests
    real_batched = port_nms.greedy_nms_batched
    captured = {}  # conf -> (offset boxes, scores, iou, max_det)

    def recording(offset_boxes, scores, iou_thres, max_det):
        captured[det.conf_thres] = (offset_boxes.contiguous(), scores.contiguous(),
                                    iou_thres, max_det)
        return real_batched(offset_boxes, scores, iou_thres, max_det)

    with mock.patch.object(port_nms, "greedy_nms_batched", recording):
        for conf in sorted(set(requests)):
            det.conf_thres = conf
            det(batch)
    cands = [(captured[c][1] > 0).sum(dim=1).tolist() for c in requests]
    if sum(sum(c) for c in cands) == 0:
        fail("no candidate reached K1")

    # -- the per-image functional path: decode, then nms_single on each image ---
    with torch.inference_mode():
        x = torch.from_numpy(np.stack([f[:, :, ::-1] for f in batch])).cuda()
        x = letterbox_batch(x, (1280, 1280)) / 255.0
        dec = decode_predictions(det.model(x.permute(0, 3, 1, 2)), det.config.anchors,
                                 (1280, 1280), anchor_major=False)
        torch.cuda.synchronize()
        nms_kernel.reset_launch_counts()
        singles = [port_nms.nms_single(dec[i], conf_thres=0.001, max_nms=4096)
                   for i in range(len(dec))]
        torch.cuda.synchronize()
        per_image_launches = dict(nms_kernel.LAUNCHES)
        # ---------------------------------------------------------------------
        batched = port_nms.nms_batched(dec, conf_thres=0.001, max_nms=4096)
    if per_image_launches["greedy_nms"] == 0:
        fail("the per-image path never launched greedy_nms")
    for i, (d1, n1) in enumerate(singles):
        if int(n1) != int(batched[1][i]) or not torch.equal(d1, batched[0][i]):
            fail(f"nms_single (K2) and nms_batched (K1) disagree on image {i}")

    # -- the same detector with the plain NMS put in ----------------------------
    def plain(offset_boxes, scores, iou_thres, max_det):
        return nms_kernel.batched_greedy_nms_plain(offset_boxes, scores, iou_thres, max_det)

    max_box_err = max_score_err = 0.0
    with mock.patch.object(port_nms, "greedy_nms_batched", plain):
        for conf, got in zip(requests, served):
            det.conf_thres = conf
            want = det(batch)
            for g, w in zip(got.xyxy, want.xyxy):
                if g.shape != w.shape or not np.array_equal(g[:, 5], w[:, 5]):
                    fail(f"counts or classes differ from the plain NMS at conf {conf}")
                if len(g):
                    max_box_err = max(max_box_err, float(np.abs(g[:, :4] - w[:, :4]).max()))
                    max_score_err = max(max_score_err, float(np.abs(g[:, 4] - w[:, 4]).max()))
    if max_box_err > 1e-3 or max_score_err > 1e-5:
        fail(f"boxes {max_box_err} px / scores {max_score_err} beyond 1e-3 px / 1e-5")

    # -- the kernels timed on the inputs the serving path gave K1 at k = 4096 ----
    boxes, scores, iou, md = captured[0.001]
    k1_idx, k1_valid = nms_kernel.batched_greedy_nms(boxes, scores, iou, md)
    p_idx, p_valid = nms_kernel.batched_greedy_nms_plain(boxes, scores, iou, md)
    k2_idx, k2_valid = nms_kernel.greedy_nms(boxes[0], scores[0], iou, md)
    k1_err = int((k1_idx - p_idx).abs().max()) + int((k1_valid != p_valid).sum())
    k2_err = int((k2_idx - p_idx[0]).abs().max()) + int((k2_valid != p_valid[0]).sum())
    k1_bound, k1_by = nms_bound(boxes, scores, k1_valid, md)
    k2_bound, k2_by = nms_bound(boxes[0], scores[0], k2_valid, md)
    summary = [
        dict(name="batched_greedy_nms", path="serve",
             launches=serve_launches["batched_greedy_nms"], max_abs_err=k1_err,
             ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou, md), 30),
             plain_ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms_plain(
                 boxes, scores, iou, md), 20),
             bound_ms=k1_bound, bound_by=k1_by, shape=list(scores.shape)),
        dict(name="greedy_nms", path="per_image", launches=per_image_launches["greedy_nms"],
             max_abs_err=k2_err,
             ms=cuda_ms(lambda: nms_kernel.greedy_nms(boxes[0], scores[0], iou, md), 30),
             plain_ms=cuda_ms(lambda: nms_kernel.greedy_nms_plain(
                 boxes[0], scores[0], iou, md), 20),
             bound_ms=k2_bound, bound_by=k2_by, shape=list(scores[0].shape)),
    ]
    for s in summary:
        if s["max_abs_err"] != 0:
            fail(f"{s['name']} disagrees with its plain version on the main path's inputs")
        s.update(route="cuda", source=NMS_SOURCE, replaces=KERNELS[s["name"]],
                 library_ms=None)  # no core PyTorch call computes greedy NMS

    emit("serve", model="skyeye_s", img_size=1280, batch=len(batch), frame=[1080, 1920],
         dtype="float32", tf32=False, conf=requests, ms_per_request=ms,
         images_per_s=[len(batch) / (t / 1e3) for t in ms],
         candidates_per_image=cands,
         detections_per_image=[[len(d) for d in r.xyxy] for r in served],
         launches={"serve": serve_launches, "per_image": per_image_launches},
         launches_per_request={n: c / len(requests) for n, c in serve_launches.items()},
         plain_nms_max_box_err_px=max_box_err,
         plain_nms_max_score_err=max_score_err, card=gpu_line,
         kept_on_timed_input=k1_valid.sum(dim=1).tolist(),
         stage_ms={str(c): stage_ms(torch, det, batch, c) for c in (0.25, 0.001)})
    return summary


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    from skyeye_tpu_torch.ops import nms_kernel  # fails where the port is absent

    gpu_line = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=gpu_line, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = nms_kernel.nms_library()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=built.seconds,
         library=built.path.name,
         ptxas=[ln.strip() for ln in built.ptxas.splitlines()
                if "registers" in ln or "spill" in ln])

    phase_kernels(torch, nms_kernel)
    summary = phase_serve(torch, gpu_line)

    keys = ("name", "route", "source", "replaces", "path", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: s[k] for k in keys} for s in summary]}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
