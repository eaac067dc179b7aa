#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``skyeye_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; a failed phase raises and the script exits non-zero:

  device   the card, its power limit, and the torch/CUDA versions; no CUDA -> exit 1
  build    nvcc builds the three kernel libraries (csrc/nms.cu, attention.cu,
           csp.cu), the host PNG unfilter (csrc/png_unfilter.cu) and the host
           JPEG codec (csrc/jpeg.cu) in parallel, each into a plain-C library
  kernels  K1 (batched greedy NMS) and K2 (single-image greedy NMS) against their
           plain PyTorch versions on the card, index for index, on seeded inputs
           from k 200 to 8192 and on a case of NaN scores and coordinates, +inf
           and signed-zero scores; K1 at 70000 images and at max_det 16384;
           each of the three stages (order, mask, walk)
           against its plain stage on the same input, exactly; K1, K2 and each
           stage timed per call (CUDA events around the call, the host's launch
           work included) and on the device alone (``graph_ms``)
  kernels_attention_csp
           K4 (fused attention) against ``attention_reference`` at the serving
           shape (64, 1600, 256), at ragged shapes down to one token and a
           large-logit case; K4's gradients through its autograd Function
           against ``attention_reference``'s autograd at (8, 400, 64) and the
           serving shape, and a train-mode MultiHeadSelfAttention's output and
           qkv and proj gradients against the same module on
           ``attention_reference``; heads of 320 (the einsum path, by the gate);
           K3 (fused CSP) against ``csp_fused_plain`` at csp1's serving shape
           (16, 320, 320, 64), nb 1, at nb 3 with ragged tiles, at 12 channels,
           and at csp1 of skyeye_m (C 96, nb 2) and of skyeye_l (C 128, nb 3),
           whose packed weights the kernel reads from device memory, each timed
  serve    SkyEyeDetector("skyeye_s") at full width, seeded weights, float32 with
           TF32 off, serves 3 requests of 16 uint8 1080x1920 frames at 1280 px
           (conf 0.25, 0.001, 0.001; K1's launches counted over just these),
           then the per-image functional path (decode -> nms_single on each
           image; K2's launches counted over just that); every result is held
           against the same detector with the plain NMS put in, K1 index for
           index against the plain NMS on the inputs the serving path gave it
           at both confidences, the kernels timed on them, and one request
           split into its stages by the detector's ``on_stage`` hook
  serve_transformer
           SkyEyeDetector("skyeye_l_transformer") at full width and depth, the
           same 3 requests (K4's and K1's launches counted over just these); its
           logits held against the same model with ``attention_reference`` put
           in, K1 against the plain NMS on the inputs the requests gave it, K4
           timed on the inputs the requests gave it (beside the plain versions
           and ``scaled_dot_product_attention``, timed as a yardstick only) and
           held with ``attention_reference`` against float64, and one request
           split into its stages
  serve_fused_csp
           skyeye_s rebuilt in the fused-CSP serving mode (``fused_csp_detector``:
           BN folded, csp1 on K3), the same 3 requests (K3's and K1's launches
           counted over just these, the block's packed weights prepared once and
           reused); its
           logits held against the canonical detector on the folded weights; K3
           timed on the input and packed weights the requests gave it (beside its
           plain version and the cuDNN bf16 canonical CSPBlock, as context); K3b,
           the same kernel under the v1 name, called once on that input
  serve_enhanced
           SkyEyeDetector("skyeye_l_enhanced") at full width and depth (the
           cross-layer attention P5 -> P4 -> P3), float32 with TF32 off, the same
           3 requests (K1's launches counted over just these); K1 index for index
           against the plain NMS on the inputs the requests gave it; one frame's
           logits held against the same module run in float64 on the card; one
           request split into its stages
  serve_bf16
           skyeye_s with ``dtype=torch.bfloat16``, then the same detector rebuilt
           whole in bf16 in the fused-CSP mode, each on the same 3 requests (K1's
           and K3's launches counted over just these); each one's logits held
           against the float32 detector on the same weights, K1 index for index
           against the plain NMS on the inputs the requests gave it, K3 timed
           and held against its plain version on the bf16 input it was given;
           one request of each split into its stages
  serve_tiled
           ``ops.tiling.detect_tiled`` as the JAX bench configures it: skyeye_s in
           bf16 with BN folded, tiles of 1280 at overlap 0.2, conf 0.25, iou 0.45,
           3 requests of 2 uint8 2160x3840 frames (16 tiles a request); K1 twice
           a request (the tiles' NMS at B 16, k 1024; the merge at B 2, k 2400),
           each launch's input held index for index against the plain NMS, and
           K1 timed on the merge's input
  serve_int8
           skyeye_s at full width, seeded weights, quantized by the facade's
           ``quantize_int8`` (BN folded, 16 RGB frames calibrated at 1280 px,
           the int8 neck) in bf16, then in float32 with TF32 off; the same 3
           requests (K1's launches and the int8 GEMMs counted over just these);
           K1 index for index against the plain NMS on the inputs the requests
           gave it; every int8 conv's int32 product on the inputs one batch
           gives it held bit for bit against ``int8_conv_plain``; the head
           logits against the float model on the same folded weights
           (correlation above 0.995 a level, max|d| printed); the model's ms
           against the float model's, its device time split by
           ``torch.profiler`` (``_int_mm``, the im2col windows), one request
           split into its stages
  serve_int8_early
           ``bench.py``'s SKYEYE_INT8 model: skyeye_s in bf16, BN folded, the
           packed stem (``pack_stem_variables``; held against the canonical
           model, bf16's bound), ranges calibrated on it by ``observe_ranges``,
           ``quantize_early_variables`` (held against the packed-stem model:
           cosine above 0.99, mean relative error below 0.15), then the int8
           stem (``fold_input_scale``, ``quantize_stem_variables``, uint8
           frames; the same gates); every int8 product bit for bit; the early
           model served by the facade for the 3 requests (K1 and the int8
           GEMMs counted, K1 index for index); each model's ms, the device split
  export   ``cli.export.run`` with every format (``torch_export``,
           ``checkpoint``, ``torch``) at 1280 px on skyeye_s and
           skyeye_l_enhanced from a ``.pt`` of seeded weights: the program,
           loaded back, within 1e-5 x max|out| of the model written; the
           checkpoint read back to its state; the reference ``.pt`` served by
           ``SkyEyeDetector(weights=..., fuse=False)`` to the detections of the
           model written (K1 once each); ``model_info`` (parameter tensors,
           parameters, GFLOPs at 640 and 1280 px) of every shipped config
  validate ``cli.validate`` in the reference protocol (rect, pad 0.5, 8 shape
           buckets, conf 0.001, IoU 0.6, multi-label, max_nms 8192, max_det 300)
           on skyeye_s at full width, nc 10, 1280 px, batch 16, over 48 PNG frames
           it writes (32 of 1080x1920, 8 of 1500x2000, 8 of 1920x1080), labelled
           from the facade's detections at conf 0.25 with the same seeded weights
           (one .pt; jittered, some dropped, some added); K1's launches counted
           over just that run; the same run with the plain NMS put in must give
           every figure the same, and K1 index for index on every input the run
           gave it (B 16, k 8192); K1 timed there; the host's decode and
           letterbox a frame, and the C PNG unfilter (host code) against its
           numpy version on a Paeth-filtered 1080p frame
  detect   ``cli.detect`` (``--save-txt --save-conf --save-crop``) on skyeye_s at
           full width with seeded weights (one .pt), 1280 px, float32 with TF32
           off, over 16 JPEG frames of 1080x1920 that the port's C encoder writes
           from ``frames``; K1 once a frame (16 launches, counted over just that
           run); every ``labels/*.txt`` line equal, to its printed digits, to
           ``infer`` + rescale on the same ``LoadImages`` frames, K1 index for
           index against the plain NMS on those inputs; every annotated JPEG
           decoding to its frame's shape, every crop decoding; the C JPEG
           encoder and decoder byte for byte and pixel for pixel against their
           plain versions on a noisy 256x384 crop, each timed; C decode and
           encode ms a 1080p frame, detect's ``Speed:`` figures and wall frames/s;
           K1 timed on detect's input (B 1, k 1152); one frame through each
           layer (decode, letterbox, copy, the card's stages, annotation,
           encode, crops, labels), timed alone
  train    ``cli.train`` on skyeye_s at full width and depth, nc 10, float32 with
           TF32 off, 640 px, batch 16, device augmentation with DEFAULT_HYP,
           accumulate 4, 3 epochs of 3 batches over validate's 48 frames (train
           and val), validation on the EMA weights after each epoch (K1's
           launches counted over the run, each input it got held index for index
           against the plain NMS, K1 timed on the first); every loss finite, the
           parameters changed at micro-steps 4 and 8 only, EMA's counter and the
           step 9, ``results.csv`` whole, ``last.pt`` served by the facade and
           validated (``validate(weights=)``) to its epoch's row; then, on the
           run's first batch and draws: the micro-step split by CUDA events
           (augment, forward, loss, backward, optimizer + EMA), its loss equal to
           the run's first, its loss and every gradient against float64 on the
           card, bf16's loss against float32's, the dense form of the loss
           (finite; its forward and backward timed beside the gather form's),
           and 10 steps on that batch
           without augmentation lowering the loss; the loader's host ms a frame,
           images/s and each epoch's wall time, peak memory
  train_transformer
           skyeye_l_transformer at full width and depth, 640 px, batch 16: the
           first micro-step's loss and every gradient with K4 against the same
           model with ``attention_reference`` put in (the same dropout masks),
           3 micro-steps (K4's launches counted: one a forward), ms a micro-step,
           peak memory, K4 timed on the input the step gave it beside
           ``scaled_dot_product_attention``
  train_host_aug
           ``cli.train`` as JAX trains by default (``device_aug=False``: the
           loader augments on the host, ``data/augment.py``): skyeye_s at full
           width and depth, nc 10, float32 with TF32 off, 640 px, batch 16,
           DEFAULT_HYP (mosaic 1.0, translate 0.1, scale 0.5, HSV, fliplr 0.5),
           4 workers, 1 epoch of 3 batches over validate's 48 frames,
           validation after each (K1's launches counted over the run, each
           input held index for index against the plain NMS); the loader's
           first batch at 1 and at 4 workers byte for byte equal; every loss
           finite; ``last.pt`` validated to its epoch's row; images/s and wall
           s an epoch, the loader's ms a frame on one thread split into decode
           and resize, mosaic, warp and HSV, and the card's micro-step on the
           first batch split as ``train`` splits it (its loss the run's first)
  train_remat
           skyeye_l_transformer at full width and depth, 640 px, batch 16: one
           micro-step from the seed-0 weights and the same batch at ``remat``
           "" , "block" and "stage" (and "" again: the card's run-to-run
           spread); loss, every gradient and every BatchNorm buffer against
           no remat (bitwise equality reported, else the largest gap over
           max|g|, held under 1e-6); K4 once a forward at each level; ms and
           peak memory a level; one "stage" micro-step at 1280 px
  evolve   ``cli.train(evolve=2, epochs=1)`` as in train_host_aug: ``evolve.csv``
           has 2 rows, generation 1 the base hyp, generation 2 ``mutate_hyp``
           of it from the seed's generator (recomputed here),
           ``hyp_evolved.yaml`` reads back through ``config.load_hyp`` to the
           best row; K1's launches counted over both generations' validations
  train_multi
           data-parallel training through ``parallel.launch`` (skyeye_s, nc
           10, 640 px, batch 16, float32, TF32 off, device augmentation,
           accumulate 2, 3 micro-steps from the smoke's weights): (a) world
           1 over NCCL: the plain step, its float64 copy, the data-parallel
           step (synced BatchNorm, the global batch's loss normalisers,
           summed gradients) and the FSDP step; (b) world 2 over gloo, two
           processes on the one card: data-parallel and FSDP against (a), the
           ranks' states equal bit for bit; the gates of ``_gates``; ms a
           micro-step with and without the wrapper, the collectives of a
           micro-step and NCCL's device ms (``torch.profiler``);
           skyeye_l_transformer's data-parallel micro-step (K4 once) against
           its plain step; (c) ``cli.train`` at world 2 over gloo, one epoch:
           rank 0 validates (K1 counted in its process) and writes,
           ``last.pt`` validated to its row
  train_spatial
           spatial sharding through ``parallel.launch``: a (data 1, spatial 2)
           mesh, two processes on the one card over gloo; skyeye_s at 1280
           px, batch 8, device augmentation, 3 micro-steps (accumulate 2),
           each rank on its 640 rows of every frame, against the
           one-process step on the whole frames (``_gates``), the ranks'
           states equal bit for bit; each rank's peak memory beside the
           one-process peak, ms, collectives and exchanges a micro-step;
           skyeye_l_transformer's micro-step at 640 px on the spatial mesh
           (K4 once a rank, on the gathered P5 tokens) against its
           one-process step; ``cli.train`` with ``spatial_shards=2`` in the
           same two processes, one epoch (rank 0 validates: K1)
  serve_mesh
           ``SkyEyeDetector("skyeye_s", mesh=...)``, two replicas on the one
           card: 3 requests of 16 frames at 1280 px and a batch of 3 (the pad
           path), index for index against the unmeshed detector, K1 once a
           share; the fused-CSP mode on the mesh (K3 once a share)

The serving phases reach K1 through the facade's default cut: late decode
(``ops/late_decode.py``), per level on the raw logits, k = 1152 at conf 0.25 and
4096 at 0.001. Then a ``{"kernels": [...]}`` line (a kernel's ``launches`` summed
over the paths in ``launches_by_path``: K1's include the int8 phases,
``export``, ``detect``, ``train``, ``train_host_aug``, ``evolve``,
``train_multi``, ``train_spatial`` and ``serve_mesh``, K3's ``serve_mesh``,
K4's ``train_transformer``, ``train_remat``, ``train_multi`` and
``train_spatial``),
the ``nvidia-smi`` name and
power-limit line, and, last, ``{"ok": true, "device": {...}}``. A watchdog ends
a hung run with a traceback and a non-zero exit. Imports torch, numpy and the
port only.
"""
from __future__ import annotations

import faulthandler
import itertools
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

WATCHDOG_S = 1100
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the
# tensor cores, TF32 and bf16 dense on the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_TF32_OPS_S = 495e12
PEAK_BF16_OPS_S = 989e12
# TF32 products that carry one float32 product in K4 (3xTF32)
TF32_PRODUCTS_PER_F32 = 3
# Operations per candidate and greedy step: the argmax compare, the IoU against
# the winner (2 min, 2 max, 2 sub, 2 clamp, 1 mul, 2 add, 1 sub, 1 div) and
# the suppression compare and select.
OPS_PER_CANDIDATE_STEP = 17

NMS_SOURCE = "skyeye_tpu_torch/csrc/nms.cu"
ATTENTION_SOURCE = "skyeye_tpu_torch/csrc/attention.cu"
CSP_SOURCE = "skyeye_tpu_torch/csrc/csp.cu"
KERNELS = {  # wrapper -> (id, the TPU kernel it replaces, its source here)
    "batched_greedy_nms": ("K1", "skyeye_tpu/ops/pallas/nms_kernel.py:220", NMS_SOURCE),
    "greedy_nms": ("K2", "skyeye_tpu/ops/pallas/nms_kernel.py:105", NMS_SOURCE),
    "csp_fused_v2": ("K3", "skyeye_tpu/ops/pallas/csp_kernel.py:198", CSP_SOURCE),
    "csp_fused": ("K3b", "skyeye_tpu/ops/pallas/csp_kernel.py:275", CSP_SOURCE),
    "flash_attention": ("K4", "skyeye_tpu/ops/pallas/attention_kernel.py:74", ATTENTION_SOURCE),
}
REQUESTS = [0.25, 0.001, 0.001]  # conf of the 3 requests each serving phase sends
# A float32 model (TF32 off) against the same module in float64: within this
# share of the largest |logit|
LOGIT_VS_FLOAT64_REL = 1e-3


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


def crowded_candidates(rng, b, k):
    """Rows as ``candidates`` gives them, except rows 2 on: 40 tight clusters of
    one class, so few candidates are kept and the walk runs past its first pass."""
    boxes, scores = candidates(rng, b, k)
    centers = rng.uniform(0, 1280, (40, 2))[rng.randint(0, 40, (b - 2, k))]
    centers = centers + rng.normal(0, 2, (b - 2, k, 2))
    boxes[2:] = np.concatenate([centers - 40, centers + 40], -1).astype(np.float32)
    return boxes, scores


def disjoint_candidates(rng, b, k):
    """Rows of k boxes on a grid, none overlapping, except that every tenth box
    repeats the one before it; a tenth of the scores invalid. Nearly all are kept."""
    i = np.arange(k)
    x, y = (i % 128) * 10.0, (i // 128) * 10.0
    boxes = np.stack([x, y, x + 8.0, y + 8.0], -1)[None].repeat(b, 0)
    boxes[:, 9::10] = boxes[:, 8::10][:, :boxes[:, 9::10].shape[1]]
    scores = rng.uniform(0.001, 1.0, (b, k))
    scores[rng.uniform(size=(b, k)) < 0.1] = -1.0
    return boxes.astype(np.float32), scores.astype(np.float32)


def nan_inf_candidates(rng):
    """A NaN score (row 2), NaN coordinates (row 1), tied +inf scores, -0.0 and
    +0.0 scores, a box of NaN area (infinite width, zero height) and a row of
    identical boxes under tied +inf scores."""
    boxes, scores = candidates(rng, 4, 200, n_cls=4)
    scores[0, [5, 17, 40]] = np.inf
    scores[0, [6, 7]] = np.float32(-0.0)
    scores[0, [8, 9]] = np.float32(0.0)
    boxes[0, 10] = [100.0, 100.0, np.inf, 100.0]
    scores[0, 10] = np.float32(0.99)
    boxes[1, 3, 1] = np.nan
    boxes[1, 50:60, 2] = np.nan
    scores[2, 199] = np.nan
    boxes[3, :20] = boxes[3, 0]
    scores[3, :20] = np.inf
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


def graph_ms(fn, runs: int) -> float:
    """Device milliseconds of fn() without the host's launch work: fn captured
    once in a CUDA graph, then runs replays back to back between two CUDA
    events, over runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


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


def walk_depth(order, n_pos, keep_idx, keep_valid):
    """Per image, the sorted position after the last kept candidate: how far the
    walk went (n_pos when it ran out of candidates before max_det)."""
    depth = []
    for i in range(keep_idx.shape[0]):
        n = int(n_pos[i])
        pos = {int(j): p for p, j in enumerate(order[i, :n].tolist())}
        kept = [pos[int(j)] for j in keep_idx[i][keep_valid[i]].tolist()]
        depth.append(max(kept) + 1 if kept else 0)
    return depth


def check_stages(torch, nms_kernel, name, tb, ts, iou, md):
    """Each stage's kernel against its plain stage on the same input, exactly:
    the order (n_pos, has_nan, the order and the sorted boxes' bits), the mask's
    defined words, and the walk's keep set."""
    order = nms_kernel.nms_order(tb, ts)
    p_order = nms_kernel.nms_order_plain(tb, ts)
    torch.cuda.synchronize()
    if not (torch.equal(order.n_pos, p_order.n_pos) and torch.equal(order.has_nan,
                                                                    p_order.has_nan)):
        fail(f"the order stage's n_pos or has_nan differ from the plain stage's on {name}")
    for i, n in enumerate(order.n_pos.tolist()):
        same_boxes = torch.equal(order.sorted_boxes[i, :n].view(torch.int32),
                                 p_order.sorted_boxes[i, :n].view(torch.int32))
        if not (torch.equal(order.order[i, :n], p_order.order[i, :n]) and same_boxes):
            fail(f"the order stage differs from the plain stage on {name}, image {i}")
    mask = nms_kernel.nms_mask(order.sorted_boxes, order.n_pos, iou)
    p_mask = nms_kernel.nms_mask_plain(order.sorted_boxes, order.n_pos, iou)
    defined = nms_kernel.mask_defined(order.n_pos, tb.shape[1])
    torch.cuda.synchronize()
    bad_words = int((mask[defined] != p_mask[defined]).sum())
    if bad_words:
        fail(f"the mask stage differs from the plain stage on {name}: {bad_words} words")
    idx, valid = nms_kernel.nms_walk(mask, order.order, order.n_pos, order.has_nan, md)
    p_idx, p_valid = nms_kernel.nms_walk_plain(mask, order.order, order.n_pos,
                                               order.has_nan, md)
    if not (torch.equal(idx, p_idx) and torch.equal(valid, p_valid)):
        fail(f"the walk stage differs from the plain stage on {name}")
    return order, int(defined.sum())


def phase_kernels(torch, nms_kernel):
    """K1 and K2 against their plain versions on the card, index for index, and
    each of their three stages against its plain stage."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    cases = []
    for k in (1024, 4096):
        boxes, scores = candidates(rng, 16, k)
        for iou in (0.45, 0.7):
            cases.append((f"b16_k{k}_iou{iou}", boxes, scores, iou, 300))
    boxes, scores = candidates(rng, 3, 1000)
    cases.append(("ragged_b3_k1000", boxes, scores, 0.45, 300))
    cases.append(("ragged_b3_k1000_iou0", boxes, scores, 0.0, 300))
    boxes, scores = special_candidates(rng)
    cases.append(("special_b5_k200", boxes, scores, 0.5, 64))
    boxes, scores = nan_inf_candidates(rng)
    cases.append(("nan_inf_zeros_b4_k200", boxes, scores, 0.5, 64))
    cases.append(("nan_inf_zeros_b4_k200_iou_negative", boxes, scores, -0.5, 64))
    boxes, scores = crowded_candidates(rng, 4, 4096)
    cases.append(("crowded_b4_k4096", boxes, scores, 0.45, 300))  # rows 2, 3: two passes
    boxes, scores = candidates(rng, 16, 8192)
    cases.append(("b16_k8192_iou0.45", boxes, scores, 0.45, 300))
    boxes, scores = candidates(rng, 3, 6001)
    cases.append(("ragged_b3_k6001", boxes, scores, 0.45, 300))

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
        order, defined_words = check_stages(torch, nms_kernel, name, tb, ts, iou, md)
        checked.append({"case": name, "B": int(tb.shape[0]), "k": int(tb.shape[1]), "iou": iou,
                        "max_det": md, "kept": valid.sum(dim=1).tolist(), "k2_rows": rows_ok,
                        "n_pos": order.n_pos.tolist(), "has_nan": order.has_nan.tolist(),
                        "walk_depth": walk_depth(order.order, order.n_pos, idx, valid),
                        "walk_limit": nms_kernel.walk_limit(int(tb.shape[1]), md),
                        "mask_words_defined": defined_words})
    # K1 alone at sizes past the kernels' fixed resources: more images than a
    # grid's y dimension takes, and more kept positions than the walk holds in
    # shared memory (they then live in keep_idx)
    limits = []
    for name, (boxes, scores), iou, md in (
            ("batch_70000_k64", candidates(rng, 70000, 64), 0.45, 16),
            ("b2_k16384_max_det16384", disjoint_candidates(rng, 2, 16384), 0.45, 16384)):
        tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
        idx, valid = nms_kernel.batched_greedy_nms(tb, ts, iou, md)
        ref_idx, ref_valid = nms_kernel.batched_greedy_nms_plain(tb, ts, iou, md)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_idx) and torch.equal(valid, ref_valid)):
            bad = int((idx != ref_idx).sum() + (valid != ref_valid).sum())
            fail(f"K1 disagrees with its plain version on {name}: {bad} slots")
        kept = valid.sum(dim=1)
        limits.append({"case": name, "B": int(tb.shape[0]), "k": int(tb.shape[1]), "iou": iou,
                       "max_det": md, "kept_min": int(kept.min()), "kept_max": int(kept.max())})
        del tb, ts, idx, valid, ref_idx, ref_valid

    times = {}
    # b16 at k 1024 and 4096 (iou 0.45), b16 at k 8192, b3 at k 6001
    timed = [c for c in cases if c[0] in ("b16_k1024_iou0.45", "b16_k4096_iou0.45",
                                          "crowded_b4_k4096", "b16_k8192_iou0.45",
                                          "ragged_b3_k6001")]
    for name, boxes, scores, iou, md in timed:
        tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
        order = nms_kernel.nms_order(tb, ts)
        mask = nms_kernel.nms_mask(order.sorted_boxes, order.n_pos, iou)
        b, k = ts.shape
        calls = {
            "K1": lambda: nms_kernel.batched_greedy_nms(tb, ts, iou, md),
            "K2": lambda: nms_kernel.greedy_nms(tb[0], ts[0], iou, md),
            "order": lambda: nms_kernel.nms_order(tb, ts),
            "mask": lambda: nms_kernel.nms_mask(order.sorted_boxes, order.n_pos, iou),
            "walk": lambda: nms_kernel.nms_walk(mask, order.order, order.n_pos, order.has_nan,
                                                md),
        }
        times[name] = {
            **{f"{n}_ms": cuda_ms(fn, 30) for n, fn in calls.items()},
            **{f"{n}_device_ms": graph_ms(fn, 30) for n, fn in calls.items()},
            "K1_plain_ms": cuda_ms(lambda: nms_kernel.batched_greedy_nms_plain(tb, ts, iou, md), 20),
            "mask_bytes": mask.numel() * mask.element_size(),
            "scratch_bytes": nms_kernel.scratch_bytes(b, k),
        }
        del order, mask
    emit("kernels", index_exact=True, stages_exact=True, cases=checked, limits=limits,
         median_ms_generated_inputs=times,
         kernels=[{"id": kid, "fn": fn, "status": "ported", "source": src}
                  for kid, fn, src in KERNELS.values()])


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


def serve_timed(det, batch, kernel_modules):
    """The 3 requests through ``det``, nothing patched, each timed on the host
    clock: every launch count set to 0 just before, read just after."""
    for m in kernel_modules:
        m.reset_launch_counts()
    served, ms = [], []
    for conf in REQUESTS:
        det.conf_thres = conf
        t0 = time.perf_counter()
        served.append(det(batch))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {}
    for m in kernel_modules:
        launches.update(m.LAUNCHES)
    return served, ms, launches


def record_k1_inputs(run):
    """Every input K1 is handed while ``run()`` runs (an untimed rerun), in order."""
    from skyeye_tpu_torch.ops import nms as port_nms

    real, inputs = port_nms.greedy_nms_batched, []

    def recording(offset_boxes, scores, iou_thres, max_det):
        inputs.append((offset_boxes.contiguous(), scores.contiguous(), iou_thres, max_det))
        return real(offset_boxes, scores, iou_thres, max_det)

    with mock.patch.object(port_nms, "greedy_nms_batched", recording):
        run()
    return inputs


def hold_k1(torch, nms_kernel, inputs, where: str):
    """K1 index for index against the plain NMS on each input; the kept counts."""
    kept = []
    for boxes, scores, iou, md in inputs:
        idx, valid = nms_kernel.batched_greedy_nms(boxes, scores, iou, md)
        p_idx, p_valid = nms_kernel.batched_greedy_nms_plain(boxes, scores, iou, md)
        if not (torch.equal(idx, p_idx) and torch.equal(valid, p_valid)):
            fail(f"K1 disagrees with the plain NMS on {where}'s input {list(scores.shape)}")
        kept.append({"shape": list(scores.shape), "kept": valid.sum(dim=1).tolist()})
    return kept


def rerun_k1_inputs(det, batch):
    """K1's input at each distinct conf of the requests, from an untimed rerun."""
    def run():
        for conf in sorted(set(REQUESTS)):
            det.conf_thres = conf
            det(batch)
    return record_k1_inputs(run)


def letterboxed(torch, batch, size: int = 1280):
    """The frames as the facade hands them to its model: RGB, letterboxed, /255,
    an NCHW view of NHWC memory on the card (float32)."""
    from skyeye_tpu_torch.ops.letterbox import letterbox_batch

    x = torch.from_numpy(np.stack([f[:, :, ::-1] for f in batch])).cuda()
    return letterbox_batch(x, (size, size)).permute(0, 3, 1, 2) / 255.0


def phase_serve(torch, gpu_line):
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.models.head import decode_predictions
    from skyeye_tpu_torch.ops import nms as port_nms
    from skyeye_tpu_torch.ops import nms_kernel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the reruns below see the same candidates
    torch.backends.cudnn.benchmark = False

    det = SkyEyeDetector("skyeye_s", img_size=1280, device="cuda", seed=0)
    batch = frames(seed=1)
    requests = REQUESTS
    det(batch)  # warm-up: cuDNN handles and workspaces
    torch.cuda.synchronize()

    served, ms, serve_launches = serve_timed(det, batch, (nms_kernel,))
    if serve_launches["batched_greedy_nms"] == 0:
        fail("the serving path never launched batched_greedy_nms")
    for r in served:
        check_detections(r, batch[0].shape[:2], det.config.nc)

    # -- what the serving path hands K1 at each conf (offset boxes, scores, iou, max_det)
    captured = dict(zip(sorted(set(requests)), rerun_k1_inputs(det, batch)))
    cands = [(captured[c][1] > 0).sum(dim=1).tolist() for c in requests]
    if sum(sum(c) for c in cands) == 0:
        fail("no candidate reached K1")

    # -- the per-image functional path: decode, then nms_single on each image ---
    with torch.inference_mode():
        dec = decode_predictions(det.model(letterboxed(torch, batch)), det.config.anchors,
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

    # -- K1 index for index on what the serving path gave it at conf 0.25 (k 1024)
    b25, s25, iou25, md25 = captured[0.25]
    k1_25 = nms_kernel.batched_greedy_nms(b25, s25, iou25, md25)
    p_25 = nms_kernel.batched_greedy_nms_plain(b25, s25, iou25, md25)
    if not (torch.equal(k1_25[0], p_25[0]) and torch.equal(k1_25[1], p_25[1])):
        fail("K1 disagrees with its plain version on the serving path's conf 0.25 input")
    conf025 = dict(shape=list(s25.shape), kept=k1_25[1].sum(dim=1).tolist(),
                   ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms(b25, s25, iou25, md25), 30),
                   device_ms=graph_ms(lambda: nms_kernel.batched_greedy_nms(
                       b25, s25, iou25, md25), 30),
                   plain_ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms_plain(
                       b25, s25, iou25, md25), 20))
    conf025["bound_ms"], conf025["bound_by"] = nms_bound(b25, s25, k1_25[1], md25)

    # -- the kernels timed on the inputs the serving path gave K1 at k = 4096 ----
    boxes, scores, iou, md = captured[0.001]
    k1_idx, k1_valid = nms_kernel.batched_greedy_nms(boxes, scores, iou, md)
    p_idx, p_valid = nms_kernel.batched_greedy_nms_plain(boxes, scores, iou, md)
    k2_idx, k2_valid = nms_kernel.greedy_nms(boxes[0], scores[0], iou, md)
    k1_err = int((k1_idx - p_idx).abs().max()) + int((k1_valid != p_valid).sum())
    k2_err = int((k2_idx - p_idx[0]).abs().max()) + int((k2_valid != p_valid[0]).sum())
    k1_bound, k1_by = nms_bound(boxes, scores, k1_valid, md)
    order = nms_kernel.nms_order(boxes, scores)
    depth = walk_depth(order.order, order.n_pos, k1_idx, k1_valid)
    mask = nms_kernel.nms_mask(order.sorted_boxes, order.n_pos, iou)
    # K1 runs the order and a walk that stops at max_det, as these do alone; its
    # mask is the first pass's square only where the walk ends inside it
    device_ms = {"K1": graph_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou, md), 30),
                 "K2": graph_ms(lambda: nms_kernel.greedy_nms(boxes[0], scores[0], iou, md), 30),
                 "order": graph_ms(lambda: nms_kernel.nms_order(boxes, scores), 30),
                 "walk": graph_ms(lambda: nms_kernel.nms_walk(mask, order.order, order.n_pos,
                                                              order.has_nan, md), 30),
                 "mask_one_pass": graph_ms(lambda: nms_kernel.nms_mask(
                     order.sorted_boxes, order.n_pos, iou), 30)}
    del order, mask
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
        s["library_ms"] = None  # no core PyTorch call computes greedy NMS

    emit("serve", model="skyeye_s", img_size=1280, batch=len(batch), frame=[1080, 1920],
         dtype="float32", tf32=False, conf=requests, ms_per_request=ms,
         images_per_s=[len(batch) / (t / 1e3) for t in ms],
         candidates_per_image=cands,
         detections_per_image=[[len(d) for d in r.xyxy] for r in served],
         launches={"serve": serve_launches, "per_image": per_image_launches},
         launches_per_request={n: c / len(requests) for n, c in serve_launches.items()},
         plain_nms_max_box_err_px=max_box_err,
         plain_nms_max_score_err=max_score_err, card=gpu_line,
         kept_on_timed_input=k1_valid.sum(dim=1).tolist(), walk_depth_on_timed_input=depth,
         k1_on_conf025_input=conf025, device_ms_on_timed_input=device_ms,
         stage_ms={str(c): stage_ms(torch, det, batch, c) for c in (0.25, 0.001)})
    return summary


def allclose_excess(got, ref, rtol: float, atol: float) -> float:
    """max(|got - ref| - (atol + rtol |ref|)): <= 0 when every element is within."""
    return float(((got - ref).abs() - (atol + rtol * ref.abs())).max())


def csp_weights(torch, gen, c: int, h: int, c_out: int, nb: int):
    """Seeded folded-CSP weights on the card, in the JAX layout, scaled as a folded
    conv's (N(0, 1 / fan_in)); biases N(0, 0.25)."""
    shapes = {"w_cv1": ((c, h), c), "b_cv1": ((h,), 16), "w_m1": ((nb, h, h), h),
              "b_m1": ((nb, h), 16), "w_m2": ((nb, 3, 3, h, h), 9 * h), "b_m2": ((nb, h), 16),
              "w_cv2": ((c, h), c), "b_cv2": ((h,), 16), "w_cv3": ((2 * h, c_out), 2 * h),
              "b_cv3": ((c_out,), 16)}
    return {name: torch.randn(shape, generator=gen, device="cuda") / fan_in ** 0.5
            for name, (shape, fan_in) in shapes.items()}


def csp_bound(x, out, weights):
    """K3's bound: x, the output and the weights in bf16 moved once over the HBM
    rate, against 2 (2 C h + 10 nb h^2 + 2 h C_out) operations a pixel over the
    bf16 tensor-core peak."""
    b, hh, ww, c = x.shape
    h, c_out, nb = weights.h, weights.c_out, weights.num_blocks
    nbytes = (x.numel() + out.numel() + sum(w.numel() for w in weights.rounded.values())) * 2
    ops = 2.0 * b * hh * ww * (2 * c * h + nb * 10 * h * h + 2 * h * c_out)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_BF16_OPS_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# K4's gradients against attention_reference's autograd: the backward is the
# same float32 recompute in another order of sums, so within 1e-4 of the largest
# gradient
GRAD_REL_TOL = 1e-4


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def attention_gradients(torch, attention_kernel, randn):
    """dq, dk, dv through K4's autograd Function on the card against autograd of
    ``attention_reference``, and a train-mode MultiHeadSelfAttention at N 256."""
    from skyeye_tpu_torch.models import attention as port_attention

    out = []
    for case, shape in (("b8_n400_hd64", (8, 400, 64)),
                        ("serving_b64_n1600_hd256", (64, 1600, 256))):
        q, k, v = (randn(shape).requires_grad_(True) for _ in range(3))
        g = randn(shape)
        attention_kernel.reset_launch_counts()
        o = attention_kernel.flash_attention(q, k, v)
        if o.grad_fn is None or attention_kernel.LAUNCHES["flash_attention"] != 1:
            fail(f"K4 with grad on {case}: grad_fn {o.grad_fn}, "
                 f"launches {attention_kernel.LAUNCHES['flash_attention']}")
        got = torch.autograd.grad(o, (q, k, v), g)
        want = torch.autograd.grad(attention_kernel.attention_reference(q, k, v), (q, k, v), g)
        errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        if not all(bool(torch.isfinite(a).all()) for a in got) or max(errs.values()) > GRAD_REL_TOL:
            fail(f"K4's gradients differ from attention_reference's on {case}: {errs}")
        out.append({"case": case, "shape": list(shape), "grad_fn": type(o.grad_fn).__name__,
                    "rel_err": errs})
        del q, k, v, g, o, got, want

    # train mode, N 256: the module reaches K4 through the Function
    torch.manual_seed(0)
    m = port_attention.MultiHeadSelfAttention(256, 4).cuda().train()
    x = randn((2, 256, 256))
    g = randn((2, 256, 256))
    attention_kernel.reset_launch_counts()
    y = m(x)
    y.backward(g)
    launches = attention_kernel.LAUNCHES["flash_attention"]
    # qkv's gradient comes through the recompute; proj's and the output depend on
    # K4's forward output
    got = {"out": y.detach(), "qkv.weight.grad": m.qkv.weight.grad.clone(),
           "proj.weight.grad": m.proj.weight.grad.clone()}
    m.zero_grad()
    with mock.patch.object(port_attention, "flash_attention", attention_kernel.attention_reference):
        y = m(x)
        y.backward(g)
    want = {"out": y.detach(), "qkv.weight.grad": m.qkv.weight.grad,
            "proj.weight.grad": m.proj.weight.grad}
    errs = {n: rel_err(got[n], want[n]) for n in got}
    if (launches != 1 or not all(bool(torch.isfinite(t).all()) for t in got.values())
            or max(errs.values()) > GRAD_REL_TOL):
        fail(f"train-mode MHSA: {launches} K4 launches, rel errs {errs}")
    out.append({"case": "mhsa_train_b2_n256_c256_h4", "k4_launches": launches,
                "rel_err": errs})
    return out


def attention_wide_heads(torch, attention_kernel, gen):
    """Heads of 320 (C 640, 2 heads, N 256): the gate sends them to the einsum
    path, which gives attention_reference's result; K4's wrapper refuses them."""
    from skyeye_tpu_torch.models import attention as port_attention

    torch.manual_seed(1)
    m = port_attention.MultiHeadSelfAttention(640, 2).cuda().eval()
    x = torch.randn((2, 256, 640), generator=gen, device="cuda")
    attention_kernel.reset_launch_counts()
    with torch.no_grad():
        got = m(x)
        q, k, v = m.qkv(x).reshape(2, 256, 3, 2, 320).permute(2, 0, 3, 1, 4).reshape(
            3, 4, 256, 320).unbind(0)
        o = attention_kernel.attention_reference(q, k, v)
        want = m.proj(o.reshape(2, 2, 256, 320).transpose(1, 2).reshape(2, 256, 640))
    launches = attention_kernel.LAUNCHES["flash_attention"]
    err = rel_err(got, want)
    if launches != 0 or not bool(torch.isfinite(got).all()) or err > GRAD_REL_TOL:
        fail(f"heads of 320: {launches} K4 launches, rel err {err} against attention_reference")
    try:
        attention_kernel.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    except ValueError:
        pass
    else:
        fail("K4's wrapper took heads of 320")
    return {"case": "mhsa_b2_n256_c640_h2_hd320", "k4_launches": launches, "rel_err": err}


def phase_kernels_attention_csp(torch, attention_kernel, csp_kernel):
    """K4 against ``attention_reference`` and K3/K3b against ``csp_fused_plain`` on
    the card, on seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(shape, sigma=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * sigma

    attention = []
    # (case, (B*heads, N, hd), sigma of q and k, rtol, atol): the tolerance of the
    # Pallas kernel's tests; the large-logit case keeps its own test's
    for case, shape, sigma, rtol, atol in (
            ("serving_b64_n1600_hd256", (64, 1600, 256), 1.0, 2e-4, 2e-5),
            ("b8_n400_hd64", (8, 400, 64), 1.0, 2e-4, 2e-5),
            ("b4_n300_hd96", (4, 300, 96), 1.0, 2e-4, 2e-5),
            ("b3_n37_hd40", (3, 37, 40), 1.0, 2e-4, 2e-5),  # one ragged tile
            ("b2_n1_hd20", (2, 1, 20), 1.0, 2e-4, 2e-5),    # one token, the narrowest heads
            ("large_logits_b1_n128_hd64", (1, 128, 64), 30.0, 1e-3, 1e-4)):
        q, k, v = randn(shape, sigma), randn(shape, sigma), randn(shape)
        got = attention_kernel.flash_attention(q, k, v)
        ref = attention_kernel.attention_reference(q, k, v)
        plain = attention_kernel.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        excess = allclose_excess(got, ref, rtol, atol)
        if not bool(torch.isfinite(got).all()) or excess > 0:
            fail(f"K4 disagrees with attention_reference on {case}: {excess} beyond "
                 f"rtol {rtol}, atol {atol}")
        attention.append({"case": case, "shape": list(shape), "rtol": rtol, "atol": atol,
                          "max_abs_err_vs_reference": float((got - ref).abs().max()),
                          "max_abs_err_vs_plain": float((got - plain).abs().max())})
    del q, k, v, got, ref, plain
    gradients = attention_gradients(torch, attention_kernel, randn)
    wide_heads = attention_wide_heads(torch, attention_kernel, gen)

    csp = []
    # (case, (B, H, W, C), nb, tile_rows): csp1's serving shape; nb 3 with ragged
    # tiles in both H (45 = 5 * 8 + 5) and W (37 = 32 + 5); 12 channels, which
    # the kernel loads in pairs rather than in eights; and csp1 of skyeye_m and of
    # the skyeye_l models at 1280 px, whose packed weights the kernel reads from
    # device memory (they do not fit shared memory beside the halo grid)
    for case, (b, hh, ww, c), nb, tile_rows in (
            ("serving_b16_320x320_c64_nb1", (16, 320, 320, 64), 1, csp_kernel.TILE_ROWS),
            ("ragged_b2_45x37_c64_nb3", (2, 45, 37, 64), 3, 8),
            ("narrow_b1_19x70_c12_nb2", (1, 19, 70, 12), 2, 5),
            ("skyeye_m_csp1_b16_320x320_c96_nb2", (16, 320, 320, 96), 2, csp_kernel.TILE_ROWS),
            ("skyeye_l_csp1_b16_320x320_c128_nb3", (16, 320, 320, 128), 3,
             csp_kernel.TILE_ROWS)):
        weights = csp_kernel.prepare_weights(csp_weights(torch, gen, c, c // 2, c, nb), nb)
        x = randn((b, hh, ww, c)).to(torch.bfloat16)
        got = csp_kernel.csp_fused_v2(x, weights, nb, tile_rows)
        v1 = csp_kernel.csp_fused(x, weights, nb, tile_rows)
        ref = csp_kernel.csp_fused_plain(x, weights, nb).float()
        torch.cuda.synchronize()
        err = float((got.float() - ref).abs().max())
        limit = 0.02 * float(ref.abs().max()) + 1e-3
        if not err <= limit:
            fail(f"K3 disagrees with csp_fused_plain on {case}: {err} > {limit}")
        if not torch.equal(got, v1):
            fail(f"K3b (csp_fused) and K3 (csp_fused_v2) differ on {case}")
        csp.append({"case": case, "shape": [b, hh, ww, c], "nb": nb, "tile_rows": tile_rows,
                    "max_abs_err": err, "limit": limit, "max_abs_ref": float(ref.abs().max()),
                    "weights_in_smem": csp_kernel.weights_in_smem(c, c // 2, nb, tile_rows),
                    "ms": cuda_ms(lambda: csp_kernel.csp_fused_v2(x, weights, nb, tile_rows),
                                  10),
                    "plain_ms": cuda_ms(lambda: csp_kernel.csp_fused_plain(x, weights, nb), 3),
                    **csp_bound(x, got, weights)})
        del weights, x, got, v1, ref
    emit("kernels_attention_csp", attention=attention, attention_gradients=gradients,
         attention_wide_heads=wide_heads, csp=csp)


def phase_serve_transformer(torch, gpu_line):
    """skyeye_l_transformer at full width: K4 and K1 on every request."""
    import torch.nn.functional as F

    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.models import attention as port_attention
    from skyeye_tpu_torch.ops import attention_kernel, nms_kernel

    det = SkyEyeDetector("skyeye_l_transformer", img_size=1280, device="cuda", seed=0)
    batch = frames(seed=1)
    det(batch)  # warm-up: cuDNN handles and workspaces
    torch.cuda.synchronize()

    served, ms, launches = serve_timed(det, batch, (nms_kernel, attention_kernel))
    for name in ("flash_attention", "batched_greedy_nms"):
        if launches[name] == 0:
            fail(f"the transformer's serving path never launched {name}")
    for r in served:
        check_detections(r, batch[0].shape[:2], det.config.nc)

    # -- what the requests hand K4 and K1, from an untimed rerun; K1 against the
    # plain NMS on those inputs, index for index
    real_flash, k4_inputs = port_attention.flash_attention, []

    def record_flash(q, k, v):
        k4_inputs[:] = [(q, k, v)]
        return real_flash(q, k, v)

    with mock.patch.object(port_attention, "flash_attention", record_flash):
        k1_inputs = rerun_k1_inputs(det, batch)
    kept = hold_k1(torch, nms_kernel, k1_inputs, "serve_transformer")

    # -- the logits with K4 against the same model with attention_reference put in
    with torch.inference_mode():
        x = letterboxed(torch, batch)
        got = det.model(x)
        with mock.patch.object(port_attention, "flash_attention",
                               attention_kernel.attention_reference):
            want = det.model(x)
    max_logit = max(float(w.abs().max()) for w in want)
    logit_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(bool(torch.isfinite(g).all()) for g in got) or logit_err > 1e-3 * max_logit:
        fail(f"logits with K4 differ from attention_reference's by {logit_err} "
             f"(max |logit| {max_logit})")
    del x, got, want

    # -- K4 timed on the inputs the requests gave it
    q, k, v = k4_inputs[0]
    out = attention_kernel.flash_attention(q, k, v)
    ref = attention_kernel.attention_reference(q, k, v)
    sdpa = F.scaled_dot_product_attention(q, k, v)
    b, n, hd = q.shape
    nbytes = 4 * q.numel() * 4  # q, k, v read once, o written once
    # two products of 2 N^2 hd each in float32: three TF32 products apiece
    ops = TF32_PRODUCTS_PER_F32 * 4.0 * b * n * n * hd
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_TF32_OPS_S * 1e3
    k4 = dict(
        name="flash_attention", path="serve_transformer",
        launches=launches["flash_attention"],
        max_abs_err=float((out - ref).abs().max()),
        ms=cuda_ms(lambda: attention_kernel.flash_attention(q, k, v), 10),
        plain_ms=cuda_ms(lambda: attention_kernel.flash_attention_plain(q, k, v), 5),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10),
        shape=[b, n, hd])
    k4_reference_ms = cuda_ms(lambda: attention_kernel.attention_reference(q, k, v), 5)
    sdpa_err = float((sdpa - ref).abs().max())
    # K4 and attention_reference against the same einsums in float64
    ref64 = attention_kernel.attention_reference(q.double(), k.double(), v.double())
    f64 = {"k4": float((out.double() - ref64).abs().max()),
           "attention_reference": float((ref.double() - ref64).abs().max())}
    del ref64
    del q, k, v, out, ref, sdpa, k4_inputs[:], k1_inputs

    k1 = dict(name="batched_greedy_nms", path="serve_transformer",
              launches=launches["batched_greedy_nms"])
    emit("serve_transformer", model="skyeye_l_transformer", img_size=1280, batch=len(batch),
         frame=[1080, 1920], dtype="float32", tf32=False, conf=REQUESTS,
         ms_per_request=ms, images_per_s=[len(batch) / (t / 1e3) for t in ms],
         detections_per_image=[[len(d) for d in r.xyxy] for r in served],
         launches=launches,
         launches_per_request={n_: c / len(REQUESTS) for n_, c in launches.items()},
         k1_kept_on_rerun=kept, logit_max_abs_err=logit_err, max_abs_logit=max_logit,
         k4_shape=k4["shape"], k4_ms=k4["ms"], k4_reference_ms=k4_reference_ms,
         k4_plain_ms=k4["plain_ms"], sdpa_ms=k4["library_ms"], sdpa_max_abs_err=sdpa_err,
         max_abs_err_vs_float64=f64,
         card=gpu_line, stage_ms={"0.001": stage_ms(torch, det, batch, 0.001)})
    del det
    torch.cuda.empty_cache()
    return [k4, k1]


def phase_serve_fused_csp(torch, gpu_line):
    """skyeye_s in the fused-CSP serving mode: K3 on every request."""
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.models.blocks import CSPBlock
    from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule, fused_csp_detector
    from skyeye_tpu_torch.ops import csp_kernel, fused_csp, nms_kernel
    from skyeye_tpu_torch.utils.checkpoint import fuse_conv_bn

    det = SkyEyeDetector("skyeye_s", img_size=1280, device="cuda", seed=0)
    folded = fuse_conv_bn(det.model.state_dict())
    canonical = SkyEyeDetectorModule(det.config)
    canonical.load_state_dict(folded, strict=True)
    canonical = canonical.eval().cuda()
    det.model = fused_csp_detector(det.model)
    batch = frames(seed=1)
    det(batch)  # warm-up; fused_csp_detector prepared the packed weights
    torch.cuda.synchronize()
    prepared = det.model.backbone.csp1.prepared

    served, ms, launches = serve_timed(det, batch, (csp_kernel, nms_kernel))
    for name in ("csp_fused_v2", "batched_greedy_nms"):
        if launches[name] == 0:
            fail(f"the fused-CSP serving path never launched {name}")
    if det.model.backbone.csp1.prepared is not prepared:
        fail("the fused CSP block prepared its packed weights again between requests")
    for r in served:
        check_detections(r, batch[0].shape[:2], det.config.nc)

    # -- logits against the canonical detector on the folded weights; csp1's input
    real = fused_csp.csp_fused_v2
    captured = []

    def record(x, weights, num_blocks, tile_rows):
        captured[:] = [(x, weights, num_blocks, tile_rows)]
        return real(x, weights, num_blocks, tile_rows)

    with torch.inference_mode():
        x = letterboxed(torch, batch)
        with mock.patch.object(fused_csp, "csp_fused_v2", record):
            got = det.model(x)
        want = canonical(x)
    levels = []
    for g, w in zip(got, want):
        err, limit = float((g - w).abs().max()), 0.05 * float(w.abs().max()) + 1e-2
        if not bool(torch.isfinite(g).all()) or err > limit:
            fail(f"fused-CSP logits differ from the canonical folded detector's: {err} > {limit}")
        levels.append({"max_abs_err": err, "limit": limit})
    del x, got, want

    # -- K3 and K3b on csp1's serving input, against the plain version
    xh, weights, nb, tile_rows = captured[0]
    with torch.inference_mode():
        out = csp_kernel.csp_fused_v2(xh, weights, nb, tile_rows)
        ref = csp_kernel.csp_fused_plain(xh, weights, nb)
        torch.cuda.synchronize()
        csp_kernel.reset_launch_counts()
        v1 = csp_kernel.csp_fused(xh, weights, nb, tile_rows)
        torch.cuda.synchronize()
        direct_launches = dict(csp_kernel.LAUNCHES)
        if not torch.equal(v1, out):
            fail("K3b (csp_fused) and K3 (csp_fused_v2) differ on csp1's serving input")
        err = float((out.float() - ref.float()).abs().max())
        if err > 0.02 * float(ref.float().abs().max()) + 1e-3:
            fail(f"K3 disagrees with csp_fused_plain on csp1's serving input by {err}")

        if weights is not prepared:
            fail("the served fused CSP block did not hand K3 its prepared weights")
        b, hh, ww, c = xh.shape
        bound = csp_bound(xh, out, weights)
        plain_ms = cuda_ms(lambda: csp_kernel.csp_fused_plain(xh, weights, nb), 5)
        summary = [
            dict(name="csp_fused_v2", path="serve_fused_csp", launches=launches["csp_fused_v2"],
                 max_abs_err=err, plain_ms=plain_ms, library_ms=None, shape=[b, hh, ww, c],
                 ms=cuda_ms(lambda: csp_kernel.csp_fused_v2(xh, weights, nb, tile_rows), 20),
                 **bound),
            dict(name="csp_fused", path="direct call on csp1's serving input",
                 launches=direct_launches["csp_fused"], max_abs_err=err, plain_ms=plain_ms,
                 library_ms=None, shape=[b, hh, ww, c],
                 ms=cuda_ms(lambda: csp_kernel.csp_fused(xh, weights, nb, tile_rows), 20),
                 **bound),
        ]
        # context only, not a port: the canonical CSPBlock on cuDNN, bf16, channels_last,
        # on the same folded weights and input
        block = CSPBlock(c, weights.c_out, nb, dtype=torch.bfloat16)
        block.load_state_dict({k[len("backbone.csp1."):]: v for k, v in folded.items()
                               if k.startswith("backbone.csp1.")}, strict=True)
        block = block.eval().cuda().to(torch.bfloat16).to(memory_format=torch.channels_last)
        x_nchw = xh.permute(0, 3, 1, 2)  # NCHW view of the NHWC input: channels_last
        cudnn_ms = cuda_ms(lambda: block(x_nchw), 20)

    emit("serve_fused_csp", model="skyeye_s", mode="fused_csp", img_size=1280,
         batch=len(batch), frame=[1080, 1920], conf=REQUESTS, ms_per_request=ms,
         images_per_s=[len(batch) / (t / 1e3) for t in ms],
         detections_per_image=[[len(d) for d in r.xyxy] for r in served],
         launches=launches, launches_per_request={n_: c_ / len(REQUESTS)
                                                  for n_, c_ in launches.items()},
         direct_call_launches=direct_launches, logits_vs_canonical_folded=levels,
         k3_shape=[b, hh, ww, c], k3_ms=summary[0]["ms"], k3b_ms=summary[1]["ms"],
         k3_plain_ms=plain_ms, cudnn_bf16_csp_block_ms=cudnn_ms, card=gpu_line,
         stage_ms={"0.001": stage_ms(torch, det, batch, 0.001)})
    for s in summary:
        s["cudnn_bf16_csp_block_ms"] = cudnn_ms
    del det, canonical, block, captured[:]
    torch.cuda.empty_cache()
    return summary + [dict(name="batched_greedy_nms", path="serve_fused_csp",
                           launches=launches["batched_greedy_nms"])]


def phase_serve_enhanced(torch, gpu_line):
    """skyeye_l_enhanced at full width and depth, float32: K1 on every request."""
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
    from skyeye_tpu_torch.ops import nms_kernel

    det = SkyEyeDetector("skyeye_l_enhanced", img_size=1280, device="cuda", seed=0)
    batch = frames(seed=1)
    det(batch)  # warm-up: cuDNN handles and workspaces
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    served, ms, launches = serve_timed(det, batch, (nms_kernel,))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches["batched_greedy_nms"] == 0:
        fail("the enhanced serving path never launched batched_greedy_nms")
    for r in served:
        check_detections(r, batch[0].shape[:2], det.config.nc)
    kept = hold_k1(torch, nms_kernel, rerun_k1_inputs(det, batch), "serve_enhanced")

    # -- the two cross-attentions alone, on the neck's outputs for the batch
    m = det.model
    with torch.inference_mode():
        p3, p4, p5 = m.neck(m.backbone(letterboxed(torch, batch)))
        p4_new = m.cross_attn_p5_p4(p4, p5) + p4
        cross_ms = {"p5_p4": cuda_ms(lambda: m.cross_attn_p5_p4(p4, p5), 5),
                    "p4_p3": cuda_ms(lambda: m.cross_attn_p4_p3(p3, p4_new), 5)}
    del p3, p4, p5, p4_new

    # -- one frame's logits against the same module in float64 on the card
    with torch.inference_mode():
        x = letterboxed(torch, batch[:1])
        got = det.model(x)
        m64 = SkyEyeDetectorModule(det.config, dtype=torch.float64)
        m64.load_state_dict(det.model.state_dict(), strict=True)
        m64 = m64.double().eval().cuda()
        want = m64(x.double())
    max_logit = max(float(w.abs().max()) for w in want)
    logit_err = max(float((g.double() - w).abs().max()) for g, w in zip(got, want))
    # float32 without TF32 through about 90 convs and two cross-attentions
    tol = LOGIT_VS_FLOAT64_REL * max_logit
    if not all(bool(torch.isfinite(g).all()) for g in got) or logit_err > tol:
        fail(f"enhanced logits differ from float64's by {logit_err} > {tol}")
    del x, got, want, m64

    emit("serve_enhanced", model="skyeye_l_enhanced", img_size=1280, batch=len(batch),
         frame=[1080, 1920], dtype="float32", tf32=False, conf=REQUESTS, ms_per_request=ms,
         images_per_s=[len(batch) / (t / 1e3) for t in ms],
         detections_per_image=[[len(d) for d in r.xyxy] for r in served],
         launches=launches, peak_memory_gib=peak_gb, cross_attention_ms=cross_ms,
         k1_on_rerun=kept, logit_max_abs_err_vs_float64=logit_err,
         max_abs_logit=max_logit, tolerance=tol, card=gpu_line,
         stage_ms={"0.001": stage_ms(torch, det, batch, 0.001)})
    del det
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="serve_enhanced",
                 launches=launches["batched_greedy_nms"])]


def phase_serve_bf16(torch, gpu_line):
    """skyeye_s in bf16, then its fused-CSP mode whole in bf16: K1 on every
    request, K3 on every request of the second."""
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.models.detector import fused_csp_detector
    from skyeye_tpu_torch.ops import csp_kernel, fused_csp, nms_kernel

    reference = SkyEyeDetector("skyeye_s", img_size=1280, device="cuda", seed=0)
    det = SkyEyeDetector("skyeye_s", img_size=1280, dtype=torch.bfloat16, device="cuda",
                         seed=0)
    batch = frames(seed=1)
    with torch.inference_mode():
        x = letterboxed(torch, batch)
        want = reference.model(x)
    del reference
    out, summary = {}, []
    for mode in ("bf16", "bf16_fused_csp"):
        if mode == "bf16_fused_csp":
            det.model = fused_csp_detector(det.model)
        det(batch)  # warm-up
        torch.cuda.synchronize()
        served, ms, launches = serve_timed(det, batch, (nms_kernel, csp_kernel))
        needed = ("batched_greedy_nms",) + (("csp_fused_v2",) if "fused" in mode else ())
        for name in needed:
            if launches[name] == 0:
                fail(f"the {mode} serving path never launched {name}")
        for r in served:
            check_detections(r, batch[0].shape[:2], det.config.nc)
        kept = hold_k1(torch, nms_kernel, rerun_k1_inputs(det, batch), f"serve_{mode}")

        # -- logits against the float32 detector on the same weights; K3's input
        real, captured, block_input = fused_csp.csp_fused_v2, [], []

        def record(xh, weights, num_blocks, tile_rows):
            captured[:] = [(xh, weights, num_blocks, tile_rows)]
            return real(xh, weights, num_blocks, tile_rows)

        hook = det.model.backbone.csp1.register_forward_pre_hook(lambda m, args: block_input.append(
            (str(args[0].dtype), args[0].is_contiguous(memory_format=torch.channels_last))))
        with torch.inference_mode(), mock.patch.object(fused_csp, "csp_fused_v2", record):
            got = det.model(x)
        hook.remove()
        levels = []
        for g, w in zip(got, want):
            err, limit = float((g.float() - w).abs().max()), 0.05 * float(w.abs().max()) + 1e-2
            if g.dtype != torch.bfloat16 or not bool(torch.isfinite(g).all()) or err > limit:
                fail(f"{mode} logits ({g.dtype}) differ from the float32 detector's: "
                     f"{err} > {limit}")
            levels.append({"max_abs_err": err, "limit": limit})
        del got
        out[mode] = dict(ms_per_request=ms, images_per_s=[len(batch) / (t / 1e3) for t in ms],
                         detections_per_image=[[len(d) for d in r.xyxy] for r in served],
                         launches=launches, k1_on_rerun=kept, logits_vs_float32=levels,
                         stage_ms={"0.001": stage_ms(torch, det, batch, 0.001)})
        summary.append(dict(name="batched_greedy_nms", path=f"serve_{mode}",
                            launches=launches["batched_greedy_nms"]))
        if captured:  # K3 on the bf16 activations the bf16 model gave it
            xh, weights, nb, tile_rows = captured[0]
            with torch.inference_mode():
                k3 = csp_kernel.csp_fused_v2(xh, weights, nb, tile_rows)
                ref = csp_kernel.csp_fused_plain(xh, weights, nb)
                err = float((k3.float() - ref.float()).abs().max())
                if xh.dtype != torch.bfloat16 or err > 0.02 * float(ref.float().abs().max()) + 1e-3:
                    fail(f"K3 on the bf16 model's input ({xh.dtype}): {err} from its plain version")
                # the block's input: its dtype and whether it was channels-last
                # already (then K3 reads it with no copy)
                out[mode]["k3"] = dict(shape=list(xh.shape), block_input=block_input,
                                       max_abs_err=err,
                                       ms=cuda_ms(lambda: csp_kernel.csp_fused_v2(
                                           xh, weights, nb, tile_rows), 20),
                                       plain_ms=cuda_ms(lambda: csp_kernel.csp_fused_plain(
                                           xh, weights, nb), 5))
            summary.append(dict(name="csp_fused_v2", path=f"serve_{mode}",
                                launches=launches["csp_fused_v2"]))
            del xh, weights, k3, ref, captured[:]
    emit("serve_bf16", model="skyeye_s", img_size=1280, batch=len(batch), frame=[1080, 1920],
         dtype="bfloat16", conf=REQUESTS, card=gpu_line, **out)
    del det, x, want
    torch.cuda.empty_cache()
    return summary


def tiled_frames(seed: int, n: int = 2):
    """Blocky seeded uint8 RGB frames, 2160x3840."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (n, 68, 120, 3), dtype=np.uint8)
    return np.ascontiguousarray(coarse.repeat(32, axis=1).repeat(32, axis=2)[:, :2160])


def phase_serve_tiled(torch, gpu_line):
    """Tiled 4K inference (skyeye_s, bf16, BN folded): K1 twice a request."""
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.ops.tiling import detect_tiled, tile_grid

    tile, overlap, conf, iou = 1280, 0.2, 0.25, 0.45
    det = SkyEyeDetector("skyeye_s", img_size=tile, dtype=torch.bfloat16, device="cuda", seed=0)
    module, anchors = det.model, det.config.anchors
    clips = [tiled_frames(seed=10 + i) for i in range(len(REQUESTS))]
    n_tiles = tile_grid(clips[0].shape[1:3], tile, overlap).shape[0] * len(clips[0])

    def request(frames_np, mark=None):
        x = torch.from_numpy(frames_np).cuda()
        if mark:
            mark("host_to_device")
        d, n = detect_tiled(module, anchors, x, tile=tile, overlap=overlap, conf_thres=conf,
                            iou_thres=iou, on_stage=mark)
        out = d.cpu().numpy(), n.cpu().numpy()
        if mark:
            mark("device_to_host")
        return out

    request(clips[0])  # warm-up
    torch.cuda.synchronize()
    nms_kernel.reset_launch_counts()
    results, ms = [], []
    for clip in clips:
        t0 = time.perf_counter()
        results.append(request(clip))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(nms_kernel.LAUNCHES)
    if launches["batched_greedy_nms"] != 2 * len(clips):
        fail(f"tiled requests launched K1 {launches['batched_greedy_nms']} times, "
             f"not twice each")
    for d, n in results:  # boxes are not clipped to the frame, as in JAX
        for i, rows in enumerate(d):
            rows = rows[: n[i]]
            if not np.isfinite(rows).all() or (len(rows) and (
                    rows[:, 4].min() <= conf or rows[:, 4].max() > 1
                    or rows[:, 5].min() < 0 or rows[:, 5].max() >= det.config.nc)):
                fail("tiled detections outside the score range or the class range")

    stages = {}  # one request split into stages (host clock, a synchronize at each)
    for _ in range(2):  # the second of two passes, so nothing is cold
        t, stages = time.perf_counter(), {}

        def mark(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            stages[name] = (now - t) * 1e3
            t = now

        t0 = time.perf_counter()
        request(clips[1], mark)
        stages["request"] = (time.perf_counter() - t0) * 1e3

    inputs = record_k1_inputs(lambda: request(clips[0]))
    shapes = [list(s.shape) for _, s, _, _ in inputs]
    if shapes != [[n_tiles, 1024], [len(clips[0]), n_tiles // len(clips[0]) * 300]]:
        fail(f"K1's inputs on the tiled path are {shapes}")
    kept = hold_k1(torch, nms_kernel, inputs, "serve_tiled")
    timed = {}
    for name, (boxes, scores, iou_, md) in zip(("tiles", "merge"), inputs):
        _, valid = nms_kernel.batched_greedy_nms(boxes, scores, iou_, md)
        bound, by = nms_bound(boxes, scores, valid, md)
        timed[name] = dict(
            shape=list(scores.shape), positive=(scores > 0).sum(dim=1).tolist(),
            ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou_, md), 30),
            device_ms=graph_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou_, md), 30),
            plain_ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms_plain(
                boxes, scores, iou_, md), 20),
            bound_ms=bound, bound_by=by)
    emit("serve_tiled", model="skyeye_s", dtype="bfloat16", bn_folded=True, tile=tile,
         overlap=overlap, conf=conf, iou=iou, frames_per_request=len(clips[0]),
         frame=list(clips[0].shape[1:3]), tiles_per_request=n_tiles, ms_per_request=ms,
         frames_per_s=[len(clips[0]) / (t / 1e3) for t in ms],
         detections_per_frame=[n.tolist() for _, n in results], launches=launches,
         k1_on_rerun=kept, k1_timed=timed, stage_ms=stages, card=gpu_line)
    del det, module, inputs
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="serve_tiled",
                 launches=launches["batched_greedy_nms"])]


INT8_CALIB_FRAMES = 16  # calibration frames of the int8 phases (2 batches of 8)
INT8_GATE_CORR = 0.995  # the int8 neck's logits against the float model (test_int8_neck.py)
INT8_GATE_COS, INT8_GATE_REL = 0.99, 0.15  # int8 early stages (test_int8_stage.py)


def calibration_frames(seed: int = 2):
    """RGB frames for calibration (``quantize_int8`` takes RGB), not the served ones."""
    return [np.ascontiguousarray(f[:, :, ::-1]) for f in frames(seed, INT8_CALIB_FRAMES)]


def checked_int8_convs(torch, run):
    """``run()`` with every ``int8_conv`` call's int32 product held bit for bit
    against ``int8_conv_plain`` on the same operands: the calls, each with its
    shapes and whether it was equal."""
    from skyeye_tpu_torch.ops import int8_stage, int8_stem

    real, calls = int8_stage.int8_conv, []

    def checking(x_q, k_q, stride=1, padding=int8_stage.P0):
        got = real(x_q, k_q, stride, padding)
        want = int8_stage.int8_conv_plain(x_q.contiguous(), k_q, stride, padding)
        calls.append({"x": list(x_q.shape), "k": list(k_q.shape), "stride": stride,
                      "equal": bool(torch.equal(got, want))})
        return got

    with mock.patch.object(int8_stage, "int8_conv", checking), \
            mock.patch.object(int8_stem, "int8_conv", checking):
        run()
    return calls


def hold_int8_convs(torch, run, where: str):
    calls = checked_int8_convs(torch, run)
    bad = [c for c in calls if not c["equal"]]
    if not calls or bad:
        fail(f"{where}: {len(bad)} of {len(calls)} int8 conv products differ from the plain "
             f"version (first: {bad[:1]})")
    return len(calls)


def logit_corr(torch, got, want) -> float:
    g, w = got.double().flatten(), want.double().flatten()
    g, w = g - g.mean(), w - w.mean()
    return float((g * w).sum() / (g.norm() * w.norm()))


def cos_rel(torch, got, want):
    """test_int8_stage's measures: cosine similarity and mean relative error."""
    g, w = got.double().flatten(), want.double().flatten()
    cos = float((g * w).sum() / (g.norm() * w.norm() + 1e-9))
    return cos, float((g - w).abs().mean() / (w.abs().mean() + 1e-9))


def int8_device_split(torch, run):
    """One ``run()`` under ``torch.profiler``: device ms in all, in ``aten::_int_mm``
    and in the im2col windows (``int8_stage._im2col``, labelled), None where the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from skyeye_tpu_torch.ops import int8_stage

    real = int8_stage._im2col

    def labelled(*args):
        with record_function("int8_im2col"):
            return real(*args)

    run()
    torch.cuda.synchronize()
    with mock.patch.object(int8_stage, "_im2col", labelled), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events  # the kernels themselves
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if total == 0:
        return {"device_ms": None, "int_mm_ms": None, "im2col_ms": None,
                "note": "the profiler showed no device time"}
    int_mm = sum(e.device_time_total for e in events if e.key == "aten::_int_mm") / 1e3
    im2col = sum(e.device_time_total for e in events if e.key == "int8_im2col") / 1e3
    return {"device_ms": total, "int_mm_ms": int_mm, "im2col_ms": im2col,
            "int_mm_share": int_mm / total, "im2col_share": im2col / total}


def phase_serve_int8(torch, gpu_line):
    """skyeye_s quantized by the facade (the int8 neck) in bf16, then in float32:
    K1 and the int8 GEMMs on every request."""
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
    from skyeye_tpu_torch.ops import int8_stage, nms_kernel
    from skyeye_tpu_torch.utils.checkpoint import fuse_conv_bn

    batch, calib = frames(seed=1), calibration_frames()
    out, summary = {}, []
    for name, dtype in (("bf16", torch.bfloat16), ("float32", torch.float32)):
        det = SkyEyeDetector("skyeye_s", img_size=1280, dtype=dtype, device="cuda", seed=0)
        folded = SkyEyeDetectorModule(det.config, dtype=dtype)  # the float model, folded
        folded.load_state_dict(fuse_conv_bn(det.model.state_dict()), strict=True)
        folded = folded.eval().cuda()
        t0 = time.perf_counter()
        det.quantize_int8(calib)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        if not det.model.int8_neck:
            fail("quantize_int8 left the neck in floating point")
        det(batch)  # warm-up
        torch.cuda.synchronize()
        served, ms, launches = serve_timed(det, batch, (nms_kernel, int8_stage))
        for kernel in ("batched_greedy_nms", "int8_conv"):
            if launches[kernel] == 0:
                fail(f"the int8 {name} serving path never launched {kernel}")
        for r in served:
            check_detections(r, batch[0].shape[:2], det.config.nc)
        kept = hold_k1(torch, nms_kernel, rerun_k1_inputs(det, batch), f"serve_int8_{name}")

        with torch.inference_mode():
            x = letterboxed(torch, batch).to(dtype)  # what the facade hands its model
            n_convs = hold_int8_convs(torch, lambda: det.model(x), f"serve_int8_{name}")
            got, want = det.model(x), folded(x)
            levels = []
            for g, w in zip(got, want):
                corr = logit_corr(torch, g, w)
                if not bool(torch.isfinite(g).all()) or not corr > INT8_GATE_CORR:
                    fail(f"int8 {name} logits: correlation {corr} with the float model "
                         f"<= {INT8_GATE_CORR}")
                levels.append({"corr": corr, "max_abs_err": float((g.float() - w.float()).abs().max()),
                               "max_abs_logit": float(w.float().abs().max())})
            del got, want
            model_ms = {"int8_neck": cuda_ms(lambda: det.model(x), 5),
                        name: cuda_ms(lambda: folded(x), 5)}
            split = int8_device_split(torch, lambda: det.model(x))
        out[name] = dict(calibration_s=calib_s, ms_per_request=ms,
                         images_per_s=[len(batch) / (t / 1e3) for t in ms],
                         detections_per_image=[[len(d) for d in r.xyxy] for r in served],
                         launches=launches, k1_on_rerun=kept, int8_convs_checked=n_convs,
                         logits_vs_float=levels, model_ms=model_ms, model_device_split=split,
                         stage_ms={"0.001": stage_ms(torch, det, batch, 0.001)})
        summary.append(dict(name="batched_greedy_nms", path=f"serve_int8_{name}",
                            launches=launches["batched_greedy_nms"]))
        del det, folded, x
        torch.cuda.empty_cache()
    emit("serve_int8", model="skyeye_s", img_size=1280, batch=len(batch), frame=[1080, 1920],
         calibration_frames=len(calib), conf=REQUESTS, tf32=False, card=gpu_line, **out)
    return summary


def phase_serve_int8_early(torch, gpu_line):
    """bench.py's SKYEYE_INT8 model (skyeye_s, bf16, packed stem, int8 stages
    1-2) on calibrated ranges, then the int8 stem: K1 on every request."""
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.config import load_model_config
    from skyeye_tpu_torch.models.backbone import scaled_depth
    from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule, create_detector
    from skyeye_tpu_torch.ops import int8_stage, nms_kernel
    from skyeye_tpu_torch.ops.calibrate import calibration_paths, observe_ranges
    from skyeye_tpu_torch.ops.int8_stem import quantize_stem_variables
    from skyeye_tpu_torch.ops.letterbox import letterbox, letterbox_batch
    from skyeye_tpu_torch.ops.packed_stem import fold_input_scale, pack_stem_variables
    from skyeye_tpu_torch.utils.checkpoint import fuse_conv_bn

    bf16, cfg = torch.bfloat16, load_model_config("skyeye_s")
    canonical = create_detector(cfg, dtype=bf16, device="cuda", seed=0)
    folded = fuse_conv_bn(canonical.state_dict())
    canonical.load_state_dict(folded, strict=True)

    def build(state, **flags):
        m = SkyEyeDetectorModule(cfg, dtype=bf16, **flags)
        m.load_state_dict(state, strict=True)
        return m.eval().cuda()

    packed_state = pack_stem_variables(folded)
    packed = build(packed_state, packed_stem=True)
    # calibrated on the packed-stem model as quantize_int8 calibrates: host
    # letterbox, /255, batches of 8
    calib = np.stack([letterbox(f, (1280, 1280), auto=False)[0]
                      for f in calibration_frames()]).astype(np.float32) / 255.0
    nb1, nb2 = scaled_depth(3, cfg.depth_multiple), scaled_depth(9, cfg.depth_multiple)
    t0 = time.perf_counter()
    ranges = observe_ranges(packed, [calib[i:i + 8] for i in range(0, len(calib), 8)],
                            paths=calibration_paths(int8_stage._range_key_map(nb1, nb2)))
    calib_s = time.perf_counter() - t0
    early = build(int8_stage.quantize_early_variables(packed_state, ranges, cfg),
                  packed_stem=True, int8_early=True)
    stem_float_state = fold_input_scale(packed_state)
    stem_float = build(stem_float_state, packed_stem=True)
    stem = build(quantize_stem_variables(stem_float_state), packed_stem=True, int8_stem=True)

    batch = frames(seed=1)
    gates = {}
    with torch.inference_mode():
        x = letterboxed(torch, batch).to(bf16)
        rgb = torch.from_numpy(np.stack([f[:, :, ::-1] for f in batch])).cuda()
        u8 = letterbox_batch(rgb, (1280, 1280)).round().to(torch.uint8).permute(0, 3, 1, 2)
        ref, got_packed = canonical(x), packed(x)
        gates["packed_vs_canonical"] = []
        for g, w in zip(got_packed, ref):  # an exact remap computed in bf16: serve_bf16's bound
            err, limit = float((g.float() - w.float()).abs().max()), 0.05 * float(w.float().abs().max()) + 1e-2
            if err > limit:
                fail(f"the packed-stem model differs from the canonical one: {err} > {limit}")
            gates["packed_vs_canonical"].append({"max_abs_err": err, "limit": limit})
        del ref
        for key, model, inp, want_model, want_inp in (
                ("int8_early_vs_packed", early, x, None, None),
                ("int8_stem_vs_packed", stem, u8, stem_float, u8.to(bf16))):
            want = got_packed if want_model is None else want_model(want_inp)
            gates[key] = []
            for g, w in zip(model(inp), want):
                cos, rel = cos_rel(torch, g, w)
                if not (cos > INT8_GATE_COS and rel < INT8_GATE_REL):
                    fail(f"{key}: cosine {cos}, mean relative error {rel}")
                gates[key].append({"cos": cos, "rel": rel, "corr": logit_corr(torch, g, w),
                                   "max_abs_err": float((g.float() - w.float()).abs().max())})
        n_convs = hold_int8_convs(torch, lambda: (early(x), stem(u8)), "serve_int8_early")
        model_ms = {"canonical_bf16": cuda_ms(lambda: canonical(x), 5),
                    "packed_stem_bf16": cuda_ms(lambda: packed(x), 5),
                    "int8_early": cuda_ms(lambda: early(x), 5),
                    "int8_stem": cuda_ms(lambda: stem(u8), 5)}
        split = int8_device_split(torch, lambda: early(x))
    del canonical, packed, stem_float, stem, got_packed, x, u8, rgb

    det = SkyEyeDetector("skyeye_s", img_size=1280, dtype=bf16, device="cuda", seed=0)
    det.model = early  # served as the facade serves: letterbox, /255, the cut, K1
    det(batch)  # warm-up
    torch.cuda.synchronize()
    served, ms, launches = serve_timed(det, batch, (nms_kernel, int8_stage))
    for kernel in ("batched_greedy_nms", "int8_conv"):
        if launches[kernel] == 0:
            fail(f"the int8 early serving path never launched {kernel}")
    for r in served:
        check_detections(r, batch[0].shape[:2], det.config.nc)
    kept = hold_k1(torch, nms_kernel, rerun_k1_inputs(det, batch), "serve_int8_early")
    emit("serve_int8_early", model="skyeye_s", img_size=1280, batch=len(batch),
         frame=[1080, 1920], dtype="bfloat16", calibration_frames=len(calib),
         calibration_s=calib_s, conf=REQUESTS, ms_per_request=ms,
         images_per_s=[len(batch) / (t / 1e3) for t in ms], launches=launches,
         k1_on_rerun=kept, int8_convs_checked=n_convs, gates=gates, model_ms=model_ms,
         int8_early_device_split=split, stage_ms={"0.001": stage_ms(torch, det, batch, 0.001)},
         card=gpu_line)
    del det, early
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="serve_int8_early",
                 launches=launches["batched_greedy_nms"])]


EXPORT_IMG = 1280
EXPORT_PROGRAM_REL = 1e-5  # the loaded program against the model: share of max|out|


def phase_export(torch, gpu_line, workdir):
    """``cli.export.run`` with every format on skyeye_s and skyeye_l_enhanced;
    what each format wrote, read back; ``model_info`` of every shipped config."""
    from pathlib import Path

    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.cli import export as port_export
    from skyeye_tpu_torch.config import MODEL_CONFIGS
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.utils.checkpoint import export_torch, fuse_conv_bn, load_model
    from skyeye_tpu_torch.utils.profiling import model_info

    t_phase = time.perf_counter()
    batch, out, summary = frames(seed=1), {}, []
    for cfg in ("skyeye_s", "skyeye_l_enhanced"):
        root = Path(workdir) / f"export_{cfg}"
        root.mkdir(parents=True, exist_ok=True)
        weights = export_torch(create_detector(cfg, device="cuda", seed=0), root / "weights.pt")
        t0 = time.perf_counter()
        program, checkpoint, reference = port_export.run(
            str(weights), formats=port_export.FORMATS, img_size=EXPORT_IMG, batch=1,
            output=str(root / "out"), device="cuda")
        export_s = time.perf_counter() - t0
        written = load_model(weights, device="cuda")  # the model run() wrote, BN folded
        written.load_state_dict(fuse_conv_bn(written.state_dict()), strict=True)

        x = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, (1, EXPORT_IMG, EXPORT_IMG, 3)).astype(np.float32)).cuda()
        with torch.inference_mode():
            want = port_export.DecodedForward(written, EXPORT_IMG)(x)
            got = torch.export.load(str(program)).module()(x)
        program_err = float((got - want).abs().max())
        limit = EXPORT_PROGRAM_REL * float(want.abs().max())
        if got.shape != want.shape or program_err > limit:
            fail(f"{cfg}'s torch.export program differs from the model: {program_err} > {limit}")
        del got, want, x
        reread = load_model(checkpoint, device="cuda").state_dict()
        if any(not torch.equal(reread[k], v) for k, v in written.state_dict().items()):
            fail(f"{cfg}'s checkpoint does not read back to the model written")

        # the reference-layout .pt, read back by the facade as it is (folded
        # already), serves the detections of the model written
        det_read = SkyEyeDetector(weights=reference, img_size=1280, device="cuda", fuse=False)
        det_written = SkyEyeDetector(cfg, img_size=1280, device="cuda")
        det_written.model = written
        nms_kernel.reset_launch_counts()
        read = det_read(batch)
        torch.cuda.synchronize()
        k1 = nms_kernel.LAUNCHES["batched_greedy_nms"]
        if k1 == 0:
            fail(f"serving {cfg}'s exported .pt never launched batched_greedy_nms")
        for a, b in zip(read.xyxy, det_written(batch).xyxy):
            if not np.array_equal(a, b):
                fail(f"{cfg}'s exported .pt serves other detections than the model written")
        out[cfg] = {"export_s": export_s, "program_max_abs_err": program_err,
                    "program_limit": limit, "k1_launches": k1,
                    "files_mb": {p.name: p.stat().st_size / 2 ** 20
                                 for p in (program, checkpoint, reference)},
                    "detections_per_image": [len(d) for d in read.xyxy]}
        summary.append(dict(name="batched_greedy_nms", path=f"export_{cfg}", launches=k1))
        del det_read, det_written, written, reread
        torch.cuda.empty_cache()

    info = {}
    for cfg in MODEL_CONFIGS:
        model = create_detector(cfg, device="cuda", seed=0)
        info[cfg] = {str(s): model_info(model, s) for s in (640, 1280)}
        del model
        torch.cuda.empty_cache()
    emit("export", formats=list(port_export.FORMATS), img_size=EXPORT_IMG, model_info=info,
         card=gpu_line, phase_s=time.perf_counter() - t_phase, **out)
    return summary


# The validation set the smoke writes: (frames, height, width). Rect batches of
# 16 at 1280 px come out as 736x1312 (the 32 wide frames) and 1312x1312 (the
# other 16: aspect 0.75 and 1.78 share a batch).
VALIDATION_FRAMES = ((32, 1080, 1920), (8, 1500, 2000), (8, 1920, 1080))
VALIDATION_IMG, VALIDATION_BATCH = 1280, 16
VALIDATION_K = 8192  # validate's max_nms: the multi-label cut keeps this many a frame
DRONE_NAMES = ["pedestrian", "people", "bicycle", "car", "van", "truck", "tricycle",
               "awning-tricycle", "bus", "motor"]  # configs/data/drone.yaml, nc 10


def validation_frames(seed: int):
    """Blocky seeded uint8 BGR frames of VALIDATION_FRAMES's shapes, in order."""
    rng = np.random.RandomState(seed)
    for count, h, w in VALIDATION_FRAMES:
        for _ in range(count):
            coarse = rng.randint(0, 256, (h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
            yield np.ascontiguousarray(coarse.repeat(32, axis=0).repeat(32, axis=1)[:h, :w])


def write_labels(results, shapes, rng, path_of):
    """YOLO label files from the facade's detections: boxes the facade clipped to
    the frame are dropped (slivers), a fifth of the rest dropped, the others
    jittered by N(0, 2) px; two stray boxes added a frame. Returns the count."""
    n = 0
    for i, (det, (h, w)) in enumerate(zip(results.xyxy, shapes)):
        lines = []
        for x1, y1, x2, y2, _, cls in det:
            if rng.uniform() < 0.2 or min(x1, y1) <= 0 or x2 >= w or y2 >= h:
                continue
            x1, y1, x2, y2 = np.clip(np.array([x1, y1, x2, y2]) + rng.normal(0, 2, 4), 0,
                                     [w, h, w, h])
            if x2 - x1 >= 1 and y2 - y1 >= 1:
                lines.append(f"{int(cls)} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                             f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}")
        for _ in range(2):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            bw, bh = rng.uniform(0.02, 0.2, 2)
            lines.append(f"{rng.randint(len(DRONE_NAMES))} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        path_of(i).write_text("\n".join(lines) + "\n")
        n += len(lines)
    return n


def host_ms(fn, runs: int) -> float:
    """Median host milliseconds of fn() over runs."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_validate(torch, gpu_line, workdir):
    """``cli.validate`` on skyeye_s at 1280 px in the reference protocol: K1 once a
    batch at (16, 8192), multi-label; the same run with the plain NMS put in. The
    frames, labels and weights stay in ``workdir`` for the train phases."""
    import contextlib
    import zlib
    from pathlib import Path

    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.cli import validate as port_validate
    from skyeye_tpu_torch.data import dataset, imageio
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.ops import nms as port_nms
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.utils.checkpoint import save_model

    t_phase = time.perf_counter()
    with contextlib.nullcontext(str(workdir)) as tmp:
        root = Path(tmp)
        img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
        img_dir.mkdir(parents=True)
        lbl_dir.mkdir(parents=True)
        t0 = time.perf_counter()
        frames_ = list(validation_frames(seed=20))
        paths = [str(img_dir / f"frame{i:03d}.png") for i in range(len(frames_))]
        shapes = [f.shape[:2] for f in frames_]
        with ThreadPoolExecutor(8) as pool:  # zlib lets go of the interpreter lock
            list(pool.map(imageio.imwrite_png, paths, frames_))
        del frames_
        write_s = time.perf_counter() - t0

        # one set of seeded weights, in a .pt: the facade labels with it, validate reads it
        weights = save_model(create_detector("skyeye_s", num_classes=len(DRONE_NAMES),
                                             device="cuda", seed=0), root / "skyeye_s.pt")
        labeller = SkyEyeDetector(weights=str(weights), img_size=VALIDATION_IMG,
                                  conf_thres=0.25, device="cuda")
        labelled = labeller(paths)  # image paths through imageio.imread (the C unfilter)
        n_labels = write_labels(labelled, shapes, np.random.RandomState(21),
                                lambda i: lbl_dir / f"frame{i:03d}.txt")
        del labeller, labelled
        data = {"path": str(root), "val": "images/val", "nc": len(DRONE_NAMES),
                "names": DRONE_NAMES}
        kw = dict(weights=str(weights), img_size=VALIDATION_IMG, rect=True,
                  batch_size=VALIDATION_BATCH, device="cuda", project=str(root / "runs"))

        nms_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        shipped = port_validate.validate(data, **kw)
        torch.cuda.synchronize()
        shipped_s = time.perf_counter() - t0
        launches = dict(nms_kernel.LAUNCHES)
        if launches["batched_greedy_nms"] == 0:
            fail("validation never launched batched_greedy_nms")

        # the same run with the plain NMS put in, every input K1 would get recorded
        inputs = []

        def plain(offset_boxes, scores, iou_thres, max_det):
            inputs.append((offset_boxes.contiguous(), scores.contiguous(), iou_thres, max_det))
            return nms_kernel.batched_greedy_nms_plain(offset_boxes, scores, iou_thres, max_det)

        with mock.patch.object(port_nms, "greedy_nms_batched", plain):
            with_plain = port_validate.validate(data, **kw)
        figures = [float(v) for v in shipped[0]] + shipped[1].tolist()
        plain_figures = [float(v) for v in with_plain[0]] + with_plain[1].tolist()
        if figures != plain_figures:
            fail(f"validation with K1 {figures} differs from the plain NMS's {plain_figures}")
        if not all(np.isfinite(figures)) or not 0 <= figures[3] <= figures[2] <= 1:
            fail(f"validation figures out of range: {figures}")
        kept = hold_k1(torch, nms_kernel, inputs, "validate")
        shapes_seen = sorted({tuple(s.shape) for _, s, _, _ in inputs})
        full = (VALIDATION_BATCH, VALIDATION_K)
        if full not in shapes_seen:
            fail(f"K1's inputs on the validation path were {shapes_seen}, not {full}")
        boxes, scores, iou, md = next(i for i in inputs if tuple(i[1].shape) == full)
        idx, valid = nms_kernel.batched_greedy_nms(boxes, scores, iou, md)
        bound, by = nms_bound(boxes, scores, valid, md)
        order = nms_kernel.nms_order(boxes, scores)
        k1 = dict(shape=list(full), positive=(scores > 0).sum(dim=1).tolist(),
                  kept=valid.sum(dim=1).tolist(),
                  walk_depth=walk_depth(order.order, order.n_pos, idx, valid),
                  walk_limit=nms_kernel.walk_limit(full[1], md),
                  ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou, md), 30),
                  device_ms=graph_ms(lambda: nms_kernel.batched_greedy_nms(
                      boxes, scores, iou, md), 30),
                  plain_ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms_plain(
                      boxes, scores, iou, md), 5),
                  bound_ms=bound, bound_by=by)

        # host work a frame: decode (imread) alone, and decode + resize + letterbox
        ds = dataset.AerialDataset(img_dir, img_size=VALIDATION_IMG,
                                   batch_size=VALIDATION_BATCH, rect=True, pad=0.5,
                                   shape_buckets=8)
        sample = range(0, len(ds), 8)
        decode_ms = float(np.median([host_ms(lambda: imageio.imread(ds.img_files[i]), 1)
                                     for i in sample]))
        item_ms = float(np.median([host_ms(lambda: ds[i], 1) for i in sample]))

        # the C unfilter against its numpy version on a 1080p frame of Paeth rows
        frame = next(validation_frames(seed=22))
        paeth = root / "paeth.png"
        imageio.imwrite_png(paeth, frame, filter_type=4)
        idat = b"".join(p for t, p in imageio._png_chunks(paeth.read_bytes()) if t == b"IDAT")
        h, w = frame.shape[:2]
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
        c_rows = imageio.unfilter(rows, 3, native=True)
        plain_rows = imageio.unfilter_plain(rows, 3)
        if not np.array_equal(c_rows, plain_rows) or not np.array_equal(
                c_rows.reshape(h, w, 3)[:, :, ::-1], frame):
            fail("the C unfilter differs from its numpy version on a Paeth-filtered frame")
        unfilter = dict(frame=[h, w], filter_type=4, equal=True,
                        c_ms=host_ms(lambda: imageio.unfilter(rows, 3, native=True), 10),
                        plain_ms=host_ms(lambda: imageio.unfilter_plain(rows, 3), 2))

    (mp, mr, map50, map_), (pre_ms, inf_ms, wall_ips) = shipped[0][:4], shipped[2]
    emit("validate", model="skyeye_s", nc=len(DRONE_NAMES), img_size=VALIDATION_IMG,
         rect=True, batch=VALIDATION_BATCH, frames=[list(f) for f in VALIDATION_FRAMES], labels=n_labels,
         batch_shapes=ds.batch_shapes.tolist(),
         k1_input_shapes=[list(s) for s in shapes_seen],
         mAP50=float(map50), mAP50_95=float(map_), P=float(mp), R=float(mr),
         plain_nms_figures_equal=True,
         speed={"pre_process_ms_per_image": pre_ms, "inference_nms_ms_per_image": inf_ms,
                "wall_images_per_s": wall_ips},
         validate_s=shipped_s, png_write_s=write_s, phase_s=time.perf_counter() - t_phase,
         host_ms_per_image={"decode": decode_ms, "decode_resize_letterbox": item_ms},
         launches=launches, k1_on_plain_run=kept, k1_timed=k1, unfilter=unfilter,
         card=gpu_line)
    del inputs, boxes, scores, idx, valid, order
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="validate",
                 launches=launches["batched_greedy_nms"])]


PREP_N = 16  # frames of each kind
PREP_SIZES = (1280, 640)
PREP_KINDS = ("jpeg", "jpeg_progressive", "png", "png_adam7")
PREP_THREADS = (1, 4, 8)
PREP_PLAIN_WORKERS = 8  # processes for the numpy version (the card's machine has 8 cores)
PREP_PYTHON_SAMPLE = 2  # frames of each kind timed on the Python path
PREP_VALIDATE_KINDS = ("jpeg", "jpeg_progressive", "png_adam7")  # 48 frames


def prep_frames(seed: int):
    """PREP_N seeded 1080x1920 BGR frames: ``frames``' blocks with noise, so that
    every DCT band and PNG filter is busy."""
    rng = np.random.RandomState(seed)
    return [np.clip(f.astype(np.int16) + rng.randint(-12, 13, f.shape), 0, 255).astype(np.uint8)
            for f in frames(seed, PREP_N)]


def write_prep_frame(args):
    """One frame in one of PREP_KINDS, written by the port's writers."""
    from skyeye_tpu_torch.data import imageio, jpeg

    path, kind, frame = args
    if kind == "jpeg":
        path.write_bytes(jpeg.encode(frame, native=True))
    elif kind == "jpeg_progressive":
        path.write_bytes(jpeg.encode_progressive(frame))
    else:
        imageio.imwrite_png(path, frame, filter_type=4, interlace=kind == "png_adam7")


def prep_plain_worker(path: str, sizes):
    """The numpy version of the native prep on one file, at each of ``sizes``:
    {size: (frame, meta)}, or None where it does not decode. Runs in a process
    of its own; it touches no CUDA."""
    from skyeye_tpu_torch.data import native

    img = native.decode_rgb_plain(path)
    if img is None:
        return None
    return {s: native.letterbox_plain(img, s, s) for s in sizes}


def phase_prep_native(torch, gpu_line, workdir):
    """JAX's native host prep on the card's host: ``csrc/prep.cu`` against its
    numpy version byte for byte (meta equal) on 16 frames of 1080x1920 each of
    baseline JPEG, progressive JPEG, PNG and Adam7 PNG at 1280 and 640 px, and
    packed 4x4 at 1280; the C path's ms a frame at 1, 4 and 8 threads beside
    the Python path's (imread + INTER_AREA + letterbox); ``cli.validate`` at
    its default ``rect=False`` over 48 of the frames (the loader on the native
    path, K1 counted); ``predict_files`` on the 16 JPEG frames, held against
    the packed model fed by the numpy prep."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from pathlib import Path

    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.cli import validate as port_validate
    from skyeye_tpu_torch.data import imageio, native
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.ops.letterbox import letterbox

    t_phase = time.perf_counter()
    root = Path(workdir) / "prep"
    img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
    for d in (img_dir, lbl_dir, root / "other"):
        d.mkdir(parents=True)
    suffix = {"jpeg": "jpg", "jpeg_progressive": "jpg", "png": "png", "png_adam7": "png"}
    paths = {kind: [(img_dir if kind in PREP_VALIDATE_KINDS else root / "other")
                    / f"{kind}{i:02d}.{suffix[kind]}" for i in range(PREP_N)]
             for kind in PREP_KINDS}
    s_big = PREP_SIZES[0]
    t0 = time.perf_counter()
    base = prep_frames(seed=40)
    h, w = base[0].shape[:2]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_prep_frame, [(paths[k][i], k, base[i]) for k in PREP_KINDS
                                         for i in range(PREP_N)]))
    write_s = time.perf_counter() - t0
    sizes = {k: sum(p.stat().st_size for p in paths[k]) / PREP_N for k in PREP_KINDS}
    every = [str(p) for k in PREP_KINDS for p in paths[k]]

    # the C path timed on an idle host first: ms a frame at 1, 4 and 8 threads
    native.prep_batch(every[:2], PREP_SIZES[1], PREP_SIZES[1])
    c_ms = {k: {t: host_ms(lambda: native.prep_batch([str(p) for p in paths[k]], s_big, s_big,
                                                      n_threads=t), 1) / PREP_N
                for t in PREP_THREADS} for k in PREP_KINDS}

    def python_path(p):  # the loader's Python path: decode, INTER_AREA, letterbox
        im = imageio.imread(p)
        h0, w0 = im.shape[:2]
        r = s_big / max(h0, w0)
        im = imageio.resize_area(im, (int(w0 * r), int(h0 * r)))
        return letterbox(im, (s_big, s_big), auto=False, scaleup=False)

    python_ms = {k: float(np.median([host_ms(lambda: python_path(p), 1)
                                     for p in paths[k][:PREP_PYTHON_SAMPLE]]))
                 for k in PREP_KINDS}

    # the numpy version in processes of their own, while the card works below
    ctx = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(PREP_PLAIN_WORKERS, mp_context=ctx)
    t_plain = time.perf_counter()
    plain_futures = [pool.submit(prep_plain_worker, p, PREP_SIZES) for p in every]

    # cli.validate at rect=False over 48 frames: labels from predict_files' detections
    weights = str(Path(workdir) / "skyeye_s.pt")
    val_paths = [str(p) for k in PREP_VALIDATE_KINDS for p in paths[k]]
    labeller = SkyEyeDetector(weights=weights, img_size=VALIDATION_IMG, conf_thres=0.25,
                              device="cuda")
    labelled = labeller.predict_files(val_paths)
    n_labels = write_labels(labelled, [(h, w)] * len(val_paths), np.random.RandomState(41),
                            lambda i: lbl_dir / (Path(val_paths[i]).stem + ".txt"))
    del labeller, labelled
    data = {"path": str(root), "val": "images/val", "nc": len(DRONE_NAMES), "names": DRONE_NAMES}
    prep_calls = []
    real_prep = native.prep_batch

    def counted_prep(*a, **k):
        prep_calls.append(len(a[0]))
        return real_prep(*a, **k)

    nms_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(native, "prep_batch", counted_prep):
        shipped = port_validate.validate(data, weights=weights, img_size=VALIDATION_IMG,
                                         batch_size=VALIDATION_BATCH, device="cuda",
                                         project=str(root / "runs"))
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    k1_validate = nms_kernel.LAUNCHES["batched_greedy_nms"]
    if prep_calls != [VALIDATION_BATCH] * (len(val_paths) // VALIDATION_BATCH):
        fail(f"validate's loader did not take the native path: prep_batch calls {prep_calls}")
    if k1_validate == 0:
        fail("validation on the native path never launched batched_greedy_nms")
    figures = [float(v) for v in shipped[0][:4]]
    if not all(np.isfinite(figures)) or not 0 <= figures[3] <= figures[2] <= 1:
        fail(f"validation figures out of range: {figures}")

    # predict_files on the 16 JPEG frames
    det = SkyEyeDetector(weights=weights, img_size=VALIDATION_IMG, device="cuda")
    jpegs = [str(p) for p in paths["jpeg"]]
    det.predict_files(jpegs[:1])  # build the packed model
    torch.cuda.synchronize()
    nms_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    res = det.predict_files(jpegs)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    k1_predict = nms_kernel.LAUNCHES["batched_greedy_nms"]
    if k1_predict != 1:
        fail(f"predict_files on 16 frames launched batched_greedy_nms {k1_predict} times")
    for d in res.xyxy:
        if d.ndim != 2 or d.shape[1] != 6 or not np.isfinite(d).all() or (
                len(d) and (d[:, :4].min() < 0 or d[:, [0, 2]].max() > w
                            or d[:, [1, 3]].max() > h)):
            fail(f"predict_files gave detections out of the frame: {d[:3]}")

    # the numpy version's results: C byte for byte against them
    plain = [f.result() for f in plain_futures]
    plain_s = time.perf_counter() - t_plain
    pool.shutdown()
    if any(p is None for p in plain):
        fail("the numpy prep failed to decode a frame the phase wrote")
    equal = {}
    for i, k in enumerate(PREP_KINDS):
        mine = plain[i * PREP_N: (i + 1) * PREP_N]
        for s in PREP_SIZES:
            frames_c, meta_c, n_ok = native.prep_batch([str(p) for p in paths[k]], s, s)
            want = np.stack([m[s][0] for m in mine])
            meta = np.stack([m[s][1] for m in mine])
            if n_ok != PREP_N or not np.array_equal(frames_c, want) or not np.array_equal(
                    meta_c, meta):
                fail(f"the C prep differs from its numpy version on {k} at {s} px "
                     f"({int((frames_c != want).sum())} bytes)")
            equal[f"{k}@{s}"] = True
    mine = plain[:PREP_N]  # the JPEG frames, packed as predict_files packs them
    packed_plain = native.s2d4_pack(np.stack([m[s_big][0] for m in mine]))
    packed_c, meta_c, _ = native.prep_batch_s2d4(jpegs, s_big)
    if not np.array_equal(packed_c, packed_plain):
        fail(f"the C prep's 4x4 pack differs from its numpy version at {s_big} px")
    equal[f"jpeg_s2d4@{s_big}"] = True

    # predict_files against the same packed model fed by the numpy prep
    nms_kernel.reset_launch_counts()
    got, n = det.infer(torch.from_numpy(packed_plain).cuda(), (s_big, s_big), packed=True)
    got, n = got.cpu().numpy(), n.cpu().numpy()
    for k in range(PREP_N):
        gain, dw, dh = mine[k][s_big][1]
        d = got[k, : n[k]].copy()
        w0, h0 = (s_big - 2 * dw) / gain, (s_big - 2 * dh) / gain
        d[:, [0, 2]] = np.clip((d[:, [0, 2]] - dw) / gain, 0, w0)
        d[:, [1, 3]] = np.clip((d[:, [1, 3]] - dh) / gain, 0, h0)
        if not np.array_equal(d, res.xyxy[k]):
            fail(f"predict_files frame {k} differs from the packed model on the numpy prep")

    emit("prep_native", frames={k: [PREP_N, h, w] for k in PREP_KINDS},
         bytes_per_file=sizes, sizes=list(PREP_SIZES), c_equals_plain=equal,
         ms_per_frame={f"c_{s_big}_by_threads": {k: {str(t): v for t, v in c_ms[k].items()}
                                                 for k in c_ms},
                       f"python_{s_big}": python_ms},
         plain_s=plain_s, plain_workers=PREP_PLAIN_WORKERS, write_s=write_s,
         validate=dict(rect=False, frames=len(val_paths), labels=n_labels,
                       prep_batch_calls=len(prep_calls), mAP50=figures[2],
                       mAP50_95=figures[3], P=figures[0], R=figures[1],
                       speed=list(shipped[2]), seconds=validate_s, k1_launches=k1_validate),
         predict_files=dict(frames=PREP_N, detections=sum(len(d) for d in res.xyxy),
                            seconds=predict_s, k1_launches=k1_predict,
                            times_ms=res.times, equal_to_plain_prep=True),
         card=gpu_line, phase_s=time.perf_counter() - t_phase)
    del det
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="prep_native",
                 launches=k1_validate + k1_predict)]


DETECT_IMG = 1280
DETECT_CODEC_FRAME = (256, 384)  # the C codec against its plain version on this crop


def detect_label_lines(det, shape):
    """``cli.detect``'s ``--save-txt --save-conf`` lines of one frame's rescaled
    detections, in the order it writes them."""
    h0, w0 = shape
    lines = []
    for *xyxy, conf, cls in reversed(det):
        xywh = [(xyxy[0] + xyxy[2]) / 2 / w0, (xyxy[1] + xyxy[3]) / 2 / h0,
                (xyxy[2] - xyxy[0]) / w0, (xyxy[3] - xyxy[1]) / h0]
        lines.append(" ".join(f"{v:.6g}" for v in [int(cls), *xywh, conf]))
    return lines


def detect_layers_ms(torch, det, path, im, im0, d, tmp):
    """One frame through detect's layers, each timed alone (host clock, median
    of 3; the card's stages with a synchronize at each, second of two passes):
    what a frame of ``cli.detect`` spends where."""
    from skyeye_tpu_torch.data import imageio, jpeg
    from skyeye_tpu_torch.data.loaders import _prep
    from skyeye_tpu_torch.utils.visualization import Annotator, colors, save_one_box

    tmp.mkdir(parents=True)
    out = {"decode": host_ms(lambda: imageio.imread(path), 3),
           "letterbox": host_ms(lambda: _prep(im0, DETECT_IMG, det.stride, False), 3),
           "host_to_device": host_ms(lambda: (torch.from_numpy(im[None]).cuda(),
                                              torch.cuda.synchronize()), 3)}
    x = torch.from_numpy(im[None]).cuda()
    for _ in range(2):
        marks, t = {}, time.perf_counter()

        def mark(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            marks[name] = (now - t) * 1e3
            t = now

        det.on_stage, t = mark, time.perf_counter()
        det.infer(x, (x.shape[1], x.shape[2]))
        det.on_stage = None
    out.update({f"card_{k}": v for k, v in marks.items()})  # letterbox, model, decode (the cut), nms

    def annotate():
        ann = Annotator(im0.copy(), line_width=3)
        for *xyxy, conf, cls in reversed(d):
            ann.box_label(xyxy, f"{int(cls)} {conf:.2f}", colors(int(cls), True))
        return ann.result()

    def labels():
        for row in detect_label_lines(d, im0.shape[:2]):
            with open(tmp / "labels.txt", "a") as f:
                f.write(row + "\n")

    annotated = annotate()
    out.update(annotate=host_ms(annotate, 3),
               encode=host_ms(lambda: jpeg.encode(annotated), 3),
               crops=host_ms(lambda: [save_one_box(xyxy, im0, file=tmp / "crop.jpg")
                                      for *xyxy, _, _ in d], 3),
               labels=host_ms(labels, 3), detections=len(d))
    return out


def phase_detect(torch, gpu_line, workdir):
    """``cli.detect`` on 16 JPEG frames of 1080x1920 that the port's encoder
    writes: skyeye_s at full width, 1280 px, float32 with TF32 off, K1 once a
    frame; its labels against ``infer`` + rescale on the same ``LoadImages``
    frames; the host C JPEG codec against its plain version."""
    import logging
    import re
    from pathlib import Path

    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.cli import detect as port_detect
    from skyeye_tpu_torch.data import imageio, jpeg
    from skyeye_tpu_torch.data.loaders import LoadImages
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.ops.boxes import scale_boxes
    from skyeye_tpu_torch.utils.checkpoint import save_model
    from skyeye_tpu_torch.utils.general import LOGGER

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the reference pass sees the same logits
    torch.backends.cudnn.benchmark = False
    t_phase = time.perf_counter()
    root = Path(workdir) / "detect"
    src = root / "src"
    src.mkdir(parents=True)

    # the C codec against its plain version: a noisy crop, bytes and pixels
    rng = np.random.RandomState(31)
    ch, cw = DETECT_CODEC_FRAME
    crop = np.clip(frames(30, 1)[0][:ch, :cw].astype(np.int16)
                   + rng.randint(-12, 13, (ch, cw, 3)), 0, 255).astype(np.uint8)
    c_bytes, plain_bytes = jpeg.encode(crop, native=True), jpeg.encode_plain(crop)
    if c_bytes != plain_bytes:
        fail(f"the C JPEG encoder's {len(c_bytes)} bytes differ from the plain version's "
             f"{len(plain_bytes)}")
    if not np.array_equal(jpeg.decode(c_bytes, native=True), jpeg.decode_plain(c_bytes)):
        fail("the C JPEG decoder differs from its plain version")
    codec = dict(frame=[ch, cw], bytes=len(c_bytes), equal=True,
                 c_encode_ms=host_ms(lambda: jpeg.encode(crop, native=True), 5),
                 plain_encode_ms=host_ms(lambda: jpeg.encode_plain(crop), 2),
                 c_decode_ms=host_ms(lambda: jpeg.decode(c_bytes, native=True), 5),
                 plain_decode_ms=host_ms(lambda: jpeg.decode_plain(c_bytes), 2))

    # 16 JPEG frames, written by the port's encoder (the C version)
    shots = frames(30)
    encode_ms = []
    for i, f in enumerate(shots):
        t0 = time.perf_counter()
        data = jpeg.encode(f)
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        (src / f"frame{i:02d}.jpg").write_bytes(data)
    paths = sorted(src.glob("*.jpg"))
    decode_ms = [host_ms(lambda p=p: imageio.imread(p), 1) for p in paths]
    weights = save_model(create_detector("skyeye_s", device="cuda", seed=0), root / "skyeye_s.pt")

    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    LOGGER.addHandler(handler)
    level = LOGGER.level
    LOGGER.setLevel(logging.INFO)
    try:
        nms_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        save_dir = port_detect.run(weights=str(weights), source=str(src),
                                   imgsz=(DETECT_IMG, DETECT_IMG), device="cuda", save_txt=True,
                                   save_conf=True, save_crop=True, project=str(root / "runs"),
                                   name="exp")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(nms_kernel.LAUNCHES)
    finally:
        LOGGER.removeHandler(handler)
        LOGGER.setLevel(level)
    if launches["batched_greedy_nms"] != len(shots):
        fail(f"detect launched batched_greedy_nms {launches['batched_greedy_nms']} times on "
             f"{len(shots)} frames")
    speed = next((m for m in records if m.startswith("Speed:")), "")
    figures = re.findall(r"([0-9.]+)ms", speed)
    if len(figures) != 2:
        fail(f"detect logged no Speed line: {records[-3:]}")

    # the labels against infer + rescale on the same LoadImages frames
    ref = SkyEyeDetector(weights=str(weights), img_size=DETECT_IMG, device="cuda")
    n_det, lines_checked, first = 0, 0, {}

    def reference():
        nonlocal n_det, lines_checked
        for path, im, im0, _, _ in LoadImages(src, img_size=DETECT_IMG, stride=ref.stride):
            x = torch.from_numpy(im[None]).cuda()
            det, n = ref.infer(x, (x.shape[1], x.shape[2]))
            d = det[0, : int(n[0])].float().cpu().numpy().copy()
            if len(d):
                d[:, :4] = scale_boxes(x.shape[1:3], torch.from_numpy(d[:, :4]),
                                       im0.shape[:2]).numpy()
            want = detect_label_lines(d, im0.shape[:2])
            label = Path(save_dir) / "labels" / f"{Path(path).stem}.txt"
            got = label.read_text().splitlines() if label.exists() else []
            if got != want:
                fail(f"detect's labels for {Path(path).name} differ from infer's: "
                     f"{got[:2]} against {want[:2]}")
            n_det += len(d)
            lines_checked += len(got)
            first.setdefault("frame", (im, im0, d))

    inputs = record_k1_inputs(reference)
    kept = hold_k1(torch, nms_kernel, inputs, "detect")
    if n_det == 0:
        fail("detect found nothing on 16 frames: the check above compared empty files")
    boxes, scores, iou, md = inputs[0]
    idx, valid = nms_kernel.batched_greedy_nms(boxes, scores, iou, md)
    bound, by = nms_bound(boxes, scores, valid, md)
    k1 = dict(shape=list(scores.shape), kept=valid.sum(dim=1).tolist(),
              ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou, md), 30),
              device_ms=graph_ms(lambda: nms_kernel.batched_greedy_nms(
                  boxes, scores, iou, md), 30),
              plain_ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms_plain(
                  boxes, scores, iou, md), 5),
              bound_ms=bound, bound_by=by)
    layers = detect_layers_ms(torch, ref, paths[0], *first["frame"], root / "layers")
    annotated = sorted(Path(save_dir).glob("*.jpg"))
    if [p.name for p in annotated] != [p.name for p in paths]:
        fail(f"detect wrote {len(annotated)} annotated frames for {len(paths)}")
    for p in annotated:
        if imageio.imread(p).shape != shots[0].shape:
            fail(f"{p.name} decodes to the wrong shape")
    crops = sorted((Path(save_dir) / "crops").rglob("*.jpg"))
    for p in crops:
        if imageio.imread(p).ndim != 3:
            fail(f"crop {p} does not decode")

    emit("detect", model="skyeye_s", img_size=DETECT_IMG, frames=len(shots),
         frame_shape=list(shots[0].shape), jpeg_bytes_per_frame=float(np.mean(
             [p.stat().st_size for p in paths])),
         launches=launches, k1_on_reference=kept[:2], detections=n_det,
         label_lines_equal=lines_checked, annotated=len(annotated), crops=len(crops),
         k1_timed=k1, layers_ms_per_frame=layers,
         speed={"pre_process_ms_per_image": float(figures[0]),
                "inference_nms_ms_per_image": float(figures[1])},
         detect_s=wall_s, wall_frames_per_s=len(shots) / wall_s,
         c_decode_ms_per_frame=float(np.median(decode_ms)),
         c_encode_ms_per_frame=float(np.median(encode_ms)), codec_vs_plain=codec,
         card=gpu_line, phase_s=time.perf_counter() - t_phase)
    del ref, inputs
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="detect", launches=launches["batched_greedy_nms"])]


TRAIN_IMG, TRAIN_BATCH, TRAIN_EPOCHS = 640, 16, 3  # JAX's defaults; 3 batches an epoch
TRAIN_ACCUMULATE = 4  # JAX's default at batch 16 (nominal batch 64)
# float32 (TF32 off) gradients against float64 on the run's first augmented batch
# (the same every run), of each tensor's max|g|: 1.23e-3 at worst on the card
# (spp4.cv1's kernel; two runs, equal to every digit). Most of that gap is SPP's
# max pools picking another winner in float64 (0.3-0.8% of the 5x5 windows):
# upstream of SPP it moves whole gradient terms, so on other batches the worst
# leaf reads 3.3e-4 to 1.3e-2, the same with max_pool2d in the pools
# (``python3 -m skyeye_tpu_torch.tools.train_grad_noise``). The limit holds for
# this batch only; other data needs a reading of its own.
GRAD_VS_FLOAT64_REL = 3e-3
# K4 against attention_reference in a train step on the same batch, of each
# gradient's max|g|: 3.58e-4 at worst (head.transformer2.ff1; two runs, equal).
# On the tool's three other batches 3.9e-4 to 5.9e-3, where the reference itself
# is 5.7e-3 to 1.5e-2 from float64 and K4 is no farther from float64 than it is:
# float32's own gap on this model exceeds 1e-4, so the limit is 1e-3.
K4_TRAIN_GRAD_REL = 1e-3
BF16_REL, BF16_ABS = 0.05, 1e-2  # the bf16 bound: 0.05 x max|a| + 1e-2


def assignment_collisions(torch, model, images_nhwc, targets, mask):
    """Per level: assignments (after the anchor-ratio filter) that share an
    (image, cell, anchor) with another."""
    from skyeye_tpu_torch.config import DEFAULT_HYP
    from skyeye_tpu_torch.losses.detection import build_targets_level
    from skyeye_tpu_torch.tools.train_grad_noise import flat_targets

    anchors = torch.as_tensor(np.asarray(model.config.anchors, np.float32), device="cuda")
    h, w = images_nhwc.shape[1:3]
    out = []
    for i, stride in enumerate(model.config.strides):
        hw = (h // int(stride), w // int(stride))
        asg = build_targets_level(flat_targets(targets), mask.reshape(-1), anchors[i], hw,
                                  DEFAULT_HYP["anchor_t"])
        m = asg["mask"]
        cell = ((asg["b"][m] * hw[0] + asg["gj"][m]) * hw[1] + asg["gi"][m]) * anchors.shape[1] \
            + asg["a"][m]
        out.append(int(m.sum()) - int(torch.unique(cell).numel()))
    return out


def loss_forward_backward_ms(torch, model, loss_fns, images_nhwc, targets, mask):
    """Each loss's forward and backward on one train-mode forward's logits, timed."""
    from skyeye_tpu_torch.tools.train_grad_noise import flat_targets
    from skyeye_tpu_torch.train import set_dropout_generator, step_generator

    model.train()
    set_dropout_generator(model, step_generator(0, 0, "cuda"))
    with torch.no_grad():
        outs = [o.detach().requires_grad_(True) for o in model(images_nhwc.permute(0, 3, 1, 2))]
    set_dropout_generator(model, None)
    flat, m = flat_targets(targets), mask.reshape(-1)
    return {name: cuda_ms(lambda: fn(outs, flat, m)[0].backward(), 20)
            for name, fn in loss_fns.items()}


def first_batch(torch, data, img, seed=0):
    """The first batch the train loader gives (its seed-0 shuffle), on the card."""
    from skyeye_tpu_torch.data.dataset import create_dataloader

    loader, ds = create_dataloader(data["path"] + "/" + data["train"], img_size=img,
                                   batch_size=TRAIN_BATCH, stride=32, augment=False,
                                   workers=4, seed=seed, shuffle=True)
    b = next(iter(loader))
    return ({k: torch.from_numpy(np.asarray(b[k])).cuda() for k in ("images", "targets", "mask")},
            ds)


def train_run(torch, port_train, port_validate, run):
    """``run()`` (a cli.train call) observed: each micro-step's start and loss,
    each validation's start and end, and every input K1 was handed."""
    steps, vals = [], []
    real_make, real_validate = port_train.make_train_step, port_validate.validate

    def timed_make(*a, **k):
        step = real_make(*a, **k)

        def observed(state, batch):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            steps.append((t0, m["loss"]))
            return state, m
        return observed

    def timed_validate(*a, **k):
        t0 = time.perf_counter()
        out = real_validate(*a, **k)
        vals.append((t0, time.perf_counter()))
        return out

    with mock.patch.object(port_train, "make_train_step", timed_make), \
            mock.patch.object(port_validate, "validate", timed_validate):
        k1_inputs = record_k1_inputs(run)
    torch.cuda.synchronize()
    return steps, vals, k1_inputs


def phase_train(torch, gpu_line, workdir):
    """``cli.train`` on skyeye_s at full width and depth, 640 px, batch 16, device
    augmentation, per-epoch validation on EMA weights through K1."""
    from pathlib import Path

    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.cli import train as port_train
    from skyeye_tpu_torch.cli import validate as port_validate
    from skyeye_tpu_torch.config import DEFAULT_HYP
    from skyeye_tpu_torch.data.device_aug import augment_batch_device
    from skyeye_tpu_torch.losses import ComputeLoss
    from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule, create_detector
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.train import (
        RuntimeOptimizer, create_train_state, make_train_step, optimizer, step_generator,
    )
    from skyeye_tpu_torch.tools.train_grad_noise import error_summary, grad_errors, loss_and_grads
    from skyeye_tpu_torch.utils.checkpoint import load_torch_checkpoint

    t_phase = time.perf_counter()
    root = Path(workdir)
    weights = root / "skyeye_s.pt"
    data = {"path": str(root), "train": "images/val", "val": "images/val",
            "nc": len(DRONE_NAMES), "names": DRONE_NAMES}

    # -- the run, observed (``train_run``): each micro-step's host time and loss,
    # each validation's wall time and K1's inputs; and whether the parameters changed
    emitted = []
    real_opt_step = optimizer.RuntimeOptimizer.step

    def watched_step(self, model):
        before = [p.detach().clone() for p in model.parameters()]
        changed = real_opt_step(self, model)
        moved = any(not torch.equal(b, p) for b, p in zip(before, model.parameters()))
        emitted.append((changed, moved))
        return changed

    nms_kernel.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(optimizer.RuntimeOptimizer, "step", watched_step):
        steps, vals, k1_inputs = train_run(
            torch, port_train, port_validate, lambda: port_train.train(
                cfg="skyeye_s", data=data, epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
                img_size=TRAIN_IMG, weights=str(weights), device_aug=True,
                project=str(root / "runs_train"), name="exp", seed=0, device="cuda"))
    train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(nms_kernel.LAUNCHES)
    if launches["batched_greedy_nms"] == 0:
        fail("training's per-epoch validation never launched batched_greedy_nms")
    kept = hold_k1(torch, nms_kernel, k1_inputs, "train")
    boxes, scores, iou, md = k1_inputs[0]
    _, valid = nms_kernel.batched_greedy_nms(boxes, scores, iou, md)
    bound, by = nms_bound(boxes, scores, valid, md)
    k1 = dict(shape=list(scores.shape), positive=int((scores > 0).sum()),
              ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou, md), 30),
              device_ms=graph_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou, md),
                                 30),
              plain_ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms_plain(
                  boxes, scores, iou, md), 3),
              bound_ms=bound, bound_by=by)
    del boxes, scores, valid, k1_inputs

    n_micro = TRAIN_EPOCHS * 3
    losses = [float(v) for _, v in steps]
    if len(steps) != n_micro or not all(np.isfinite(losses)):
        fail(f"training ran {len(steps)} micro-steps (want {n_micro}), losses {losses}")
    want_emit = [(i + 1) % TRAIN_ACCUMULATE == 0 for i in range(n_micro)]
    if [c for c, _ in emitted] != want_emit or any(c != m for c, m in emitted):
        fail(f"parameters changed at the wrong micro-steps: {emitted} (want {want_emit})")
    last = root / "runs_train" / "exp" / "weights" / "last.pt"
    state_last, meta = load_torch_checkpoint(last)
    if meta["ema_updates"] != n_micro or meta["step"] != n_micro or \
            meta["optimizer"]["gradient_step"] != n_micro // TRAIN_ACCUMULATE:
        fail(f"EMA counter {meta['ema_updates']}, step {meta['step']}, optimizer steps "
             f"{meta['optimizer']['gradient_step']} after {n_micro} micro-steps")
    with open(root / "runs_train" / "exp" / "results.csv") as f:
        rows = [r.strip().split(",") for r in f.readlines()[1:]]
    if len(rows) != TRAIN_EPOCHS or not all(np.isfinite([float(v) for v in r]).all()
                                            for r in rows):
        fail(f"results.csv rows: {rows}")
    # epoch walls: from an epoch's first micro-step to its validation's start and end
    epoch_s, images_s = [], []
    for e in range(TRAIN_EPOCHS):
        first = steps[3 * e][0]
        epoch_s.append({"train": vals[e][0] - first, "with_validation": vals[e][1] - first})
        images_s.append(3 * TRAIN_BATCH / (vals[e][0] - first))

    # last.pt serves through the facade
    det = SkyEyeDetector(weights=str(last), img_size=TRAIN_IMG, device="cuda")
    served = det(list(itertools.islice(validation_frames(seed=20), 2)))
    check_detections(served, (1080, 1920), det.config.nc)
    del det
    # last.pt holds the weights its epoch was validated with (the EMA's):
    # validate() on the file (BN folded) gives that epoch's row of results.csv
    (mp, mr, map50, map_, *_), _, _ = port_validate.validate(
        data, weights=str(last), batch_size=TRAIN_BATCH, img_size=TRAIN_IMG,
        project=str(root / "runs_val_last"), plots=False, device="cuda")
    last_val = {"validate": [mp, mr, map50, map_], "results_csv": [float(v) for v in rows[-1][4:8]]}
    if not np.allclose(last_val["validate"], last_val["results_csv"], rtol=1e-3, atol=0):
        fail(f"last.pt validates to {last_val['validate']}, its epoch's row says "
             f"{last_val['results_csv']}")

    # -- the step split, on the run's first batch with its first draws
    batch, ds = first_batch(torch, data, TRAIN_IMG)
    model = create_detector("skyeye_s", num_classes=len(DRONE_NAMES), device="cuda")
    model.load_state_dict(load_torch_checkpoint(weights)[0], strict=True)
    loss_fn = ComputeLoss(model.config.anchors, model.config.nc)
    opt = RuntimeOptimizer(model, DEFAULT_HYP, batch_size=TRAIN_BATCH)
    marks = []
    step = make_train_step(model, loss_fn, opt, device_augment=lambda im, t, m, g:
                           augment_batch_device(im, t, m, g, hyp=DEFAULT_HYP),
                           on_stage=lambda name: marks.append((name, cuda_event(torch))))
    state = create_train_state(model, opt)

    def micro_step(i):
        marks.clear()
        marks.append(("start", cuda_event(torch)))
        b = dict(batch, aug_generator=step_generator(0, i, "cuda"), n_valid=TRAIN_BATCH,
                 opt_hyperparams={"lr": 0.0, "bias_lr": 0.0, "momentum": 0.937})
        return step(state, b)[1]

    first_loss = float(micro_step(0)["loss"])  # the run's first micro-step, re-run
    if abs(first_loss - losses[0]) > 1e-6 * abs(losses[0]):
        fail(f"the first micro-step re-run gives loss {first_loss}, the run gave {losses[0]}")
    split = []
    for i in range(1, 6):
        micro_step(i)
        torch.cuda.synchronize()
        split.append({n: marks[j - 1][1].elapsed_time(marks[j][1])
                      for j, (n, _) in enumerate(marks) if j})
    split_ms = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    step_ms = sum(split_ms.values())
    loader_ms = float(np.median([host_ms(lambda: ds[i], 1) for i in range(0, len(ds), 6)]))
    del state, step, opt

    # -- the first micro-step in float32 against float64 on the card (same
    # augmented batch, train mode), gradient by gradient
    images = augment_batch_device(batch["images"].float() / 255.0, batch["targets"],
                                  batch["mask"], step_generator(0, 0, "cuda"), hyp=DEFAULT_HYP)
    aug_images, aug_t, aug_m = images
    model.load_state_dict(load_torch_checkpoint(weights)[0], strict=True)
    l32, aux32, g32 = loss_and_grads(model, loss_fn, aug_images, aug_t, aug_m)
    if abs(l32 - first_loss) > 1e-6 * abs(first_loss):
        fail(f"the first micro-step's loss {l32} differs from the step's {first_loss}")
    m64 = SkyEyeDetectorModule(model.config, dtype=torch.float64)
    m64.load_state_dict(load_torch_checkpoint(weights)[0], strict=True)
    m64 = m64.double().cuda()
    l64, aux64, g64 = loss_and_grads(m64, loss_fn, aug_images.double(), aug_t, aug_m)
    del m64
    errs = grad_errors(g32, g64)
    worst = max(errs, key=errs.get)
    if abs(l32 - l64) > 1e-5 * abs(l64) or errs[worst] > GRAD_VS_FLOAT64_REL:
        fail(f"float32 against float64: loss {l32} vs {l64}; worst gradients "
             f"{error_summary(errs)['worst']} of max|g|")
    del g32, g64

    # -- one bf16 micro-step's loss against float32's
    mbf = create_detector("skyeye_s", num_classes=len(DRONE_NAMES), dtype=torch.bfloat16,
                          device="cuda")
    mbf.load_state_dict(load_torch_checkpoint(weights)[0], strict=True)
    lbf, _, _ = loss_and_grads(mbf, loss_fn, aug_images, aug_t, aug_m)
    del mbf
    if not abs(lbf - l32) <= BF16_REL * abs(l32) + BF16_ABS:
        fail(f"bf16 micro-step loss {lbf} against float32's {l32}")

    # -- the dense form of the loss (cli.train's SKYEYE_DENSE_LOSS) on the same
    # micro-step: finite, equal to the gather form where no two assignments
    # share a cell (it averages colliding targets where the gather form takes
    # each); each form's loss forward and backward timed on the step's logits
    dense_fn = ComputeLoss(model.config.anchors, model.config.nc, dense=True)
    model.load_state_dict(load_torch_checkpoint(weights)[0], strict=True)
    l_dense, aux_dense, g_dense = loss_and_grads(model, dense_fn, aug_images, aug_t,
                                                 aug_m)
    collisions = assignment_collisions(torch, model, aug_images, aug_t, aug_m)
    if not (np.isfinite(l_dense) and all(bool(torch.isfinite(g).all())
                                         for g in g_dense.values())):
        fail(f"the dense loss gave {l_dense} or non-finite gradients")
    if sum(collisions) == 0 and abs(l_dense - l32) > 1e-5 * abs(l32):
        fail(f"no colliding assignments, yet the dense loss {l_dense} differs from {l32}")
    del g_dense
    loss_ms = loss_forward_backward_ms(torch, model, {"gather": loss_fn, "dense": dense_fn},
                                       aug_images, aug_t, aug_m)

    # -- 10 steps on one fixed batch, no augmentation, a fixed lr: the loss falls
    model.load_state_dict(load_torch_checkpoint(weights)[0], strict=True)
    opt = RuntimeOptimizer(model, DEFAULT_HYP, batch_size=64)  # accumulate 1
    step = make_train_step(model, loss_fn, opt)
    state = create_train_state(model, opt)
    fixed = []
    for i in range(10):
        _, m = step(state, dict(batch, opt_hyperparams={"lr": 0.01, "bias_lr": 0.01,
                                                        "momentum": 0.937}))
        fixed.append(float(m["loss"]))
    if not (np.isfinite(fixed).all() and fixed[-1] < fixed[0]):
        fail(f"10 steps on one batch did not lower the loss: {fixed}")
    del state, step, opt, model, batch, images, aug_images

    emit("train", model="skyeye_s", nc=len(DRONE_NAMES), img_size=TRAIN_IMG,
         batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS, accumulate=TRAIN_ACCUMULATE,
         frames=len(ds), dtype="float32", tf32=False, device_aug=True, hyp="DEFAULT_HYP",
         micro_step_losses=losses, params_changed=[c for c, _ in emitted],
         ema_updates=meta["ema_updates"], optimizer_steps=meta["optimizer"]["gradient_step"],
         results_csv=rows, train_s=train_s, epoch_s=epoch_s, images_per_s=images_s,
         step_ms=step_ms, step_split_ms=split_ms,
         host_ms_per_frame=loader_ms, device_ms_per_frame=step_ms / TRAIN_BATCH,
         peak_memory_gib=peak_gib, launches=launches,
         k1_inputs={"count": len(kept), "shapes": sorted({tuple(k["shape"]) for k in kept}),
                    "kept": [min(min(k["kept"]) for k in kept),
                             max(max(k["kept"]) for k in kept)]},
         k1_timed=k1,
         first_step_loss={"float32": l32, "float64": l64, "aux32": aux32, "aux64": aux64},
         grad_vs_float64=error_summary(errs),
         bf16_loss=lbf, dense_loss={"loss": l_dense, "aux": aux_dense,
                                    "colliding_assignments": collisions,
                                    "loss_fwd_bwd_ms": loss_ms},
         last_pt_validation=last_val, fixed_batch_losses=fixed, card=gpu_line,
         phase_s=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="train",
                 launches=launches["batched_greedy_nms"])]


def cuda_event(torch):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def phase_train_transformer(torch, gpu_line, workdir):
    """skyeye_l_transformer at full width and depth, 640 px, batch 16: 3
    micro-steps without augmentation, K4 in every forward."""
    import torch.nn.functional as F
    from pathlib import Path

    from skyeye_tpu_torch.config import DEFAULT_HYP
    from skyeye_tpu_torch.losses import ComputeLoss
    from skyeye_tpu_torch.models import attention as port_attention
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.ops import attention_kernel
    from skyeye_tpu_torch.tools.train_grad_noise import error_summary, grad_errors, loss_and_grads
    from skyeye_tpu_torch.train import RuntimeOptimizer, create_train_state, make_train_step

    t_phase = time.perf_counter()
    data = {"path": str(Path(workdir)), "train": "images/val"}
    batch, _ = first_batch(torch, data, TRAIN_IMG)
    model = create_detector("skyeye_l_transformer", num_classes=len(DRONE_NAMES),
                            device="cuda", seed=0)
    loss_fn = ComputeLoss(model.config.anchors, model.config.nc)
    x = batch["images"].float() / 255.0

    # -- the first micro-step's loss and gradients with K4, and with
    # attention_reference put in (the same dropout masks: one generator seed)
    real_flash, k4_inputs = port_attention.flash_attention, []

    def record_flash(q, k, v):
        k4_inputs[:] = [(q.detach(), k.detach(), v.detach())]
        return real_flash(q, k, v)

    attention_kernel.reset_launch_counts()
    with mock.patch.object(port_attention, "flash_attention", record_flash):
        l_k4, _, g_k4 = loss_and_grads(model, loss_fn, x, batch["targets"],
                                       batch["mask"])
    if attention_kernel.LAUNCHES["flash_attention"] != 1:
        fail(f"the transformer's train forward launched K4 "
             f"{attention_kernel.LAUNCHES['flash_attention']} times, not once")
    with mock.patch.object(port_attention, "flash_attention",
                           attention_kernel.attention_reference):
        l_ref, _, g_ref = loss_and_grads(model, loss_fn, x, batch["targets"],
                                         batch["mask"])
    errs = grad_errors(g_k4, g_ref)
    worst = max(errs, key=errs.get)
    if abs(l_k4 - l_ref) > 1e-5 * abs(l_ref) or errs[worst] > K4_TRAIN_GRAD_REL:
        fail(f"K4 against attention_reference in a train step: loss {l_k4} vs {l_ref}; "
             f"worst gradients {error_summary(errs)['worst']} of max|g|")
    del g_k4, g_ref

    # -- 3 micro-steps through the train step (accumulate 4: the parameters stay)
    opt = RuntimeOptimizer(model, DEFAULT_HYP, batch_size=TRAIN_BATCH)
    step = make_train_step(model, loss_fn, opt)
    state = create_train_state(model, opt)
    attention_kernel.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(3):
        start = cuda_event(torch)
        _, m = step(state, dict(batch, opt_hyperparams={"lr": 0.0, "bias_lr": 0.0,
                                                        "momentum": 0.937}))
        end = cuda_event(torch)
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    launches = dict(attention_kernel.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches["flash_attention"] != 3 or not np.isfinite(losses).all():
        fail(f"3 transformer micro-steps: K4 launched {launches['flash_attention']} times, "
             f"losses {losses}")
    del state, step, opt

    # -- K4 timed on the input the step gave it
    q, k, v = (t.contiguous() for t in k4_inputs[0])
    b, n, hd = q.shape
    out = attention_kernel.flash_attention(q, k, v)
    ref = attention_kernel.attention_reference(q, k, v)
    ops = TF32_PRODUCTS_PER_F32 * 4.0 * b * n * n * hd
    t_bytes, t_ops = 4 * q.numel() * 4 / PEAK_BYTES_S * 1e3, ops / PEAK_TF32_OPS_S * 1e3
    k4 = dict(shape=[b, n, hd], max_abs_err=float((out - ref).abs().max()),
              ms=cuda_ms(lambda: attention_kernel.flash_attention(q, k, v), 20),
              plain_ms=cuda_ms(lambda: attention_kernel.flash_attention_plain(q, k, v), 5),
              bound_ms=max(t_bytes, t_ops),
              bound_by="bytes" if t_bytes >= t_ops else "operations",
              library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20))
    del q, k, v, out, ref, k4_inputs[:], model, batch, x
    emit("train_transformer", model="skyeye_l_transformer", nc=len(DRONE_NAMES),
         img_size=TRAIN_IMG, batch=TRAIN_BATCH, dtype="float32", tf32=False,
         device_aug=False, micro_steps=3, losses=losses, step_ms=times,
         peak_memory_gib=peak_gib, launches=launches,
         k4_vs_reference={"loss": [l_k4, l_ref], **error_summary(errs)},
         k4=k4, card=gpu_line, phase_s=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return [dict(name="flash_attention", path="train_transformer",
                 launches=launches["flash_attention"])]


# train_host_aug: 3 batches an epoch over validate's 48 frames; one epoch (it ran
# two before the multi-device phases took that time, within half the 1200 s limit)
HOST_AUG_EPOCHS = 1
HOST_AUG_WORKERS = 4  # cli.train's default
# remat levels against no remat on one micro-step, of each gradient's max|g|
# (bitwise equal on one H100, cuDNN deterministic)
REMAT_GRAD_REL = 1e-6
REMAT_1280_IMG = 1280  # where remat matters; it fits without too (68.70 GiB)


def loader_split_ms(ds, items):
    """One thread's host ms a frame of the augmented loader, by part: decode and
    resize of the mosaic's frames, the canvas (the rest of the item: labels,
    flips), the warp and HSV."""
    from skyeye_tpu_torch.data import dataset as port_dataset

    parts = {"decode_resize": 0.0, "warp": 0.0, "hsv": 0.0}

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            parts[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    draws = [ds.draw(i) for i in items]
    t0 = time.perf_counter()
    with mock.patch.object(ds, "_load_image_raw", timed("decode_resize", ds._load_image_raw)), \
            mock.patch.object(port_dataset, "warp_with_matrix",
                              timed("warp", port_dataset.warp_with_matrix)), \
            mock.patch.object(port_dataset, "apply_hsv", timed("hsv", port_dataset.apply_hsv)):
        for d in draws:
            ds.render(d)
    total = (time.perf_counter() - t0) * 1e3
    out = {k: v / len(items) for k, v in parts.items()}
    out["mosaic"] = total / len(items) - sum(out.values())
    out["total"] = total / len(items)
    return out


def phase_train_host_aug(torch, gpu_line, workdir):
    """``cli.train`` as JAX trains by default: the loader augments on the host
    (mosaic, warp, HSV, flips), skyeye_s at full width, 640 px, batch 16."""
    from pathlib import Path

    from skyeye_tpu_torch.cli import train as port_train
    from skyeye_tpu_torch.cli import validate as port_validate
    from skyeye_tpu_torch.config import DEFAULT_HYP
    from skyeye_tpu_torch.data.dataset import AerialDataset, create_dataloader
    from skyeye_tpu_torch.losses import ComputeLoss
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.train import RuntimeOptimizer, create_train_state, make_train_step
    from skyeye_tpu_torch.utils.checkpoint import load_torch_checkpoint

    t_phase = time.perf_counter()
    root = Path(workdir)
    weights = root / "skyeye_s.pt"
    data = {"path": str(root), "train": "images/val", "val": "images/val",
            "nc": len(DRONE_NAMES), "names": DRONE_NAMES}
    split = str(root / "images" / "val")

    # -- the loader's ms a frame on one thread, by part (no other loader running)
    ds = AerialDataset(split, img_size=TRAIN_IMG, batch_size=TRAIN_BATCH, augment=True,
                       hyp=DEFAULT_HYP, seed=0)
    split_ms = loader_split_ms(ds, list(range(0, len(ds), 4)))

    # -- the loader's first batch at 1 and at 4 workers: byte for byte the same
    first, loader_s = {}, {}
    for workers in (1, HOST_AUG_WORKERS):
        loader, _ = create_dataloader(split, img_size=TRAIN_IMG, batch_size=TRAIN_BATCH,
                                      stride=32, augment=True, hyp=DEFAULT_HYP,
                                      workers=workers, seed=0, shuffle=True)
        t0 = time.perf_counter()
        batches = iter(loader)
        first[workers] = next(batches)
        loader_s[workers] = time.perf_counter() - t0
        batches.close()  # the producer stops: only the items already running finish
    for key in ("images", "targets", "mask", "indices"):
        if not np.array_equal(first[1][key], first[HOST_AUG_WORKERS][key]):
            fail(f"the augmented loader's first batch differs in {key} between 1 and "
                 f"{HOST_AUG_WORKERS} workers")

    # -- the run
    nms_kernel.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps, vals, k1_inputs = train_run(torch, port_train, port_validate, lambda: port_train.train(
        cfg="skyeye_s", data=data, epochs=HOST_AUG_EPOCHS, batch_size=TRAIN_BATCH,
        img_size=TRAIN_IMG, weights=str(weights), workers=HOST_AUG_WORKERS,
        project=str(root / "runs_host_aug"), name="exp", seed=0, device="cuda"))
    train_s = time.perf_counter() - t0
    launches = dict(nms_kernel.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches["batched_greedy_nms"] == 0:
        fail("host-augmented training's validation never launched batched_greedy_nms")
    kept = hold_k1(torch, nms_kernel, k1_inputs, "train_host_aug")
    boxes, scores, iou, md = k1_inputs[0]
    k1 = dict(shape=list(scores.shape),
              ms=cuda_ms(lambda: nms_kernel.batched_greedy_nms(boxes, scores, iou, md), 30))
    del boxes, scores, k1_inputs

    n_micro = HOST_AUG_EPOCHS * 3
    losses = [float(v) for _, v in steps]
    if len(steps) != n_micro or not all(np.isfinite(losses)):
        fail(f"host-augmented training ran {len(steps)} micro-steps (want {n_micro}), "
             f"losses {losses}")
    run_dir = root / "runs_host_aug" / "exp"
    with open(run_dir / "results.csv") as f:
        rows = [r.strip().split(",") for r in f.readlines()[1:]]
    if len(rows) != HOST_AUG_EPOCHS or not all(np.isfinite([float(v) for v in r]).all()
                                               for r in rows):
        fail(f"results.csv rows: {rows}")
    epoch_s, images_s = [], []
    for e in range(HOST_AUG_EPOCHS):
        start = steps[3 * e][0]
        epoch_s.append({"train": vals[e][0] - start, "with_validation": vals[e][1] - start})
        images_s.append(3 * TRAIN_BATCH / (vals[e][0] - start))
    last = run_dir / "weights" / "last.pt"
    (mp, mr, map50, map_, *_), _, _ = port_validate.validate(
        data, weights=str(last), batch_size=TRAIN_BATCH, img_size=TRAIN_IMG,
        project=str(root / "runs_val_host_aug"), plots=False, device="cuda")
    last_val = {"validate": [mp, mr, map50, map_], "results_csv": [float(v) for v in rows[-1][4:8]]}
    if not np.allclose(last_val["validate"], last_val["results_csv"], rtol=1e-3, atol=0):
        fail(f"last.pt validates to {last_val['validate']}, its epoch's row says "
             f"{last_val['results_csv']}")

    # -- the card's micro-step on the first host-augmented batch, split as train splits it
    model = create_detector("skyeye_s", num_classes=len(DRONE_NAMES), device="cuda")
    model.load_state_dict(load_torch_checkpoint(weights)[0], strict=True)
    opt = RuntimeOptimizer(model, DEFAULT_HYP, batch_size=TRAIN_BATCH)
    marks = []
    step = make_train_step(model, ComputeLoss(model.config.anchors, model.config.nc), opt,
                           on_stage=lambda name: marks.append((name, cuda_event(torch))))
    state = create_train_state(model, opt)
    batch = {k: torch.from_numpy(np.asarray(first[1][k])).cuda()
             for k in ("images", "targets", "mask")}
    split = []
    for i in range(6):
        marks.clear()
        marks.append(("start", cuda_event(torch)))
        _, m = step(state, dict(batch, n_valid=TRAIN_BATCH,
                                opt_hyperparams={"lr": 0.0, "bias_lr": 0.0, "momentum": 0.937}))
        torch.cuda.synchronize()
        if i == 0 and abs(float(m["loss"]) - losses[0]) > 1e-6 * abs(losses[0]):
            fail(f"the first batch's micro-step gives loss {float(m['loss'])}, the run "
                 f"gave {losses[0]}")
        if i:
            split.append({n: marks[j - 1][1].elapsed_time(marks[j][1])
                          for j, (n, _) in enumerate(marks) if j})
    step_split = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    del state, step, opt, model, batch
    emit("train_host_aug", model="skyeye_s", nc=len(DRONE_NAMES), img_size=TRAIN_IMG,
         batch=TRAIN_BATCH, epochs=HOST_AUG_EPOCHS, workers=HOST_AUG_WORKERS,
         frames=len(ds), dtype="float32", tf32=False, device_aug=False, hyp="DEFAULT_HYP",
         first_batch_equal_at_workers=[1, HOST_AUG_WORKERS],
         first_batch_s={str(k): v for k, v in loader_s.items()},
         micro_step_losses=losses, results_csv=rows, train_s=train_s, epoch_s=epoch_s,
         images_per_s=images_s, loader_ms_per_frame_one_thread=split_ms,
         step_split_ms=step_split, device_ms_per_frame=sum(step_split.values()) / TRAIN_BATCH,
         peak_memory_gib=peak_gib, launches=launches,
         k1_inputs={"count": len(kept), "shapes": sorted({tuple(k["shape"]) for k in kept})},
         k1_timed=k1, last_pt_validation=last_val, card=gpu_line,
         phase_s=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="train_host_aug",
                 launches=launches["batched_greedy_nms"])]


def remat_micro_step(torch, attention_kernel, level, x, targets, mask, timed_runs=2):
    """Micro-steps of skyeye_l_transformer at ``level`` from the seed-0 weights:
    the first one's loss, gradients, buffers, K4 launches, ms and peak GiB, and
    the median ms of ``timed_runs`` more."""
    from skyeye_tpu_torch.losses import ComputeLoss
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.tools.train_grad_noise import loss_and_grads

    model = create_detector("skyeye_l_transformer", num_classes=len(DRONE_NAMES),
                            device="cuda", seed=0, remat=level)
    loss_fn = ComputeLoss(model.config.anchors, model.config.nc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention_kernel.reset_launch_counts()
    start = cuda_event(torch)
    loss, _, grads = loss_and_grads(model, loss_fn, x, targets, mask)
    end = cuda_event(torch)
    end.synchronize()
    out = dict(loss=loss, grads=grads,
               buffers={k: v.clone() for k, v in model.named_buffers()},
               k4=attention_kernel.LAUNCHES["flash_attention"], first_ms=start.elapsed_time(end),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    times = []
    for _ in range(timed_runs):
        start = cuda_event(torch)
        loss_and_grads(model, loss_fn, x, targets, mask)
        end = cuda_event(torch)
        end.synchronize()
        times.append(start.elapsed_time(end))
    out["ms"] = float(np.median(times)) if times else out["first_ms"]
    del model
    return out


def remat_against_none(torch, runs, ref, levels):
    """Each level's first micro-step against ``ref`` (no remat): bitwise, else the
    largest gap over max|g| of a gradient or a buffer, held under REMAT_GRAD_REL."""
    from skyeye_tpu_torch.tools.train_grad_noise import error_summary, grad_errors

    compared = {}
    for level in levels:
        r = runs[level]
        bitwise = (r["loss"] == ref["loss"]
                   and all(torch.equal(r["grads"][k], g) for k, g in ref["grads"].items())
                   and all(torch.equal(r["buffers"][k], b) for k, b in ref["buffers"].items()))
        errs = grad_errors(r["grads"], ref["grads"])
        buf_errs = grad_errors(r["buffers"], {k: v.double() for k, v in ref["buffers"].items()})
        compared[level] = {"bitwise_equal": bitwise, "loss": [r["loss"], ref["loss"]],
                           "grad_gap_of_max": error_summary(errs),
                           "buffer_gap_of_max": max(buf_errs.values())}
        worst = max(max(errs.values()), max(buf_errs.values()))
        if abs(r["loss"] - ref["loss"]) > REMAT_GRAD_REL * abs(ref["loss"]) or \
                worst > REMAT_GRAD_REL:
            fail(f"remat {level!r} against none: loss {r['loss']} vs {ref['loss']}, worst "
                 f"gradient or buffer gap {worst} of max (limit {REMAT_GRAD_REL})")
    return compared


def phase_train_remat(torch, gpu_line, workdir):
    """skyeye_l_transformer at full width and depth, batch 16: one micro-step
    from the same weights and batch at remat "", "block" and "stage" at 640 px,
    then "" and "stage" at 1280 px (which fits without remat: 68.70 GiB,
    ``tools/remat_memory.py``), each then timed over 2 more."""
    from pathlib import Path

    from skyeye_tpu_torch.ops import attention_kernel

    t_phase = time.perf_counter()
    data = {"path": str(Path(workdir)), "train": "images/val"}
    results, k4_launches = {}, {}
    for img, levels in ((TRAIN_IMG, ("", "block", "stage", "again")),
                        (REMAT_1280_IMG, ("", "stage"))):
        batch, _ = first_batch(torch, data, img)
        x = batch["images"].float() / 255.0
        runs = {}
        for level in levels:  # "again": no remat a second time, the card's own spread
            runs[level] = remat_micro_step(torch, attention_kernel,
                                           "" if level == "again" else level, x,
                                           batch["targets"], batch["mask"])
            k4_launches[f"{img}:{level or 'none'}"] = runs[level]["k4"]
            torch.cuda.empty_cache()
        results[img] = {
            "levels": {lv or "none": {k: runs[lv][k] for k in ("ms", "first_ms", "peak_gib")}
                       for lv in levels if lv != "again"},
            "against_no_remat": remat_against_none(torch, runs, runs[""], levels[1:])}
        del runs, batch, x
        torch.cuda.empty_cache()
    if any(n != 1 for n in k4_launches.values()):
        fail(f"K4 launches per forward by level: {k4_launches} (want 1 each)")
    emit("train_remat", model="skyeye_l_transformer", nc=len(DRONE_NAMES), batch=TRAIN_BATCH,
         dtype="float32", tf32=False, by_img_size=results,
         k4_launches_per_forward=k4_launches, card=gpu_line,
         phase_s=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return [dict(name="flash_attention", path="train_remat",
                 launches=sum(k4_launches.values()))]


def phase_evolve(torch, gpu_line, workdir):
    """``cli.train(evolve=2, epochs=1)`` on skyeye_s as in train_host_aug."""
    from pathlib import Path

    from skyeye_tpu_torch.cli import train as port_train
    from skyeye_tpu_torch.cli import validate as port_validate
    from skyeye_tpu_torch.config import DEFAULT_HYP, load_hyp
    from skyeye_tpu_torch.ops import nms_kernel
    from skyeye_tpu_torch.train.evolve import EVOLVE_META, load_evolve_results, mutate_hyp

    t_phase = time.perf_counter()
    root = Path(workdir)
    data = {"path": str(root), "train": "images/val", "val": "images/val",
            "nc": len(DRONE_NAMES), "names": DRONE_NAMES}
    nms_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    steps, vals, k1_inputs = train_run(torch, port_train, port_validate, lambda: port_train.train(
        cfg="skyeye_s", data=data, epochs=1, batch_size=TRAIN_BATCH, img_size=TRAIN_IMG,
        weights=str(root / "skyeye_s.pt"), workers=HOST_AUG_WORKERS,
        project=str(root / "runs_evolve"), seed=0, device="cuda", evolve=2))
    evolve_s = time.perf_counter() - t0
    launches = dict(nms_kernel.LAUNCHES)
    if launches["batched_greedy_nms"] == 0:
        fail("evolve's validations never launched batched_greedy_nms")
    hold_k1(torch, nms_kernel, k1_inputs, "evolve")
    del k1_inputs
    evolve_dir = root / "runs_evolve" / "evolve"
    header, rows = load_evolve_results(evolve_dir / "evolve.csv")
    keys = [k for k in EVOLVE_META if k in DEFAULT_HYP]
    if header != ["fitness"] + keys or len(rows) != 2:
        fail(f"evolve.csv: header {header}, {len(rows)} rows (want 2)")
    if rows[0][1:] != [DEFAULT_HYP[k] for k in keys]:
        fail("generation 1 did not train the base hyp")
    gen2 = mutate_hyp(dict(DEFAULT_HYP), np.random.default_rng(0))
    if rows[1][1:] != [gen2[k] for k in keys]:
        fail(f"generation 2's hyp {rows[1][1:]} is not mutate_hyp from the seed's generator")
    best = max(rows, key=lambda r: r[0])
    evolved = load_hyp(evolve_dir / "hyp_evolved.yaml")
    if [evolved[k] for k in keys] != best[1:]:
        fail("hyp_evolved.yaml does not read back to the best row's hyp")
    if len(steps) != 6 or not all(np.isfinite([float(v) for _, v in steps])):
        fail(f"evolve ran {len(steps)} micro-steps (want 6)")
    emit("evolve", model="skyeye_s", nc=len(DRONE_NAMES), img_size=TRAIN_IMG,
         batch=TRAIN_BATCH, generations=2, epochs=1, workers=HOST_AUG_WORKERS,
         fitness=[r[0] for r in rows], gen2_mutated={k: gen2[k] for k in keys
                                                     if gen2[k] != DEFAULT_HYP[k]},
         evolve_s=evolve_s, generation_s=[vals[g][1] - steps[3 * g][0] for g in range(2)],
         launches=launches, card=gpu_line, phase_s=time.perf_counter() - t_phase)
    return [dict(name="batched_greedy_nms", path="evolve",
                 launches=launches["batched_greedy_nms"])]


# -- multi-device: data-parallel training and serving split over replicas ------------

MULTI_WORLD = 2
MULTI_MICRO_STEPS, MULTI_ACCUMULATE = 3, 2  # the second micro-step updates the parameters
MULTI_LOSS_REL, MULTI_LOSS_AFTER_UPDATE_REL = 1e-5, 1e-3
MULTI_STATS_AFTER_UPDATE_REL = 1e-2
MULTI_PARAMS_AFTER_UPDATE_REL = 2 * GRAD_VS_FLOAT64_REL
# tests/test_torch_port_train_step.py's allowances: 1e-4 x max|w| + 1e-3 x max|change|
MULTI_STATE_REL, MULTI_CHANGE_REL = 1e-4, 1e-3
MULTI_TIMEOUT_S = 300  # a collective that waits longer raises
MULTI_TRANSFORMER_BATCH = 4
# serve_mesh against the unmeshed detector's whole batch: boxes (px) and scores to
# the rounding of convolutions over a share of the batch (on the card 1.2e-4 px
# and 6e-8; the CPU tests see 7.6e-6 px and 6e-8 at a share of 2 against 3)
MESH_BOX_ATOL, MESH_SCORE_ATOL = 1e-3, 1e-5


def _no_tf32(torch):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _multi_data(workdir):
    return {"path": workdir, "train": "images/val", "val": "images/val",
            "nc": len(DRONE_NAMES), "names": DRONE_NAMES}


def _multi_batch(torch, data, rank, world, dev, img=TRAIN_IMG, batch_size=TRAIN_BATCH):
    """This rank's share of the loader's first global batch (letterboxed, as with
    device augmentation), on its card."""
    from skyeye_tpu_torch.data.dataset import create_dataloader

    loader, _ = create_dataloader(data["path"] + "/" + data["train"], img_size=img,
                                  batch_size=batch_size, stride=32, augment=False, workers=4,
                                  seed=0, shuffle=True, rank=rank, world=world)
    b = next(iter(loader))
    return {k: torch.from_numpy(np.asarray(b[k])).to(dev) for k in ("images", "targets", "mask")}


class _CollectiveCount:
    """Calls of the process-group collectives while it is entered, and the
    forward calls of the spatial exchanges (each runs one collective forward and
    one in the backward)."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
             "broadcast")

    def __init__(self, dist):
        self.dist, self.calls, self.patches = dist, {}, []

    def _count(self, target, attr, label):
        real = getattr(target, attr)

        def counted(*a, _real=real, **k):
            self.calls[label] = self.calls.get(label, 0) + 1
            return _real(*a, **k)
        self.patches.append(mock.patch.object(target, attr, counted))
        self.patches[-1].start()

    def __enter__(self):
        from skyeye_tpu_torch.parallel import spatial

        for name in self.NAMES:
            self._count(self.dist, name, name)
        for label, fn in (("halo_exchange", spatial._Halo), ("gather_spatial", spatial._Gather),
                          ("split_spatial", spatial._Split), ("spatial_sum", spatial._Sum),
                          ("spatial_max", spatial._Max)):
            self._count(fn, "apply", label)
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()


def _multi_steps(torch, spec, mesh, batch, fsdp=False, timed_extra=0, float64=False,
                 profile=False, batch_size=TRAIN_BATCH):
    """The micro-steps from the smoke's skyeye_s weights on ``batch`` (this rank's
    share): losses, each micro-step's ms (CUDA events), the collectives of one
    micro-step (and, with ``profile``, NCCL's device ms in it), and the state
    after the first micro-step (before any update) and after
    ``MULTI_MICRO_STEPS`` (one update in). ``float64``: the model in float64
    (the reference the float32 runs are read against)."""
    import torch.distributed as dist

    from skyeye_tpu_torch.config import DEFAULT_HYP
    from skyeye_tpu_torch.data.device_aug import augment_batch_device
    from skyeye_tpu_torch.losses import ComputeLoss
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.parallel import jit_fsdp_step, shard_train_state
    from skyeye_tpu_torch.parallel.fsdp import full_tensors
    from skyeye_tpu_torch.train import (
        RuntimeOptimizer, create_train_state, make_train_step, step_generator,
    )
    from skyeye_tpu_torch.utils.checkpoint import load_torch_checkpoint

    from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule

    dev = batch["images"].device
    model = create_detector("skyeye_s", num_classes=len(DRONE_NAMES), device=dev)
    model.load_state_dict(load_torch_checkpoint(spec["weights"])[0], strict=True)
    if float64:
        m64 = SkyEyeDetectorModule(model.config, dtype=torch.float64)
        m64.load_state_dict(model.state_dict(), strict=True)
        model = m64.double().to(dev)
    opt = RuntimeOptimizer(model, DEFAULT_HYP, batch_size=batch_size,
                           accumulate=MULTI_ACCUMULATE)
    state = create_train_state(model, opt)
    step = make_train_step(model, ComputeLoss(model.config.anchors, model.config.nc), opt,
                           device_augment=lambda im, t, m, g, **k: augment_batch_device(
                               im, t, m, g, hyp=DEFAULT_HYP, **k), mesh=mesh)
    if fsdp:
        shard_train_state(mesh, state)
        step = jit_fsdp_step(step, mesh, state)
    hp = {"lr": 0.01, "bias_lr": 0.01, "momentum": 0.937}
    losses, ms, collectives, tensors = [], [], {}, {}
    for i in range(MULTI_MICRO_STEPS + timed_extra):
        b = dict(batch, aug_generator=step_generator(0, i, dev), n_valid=batch_size,
                 opt_hyperparams=hp)
        if i == 1 and mesh is not None:
            with _CollectiveCount(dist) as count:
                if profile:
                    nccl_ms, m = _collective_ms(torch, lambda: step(state, b)[1])
                else:
                    start = cuda_event(torch)
                    _, m = step(state, b)
            collectives = count.calls
        else:
            start = cuda_event(torch)
            _, m = step(state, b)
        end = cuda_event(torch)
        torch.cuda.synchronize()
        if not (i == 1 and profile and mesh is not None):  # the profiled step is not timed
            ms.append(start.elapsed_time(end))
        if i < MULTI_MICRO_STEPS:
            losses.append(float(m["loss"]))
        if i in (0, MULTI_MICRO_STEPS - 1):
            snap = {k: v.detach().double().cpu().clone() for k, v in
                    full_tensors(state.model.state_dict()).items()
                    if not k.endswith("num_batches_tracked")}
            snap.update({f"ema:{k}": v.detach().double().cpu().clone()
                         for k, v in full_tensors(state.ema.params).items()})
            tensors["first" if i == 0 else "last"] = snap
    out = {"losses": losses, "ms": ms, "collectives": collectives}
    if profile and mesh is not None:
        out["nccl_device_ms"] = nccl_ms
    return out, tensors


def _ranks_equal(torch, tensors, dev, group):
    """Whether every rank holds rank 0's tensors bit for bit (one broadcast)."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for snap in tensors.values()
                      for t in snap.values()]).to(dev)
    theirs = flat.clone()
    dist.broadcast(theirs, src=0, group=group)
    same = torch.tensor([1.0 if torch.equal(theirs, flat) else 0.0], device=dev)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=group)
    return bool(same.item())


def _collective_ms(torch, run):
    """(device ms in NCCL kernels during ``run()`` by torch.profiler, or None where
    the profiler saw no device time; ``run()``'s result)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sum(getattr(e, "device_time_total", 0.0) for e in events)
    if device <= 0:
        return None, result
    return sum(getattr(e, "device_time_total", 0.0) for e in events
               if "nccl" in e.key.lower()) / 1e3, result


def multi_worker(spec):
    """One rank of ``train_multi`` (a) or (b) and (c): the data-parallel and FSDP
    micro-steps (and, with ``spec["plain"]``, the plain and float64 steps and the
    transformer's data-parallel step; with ``spec["cli"]``, then ``cli.train``
    on those keyword arguments, K1's launches in this process counted around
    it); rank 0 saves each state under ``spec["out"]``."""
    import torch
    import torch.distributed as dist

    from skyeye_tpu_torch.parallel import create_mesh

    _no_tf32(torch)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = create_mesh(devices=[dev])
    data = _multi_data(spec["workdir"])
    batch = _multi_batch(torch, data, mesh.rank, mesh.size, dev)
    out, tag = {"backend": dist.get_backend(), "world": mesh.size}, spec["tag"]
    runs = [("dp", dict(mesh=mesh, profile=spec["plain"])), ("fsdp", dict(mesh=mesh, fsdp=True))]
    if spec["plain"]:
        full = _multi_batch(torch, data, 0, 1, dev)
        runs[:0] = [("plain", dict(mesh=None, batch=full)),
                    ("plain64", dict(mesh=None, batch=full, float64=True))]
    for name, kw in runs:
        kw.setdefault("batch", batch)
        extra = 2 if spec["plain"] and name != "plain64" else 0
        res, tensors = _multi_steps(torch, spec, timed_extra=extra, **kw)
        if mesh.size > 1:
            res["ranks_bitwise_equal"] = _ranks_equal(torch, tensors, dev, mesh.group)
        if mesh.rank == 0:
            torch.save(tensors, f"{spec['out']}/{tag}_{name}.pt")
        out[name] = res
        del tensors
        torch.cuda.empty_cache()
    if spec["plain"]:
        out["transformer"] = _multi_transformer(torch, mesh, batch)
    if spec.get("cli"):
        from skyeye_tpu_torch.cli.train import train
        from skyeye_tpu_torch.ops import nms_kernel

        del batch
        torch.cuda.empty_cache()
        nms_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        results, save_dir = train(**spec["cli"])
        out["cli"] = {"results": list(results), "save_dir": str(save_dir),
                      "launches": dict(nms_kernel.LAUNCHES), "s": time.perf_counter() - t0}
    return out


def _multi_transformer(torch, mesh, batch):
    """skyeye_l_transformer's data-parallel micro-step (K4 in its forward) against
    its plain step, from the seed-0 weights, on the batch's first frames."""
    from skyeye_tpu_torch.config import DEFAULT_HYP
    from skyeye_tpu_torch.losses import ComputeLoss
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.ops import attention_kernel
    from skyeye_tpu_torch.train import RuntimeOptimizer, create_train_state, make_train_step

    b = {k: v[:MULTI_TRANSFORMER_BATCH] for k, v in batch.items()}
    b["opt_hyperparams"] = {"lr": 0.0, "bias_lr": 0.0, "momentum": 0.937}
    out = {}
    model = create_detector("skyeye_l_transformer", num_classes=len(DRONE_NAMES),
                            device=batch["images"].device, seed=0)
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    for name, m in (("plain", None), ("dp", mesh)):
        model.load_state_dict(seeded, strict=True)  # the BatchNorm statistics too
        opt = RuntimeOptimizer(model, DEFAULT_HYP, batch_size=64)
        step = make_train_step(model, ComputeLoss(model.config.anchors, model.config.nc), opt,
                               mesh=m)
        attention_kernel.reset_launch_counts()
        _, metrics = step(create_train_state(model, opt), dict(b))
        torch.cuda.synchronize()
        out[name] = {"loss": float(metrics["loss"]),
                     "k4_launches": attention_kernel.LAUNCHES["flash_attention"]}
        del opt, step
    del model, seeded
    torch.cuda.empty_cache()
    return out


def _allowance(w, start, change_rel):
    return MULTI_STATE_REL * float(w.abs().max()) + change_rel * float((w - start).abs().max())


def _is_stat(k: str) -> bool:
    return k.endswith(("running_mean", "running_var"))


def _worst(excess):
    k = max(excess, key=excess.get)
    return excess[k], k


def _gates(got, ref, f64, start):
    """``got`` (losses, states) of a data-parallel or FSDP run against ``ref``
    (the plain step's, or world 1's data-parallel run's) on the same micro-steps.

    Before the update (micro-steps 1-2, the state after micro-step 1): losses
    within 1e-5 relative, every tensor within 1e-4 max|w| + 1e-3 max|change|
    (tests/test_torch_port_train_step.py's allowances). After it (micro-step 3,
    one update in): that file's after-update allowances, the loss within 1e-3
    and the BatchNorm statistics within 1e-4 max|w| + 1e-2 max|change|; the
    parameters and the EMA within 1e-4 max|w| + 2 x GRAD_VS_FLOAT64_REL x
    max|change|: on this batch (the smoke's first, its first draws) a float32
    gradient lies up to GRAD_VS_FLOAT64_REL of max|g| from float64 (SPP's
    max-pool winners), so two float32 updates may part by twice that
    share of their change, more than 1e-3 of it. Each run's distance from the
    float64 step, in 1e-4 max|w| + 1e-3 max|change|, is reported beside."""
    (losses, states), (ref_losses, ref_states) = got, ref
    first, last, to64 = {}, {}, {}
    for k, w in ref_states["first"].items():
        first[k] = float((states["first"][k] - w).abs().max()) / max(
            _allowance(w, start[k.split(":", 1)[-1]], MULTI_CHANGE_REL), 1e-30)
    for k, w in ref_states["last"].items():
        s0 = start[k.split(":", 1)[-1]]
        rel = MULTI_STATS_AFTER_UPDATE_REL if _is_stat(k) else MULTI_PARAMS_AFTER_UPDATE_REL
        last[k] = float((states["last"][k] - w).abs().max()) / max(_allowance(w, s0, rel), 1e-30)
        if f64 is not None:
            w64 = f64["last"][k]
            to64[k] = float((states["last"][k] - w64).abs().max()) / max(
                _allowance(w64, s0, MULTI_CHANGE_REL), 1e-30)
    rel = [abs(x - y) / abs(y) for x, y in zip(losses, ref_losses)]
    out = {"loss_rel_before_update": max(rel[:2]), "loss_rel_after_update": rel[2],
           "state_before_update": _worst(first), "state_after_update": _worst(last)}
    if f64 is not None:
        out["from_float64_after_update"] = _worst(to64)
    return out


def _gates_fail(checks) -> bool:
    return (checks["loss_rel_before_update"] > MULTI_LOSS_REL
            or checks["loss_rel_after_update"] > MULTI_LOSS_AFTER_UPDATE_REL
            or checks["state_before_update"][0] > 1.0 or checks["state_after_update"][0] > 1.0)


def phase_train_multi(torch, gpu_line, workdir):
    """Data-parallel training (synced BatchNorm, the global batch's loss
    normalisers, summed gradients) and FSDP through the launcher: (a) world 1
    over NCCL against the plain step, (b) world 2 over gloo, two processes on
    the one card, against (a), then (c) ``cli.train`` at world 2 over gloo in
    the same two processes."""
    from pathlib import Path

    import torch.distributed  # noqa: F401

    from skyeye_tpu_torch.cli import validate as port_validate
    from skyeye_tpu_torch.parallel import launch
    from skyeye_tpu_torch.utils.checkpoint import load_torch_checkpoint

    t_phase = time.perf_counter()
    root = Path(workdir)
    out_dir = root / "train_multi"
    out_dir.mkdir(exist_ok=True)
    spec = {"workdir": str(root), "weights": str(root / "skyeye_s.pt"), "out": str(out_dir)}
    start = load_torch_checkpoint(spec["weights"])[0]

    # (a) world 1 over NCCL; (b) world 2 over gloo on the one card, whose workers
    # then run (c), cli.train at world 2 (rank 0 validates and writes)
    cli_kwargs = dict(cfg="skyeye_s", data=_multi_data(str(root)), epochs=1,
                      batch_size=TRAIN_BATCH, img_size=TRAIN_IMG, weights=spec["weights"],
                      device_aug=True, project=str(root / "runs_multi"), name="exp", seed=0,
                      device="cuda")
    t0 = time.perf_counter()
    a = launch(multi_worker, 1, kwargs={"spec": dict(spec, tag="a", plain=True)},
               backend="nccl", timeout_s=MULTI_TIMEOUT_S)[0]
    a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = launch(multi_worker, MULTI_WORLD,
               kwargs={"spec": dict(spec, tag="b", plain=False, cli=cli_kwargs)},
               backend="gloo", timeout_s=MULTI_TIMEOUT_S)
    bc_s = time.perf_counter() - t0
    start = {k: v.double() for k, v in start.items()}
    saved = {n: torch.load(out_dir / f"a_{n}.pt") for n in ("plain", "plain64", "dp")}
    checks = {}
    for tag, runs in (("a", [a]), ("b", b)):
        for name in ("dp", "fsdp"):
            res = runs[0][name]
            ref_name = "plain" if tag == "a" else "dp"
            got = (res["losses"], torch.load(out_dir / f"{tag}_{name}.pt"))
            c = _gates(got, (a[ref_name]["losses"], saved[ref_name]), saved["plain64"], start)
            checks[f"{tag}_{name}"] = dict(c, against=f"a_{ref_name}")
            if _gates_fail(c):
                fail(f"train_multi ({tag}) {name}: losses {res['losses']} against "
                     f"{a[ref_name]['losses']}; {c}")
            if tag == "b" and not all(r[name]["ranks_bitwise_equal"] for r in runs):
                fail(f"train_multi (b) {name}: the ranks' states differ")
            del got
    # the float32 step's own gap from float64 after the update, in 1e-4 max|w| +
    # 1e-3 max|change| (what the parameters' gate above grants on top)
    plain_gap = {
        "loss_rel": [abs(x - y) / abs(y) for x, y in zip(a["plain"]["losses"],
                                                          a["plain64"]["losses"])],
        "state_after_update": _worst({
            k: float((saved["plain"]["last"][k] - w).abs().max()) / max(
                _allowance(w, start[k.split(":", 1)[-1]], MULTI_CHANGE_REL), 1e-30)
            for k, w in saved["plain64"]["last"].items()})}
    del saved
    tr = a["transformer"]
    if tr["dp"]["k4_launches"] == 0 or abs(tr["dp"]["loss"] - tr["plain"]["loss"]) > \
            MULTI_LOSS_REL * abs(tr["plain"]["loss"]):
        fail(f"train_multi: skyeye_l_transformer's data-parallel step {tr}")

    # (c)
    c = [r["cli"] for r in b]
    save_dir = Path(c[0]["save_dir"])
    if c[1]["save_dir"] != c[0]["save_dir"] or c[1]["launches"]["batched_greedy_nms"] != 0:
        fail(f"train_multi (c): rank 1 ran in {c[1]['save_dir']} with launches "
             f"{c[1]['launches']}")
    k1_launches = c[0]["launches"]["batched_greedy_nms"]
    if k1_launches == 0:
        fail("train_multi (c): rank 0's validation never launched batched_greedy_nms")
    with open(save_dir / "results.csv") as f:
        rows = [r.strip().split(",") for r in f.readlines()[1:]]
    if len(rows) != 1 or not np.isfinite([float(v) for v in rows[0]]).all():
        fail(f"train_multi (c): results.csv rows {rows}")
    (mp, mr, map50, map_, *_), _, _ = port_validate.validate(
        _multi_data(str(root)), weights=str(save_dir / "weights" / "last.pt"),
        batch_size=TRAIN_BATCH, img_size=TRAIN_IMG, project=str(root / "runs_multi_val"),
        plots=False, device="cuda")
    last_val = {"validate": [mp, mr, map50, map_], "results_csv": [float(v) for v in rows[0][4:8]]}
    if not np.allclose(last_val["validate"], last_val["results_csv"], rtol=1e-3, atol=0):
        fail(f"train_multi (c): last.pt validates to {last_val['validate']}, its row says "
             f"{last_val['results_csv']}")

    a_ms = {k: a[k]["ms"] for k in ("plain", "dp", "fsdp")}
    checks["plain_against_float64"] = plain_gap
    emit("train_multi", model="skyeye_s", nc=len(DRONE_NAMES), img_size=TRAIN_IMG,
         batch=TRAIN_BATCH, accumulate=MULTI_ACCUMULATE, micro_steps=MULTI_MICRO_STEPS,
         dtype="float32", tf32=False, device_aug=True,
         world1_nccl={"backend": a["backend"], "losses": {k: a[k]["losses"] for k in
                                                         ("plain", "plain64", "dp", "fsdp")},
                      "micro_step_ms": a_ms,
                      "median_ms_last3": {k: float(np.median(v[-3:])) for k, v in a_ms.items()},
                      "collectives_per_micro_step": {k: a[k]["collectives"]
                                                     for k in ("dp", "fsdp")},
                      "nccl_device_ms_one_micro_step": a["dp"]["nccl_device_ms"],
                      "transformer": tr, "command_s": a_s},
         world2_gloo_one_card={"backend": b[0]["backend"],
                               "losses": {k: [r[k]["losses"] for r in b]
                                          for k in ("dp", "fsdp")},
                               "micro_step_ms": {k: [r[k]["ms"] for r in b]
                                                 for k in ("dp", "fsdp")},
                               "command_s_with_c": bc_s,
                               "note": "two processes share one card over gloo: "
                                       "no speed is measured"},
         checks=checks,
         cli_world2_gloo={"results_csv": rows, "last_pt_validation": last_val,
                          "k1_launches_rank0": k1_launches, "cli_train_s": c[0]["s"]},
         card=gpu_line, phase_s=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="train_multi", launches=k1_launches),
            dict(name="flash_attention", path="train_multi",
                 launches=tr["dp"]["k4_launches"])]


# -- spatial sharding: each frame's rows split over two ranks on the one card --------

SPATIAL_WORLD = 2  # (data 1, spatial 2): two processes on the one card over gloo
SPATIAL_IMG, SPATIAL_BATCH = 1280, 8  # full width; the one-process step and both ranks fit
SPATIAL_TRANSFORMER_IMG, SPATIAL_TRANSFORMER_BATCH = 640, 4  # P5: 20 x 20 tokens, K4's gate
# the float64 split against the float64 one-process step, in shares of the
# float32 allowances (``_gates``): float64 reordering sits near 1e-10 of them
SPATIAL_FLOAT64_SHARE = 1e-6


def _rows_of(batch, rank, n):
    """This spatial rank's image rows of a batch (the targets whole)."""
    h = batch["images"].shape[1] // n
    return dict(batch, images=batch["images"][:, rank * h:(rank + 1) * h].contiguous())


def _peak_steps(torch, **kw):
    """``_multi_steps`` with the card's peak allocation over it (bytes)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, tensors = _multi_steps(torch, **kw)
    torch.cuda.synchronize()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    return res, tensors


def _spatial_transformer(torch, mesh, batch):
    """skyeye_l_transformer's micro-step under the spatial mesh (K4 on the whole
    P5's gathered tokens in each rank) against its one-process step (rank 0),
    from the seed-0 weights, on the batch's first frames at 640 px."""
    from skyeye_tpu_torch.config import DEFAULT_HYP
    from skyeye_tpu_torch.losses import ComputeLoss
    from skyeye_tpu_torch.models.detector import create_detector
    from skyeye_tpu_torch.ops import attention_kernel
    from skyeye_tpu_torch.train import RuntimeOptimizer, create_train_state, make_train_step

    whole = {k: v[:SPATIAL_TRANSFORMER_BATCH] for k, v in batch.items()}
    whole["opt_hyperparams"] = {"lr": 0.0, "bias_lr": 0.0, "momentum": 0.937}
    model = create_detector("skyeye_l_transformer", num_classes=len(DRONE_NAMES),
                            device=batch["images"].device, seed=0)
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    runs = [("plain", None, whole)] if mesh.spatial_rank == 0 else []
    runs.append(("spatial", mesh, _rows_of(whole, mesh.spatial_rank, mesh.n_spatial)))
    out = {}
    for name, m, b in runs:
        model.load_state_dict(seeded, strict=True)  # the BatchNorm statistics too
        opt = RuntimeOptimizer(model, DEFAULT_HYP, batch_size=64)
        step = make_train_step(model, ComputeLoss(model.config.anchors, model.config.nc), opt,
                               mesh=m)
        attention_kernel.reset_launch_counts()
        _, metrics = step(create_train_state(model, opt), dict(b))
        torch.cuda.synchronize()
        out[name] = {"loss": float(metrics["loss"]),
                     "k4_launches": attention_kernel.LAUNCHES["flash_attention"]}
        del opt, step
    del model, seeded
    torch.cuda.empty_cache()
    return out


def spatial_worker(spec):
    """One rank of ``train_spatial``: rank 0 runs the one-process micro-steps on
    the whole frames, then both ranks the spatial micro-steps on their rows
    (peak memory, ms and exchanges each), on the Python path's batch; then the
    same pair in float64 on the native prep's batch; then the transformer's
    micro-step; rank 0 saves each state under ``spec["out"]``."""
    import torch
    import torch.distributed as dist

    from skyeye_tpu_torch.data import native
    from skyeye_tpu_torch.parallel import create_mesh

    _no_tf32(torch)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = create_mesh(1, SPATIAL_WORLD, devices=[dev])
    data = _multi_data(spec["workdir"])
    with mock.patch.object(native, "ENABLED", False):  # the batch the float32 gates were set on
        whole = _multi_batch(torch, data, 0, 1, dev, img=SPATIAL_IMG, batch_size=SPATIAL_BATCH)
    rank = mesh.spatial_rank
    out = {"backend": dist.get_backend(), "shape": dict(mesh.shape), "spatial_rank": rank}
    runs = [("plain", dict(mesh=None, batch=whole))] if rank == 0 else []
    runs.append(("spatial", dict(mesh=mesh, batch=_rows_of(whole, rank, SPATIAL_WORLD))))
    for name, kw in runs:
        res, tensors = _peak_steps(torch, spec=spec, batch_size=SPATIAL_BATCH, **kw)
        if name == "spatial":
            res["ranks_bitwise_equal"] = _ranks_equal(torch, tensors, dev, mesh.world_group)
        if rank == 0:
            torch.save(tensors, f"{spec['out']}/{name}.pt")
        out[name] = res
        del tensors
    del whole
    torch.cuda.empty_cache()
    # the native prep's batch (the --device-aug loader's): float64 on both sides,
    # and the one-process float32 step read against float64 (reported, no gate)
    whole = _multi_batch(torch, data, 0, 1, dev, img=SPATIAL_IMG, batch_size=SPATIAL_BATCH)
    runs = [("plain_native", None, whole, False), ("plain64", None, whole, True)] \
        if rank == 0 else []
    runs.append(("spatial64", mesh, _rows_of(whole, rank, SPATIAL_WORLD), True))
    for name, m, b, f64 in runs:
        res, tensors = _multi_steps(torch, spec=spec, mesh=m, batch=b, float64=f64,
                                    batch_size=SPATIAL_BATCH)
        if rank == 0:
            torch.save(tensors, f"{spec['out']}/{name}.pt")
        out[name] = res
        del tensors
    del whole, runs
    torch.cuda.empty_cache()
    small = _multi_batch(torch, data, 0, 1, dev, img=SPATIAL_TRANSFORMER_IMG,
                         batch_size=SPATIAL_TRANSFORMER_BATCH)
    out["transformer"] = _spatial_transformer(torch, mesh, small)
    del small
    torch.cuda.empty_cache()
    # cli.train --spatial-shards 2 in this group (rank 0 validates: K1)
    from skyeye_tpu_torch.cli.train import train
    from skyeye_tpu_torch.ops import nms_kernel

    nms_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    _, save_dir = train(**spec["cli"])
    out["cli"] = {"save_dir": str(save_dir), "launches": dict(nms_kernel.LAUNCHES),
                  "s": time.perf_counter() - t0}
    return out


def phase_train_spatial(torch, gpu_line, workdir):
    """Spatial sharding through the launcher: a (data 1, spatial 2) mesh of two
    processes on the one card over gloo. skyeye_s at 1280 px, batch 8, device
    augmentation, 3 micro-steps (the second updates), from the smoke's weights,
    each rank on its 640 rows of every frame, against the one-process step on
    the whole frames (rank 0, before): train_multi's gates (``_gates``) on the
    Python path's batch, where they were set; each rank's peak memory beside
    the one-process peak; ms and exchanges a micro-step (no speed is claimed:
    gloo goes through the host). On the native prep's batch the float32
    one-process step itself lies beyond those allowances from float64, so
    there the split is held against the one-process step in float64, within
    ``SPATIAL_FLOAT64_SHARE`` of the allowances and the losses within 1e-5
    (the float32 one-process step's distance from float64 there is reported). Then skyeye_l_transformer's
    micro-step at 640 px under the same mesh, K4 once a rank on the gathered P5
    tokens, its loss against its one-process step. Last, ``cli.train`` with
    ``spatial_shards=2`` in the same two processes (one epoch at 640 px, batch
    16; rank 0 validates, K1)."""
    from pathlib import Path

    from skyeye_tpu_torch.parallel import launch
    from skyeye_tpu_torch.utils.checkpoint import load_torch_checkpoint

    t_phase = time.perf_counter()
    root = Path(workdir)
    out_dir = root / "train_spatial"
    out_dir.mkdir(exist_ok=True)
    spec = {"workdir": str(root), "weights": str(root / "skyeye_s.pt"), "out": str(out_dir),
            "cli": dict(cfg="skyeye_s", data=_multi_data(str(root)), epochs=1,
                        batch_size=TRAIN_BATCH, img_size=TRAIN_IMG,
                        weights=str(root / "skyeye_s.pt"), device_aug=True, spatial_shards=SPATIAL_WORLD,
                        project=str(root / "runs_spatial"), name="exp", seed=0, device="cuda")}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(spatial_worker, SPATIAL_WORLD, kwargs={"spec": spec}, backend="gloo",
                   timeout_s=MULTI_TIMEOUT_S)
    command_s = time.perf_counter() - t0
    start = {k: v.double() for k, v in load_torch_checkpoint(spec["weights"])[0].items()}
    plain, spatial = (torch.load(out_dir / f"{n}.pt") for n in ("plain", "spatial"))
    # float32 against float32 (no float64 reference): the after-update allowance is train_multi's
    checks = _gates((ranks[0]["spatial"]["losses"], spatial), (ranks[0]["plain"]["losses"], plain),
                    None, start)
    del plain, spatial
    if _gates_fail(checks):
        fail(f"train_spatial: losses {ranks[0]['spatial']['losses']} against "
             f"{ranks[0]['plain']['losses']}; {checks}")
    if not all(r["spatial"]["ranks_bitwise_equal"] for r in ranks):
        fail("train_spatial: the ranks' states differ")
    plain, spatial, plain32 = (torch.load(out_dir / f"{n}.pt")
                               for n in ("plain64", "spatial64", "plain_native"))
    checks64 = _gates((ranks[0]["spatial64"]["losses"], spatial),
                      (ranks[0]["plain64"]["losses"], plain), None, start)
    float32_from_64 = _gates((ranks[0]["plain_native"]["losses"], plain32),
                             (ranks[0]["plain64"]["losses"], plain), None, start)
    del plain, spatial, plain32
    if (max(checks64["loss_rel_before_update"], checks64["loss_rel_after_update"]) > MULTI_LOSS_REL
            or max(checks64["state_before_update"][0], checks64["state_after_update"][0])
            > SPATIAL_FLOAT64_SHARE):
        fail(f"train_spatial: float64 on the native prep's batch: {checks64}")
    if any(r["backend"] != "gloo" or r["shape"] != {"data": 1, "spatial": SPATIAL_WORLD}
           for r in ranks):
        fail(f"train_spatial: the mesh {[(r['backend'], r['shape']) for r in ranks]}")
    peaks = {"one_process": ranks[0]["plain"]["peak_bytes"],
             "ranks": [r["spatial"]["peak_bytes"] for r in ranks]}
    tr = {"plain": ranks[0]["transformer"]["plain"],
          "spatial": [r["transformer"]["spatial"] for r in ranks]}
    k4 = sum(t["k4_launches"] for t in tr["spatial"])
    if any(t["k4_launches"] != 1 or abs(t["loss"] - tr["plain"]["loss"]) >
           MULTI_LOSS_REL * abs(tr["plain"]["loss"]) for t in tr["spatial"]):
        fail(f"train_spatial: skyeye_l_transformer's spatial step {tr}")
    c = [r["cli"] for r in ranks]
    save_dir = Path(c[0]["save_dir"])
    k1_launches = c[0]["launches"]["batched_greedy_nms"]
    if c[1]["save_dir"] != c[0]["save_dir"] or c[1]["launches"]["batched_greedy_nms"] != 0 \
            or k1_launches == 0:
        fail(f"train_spatial: cli.train ran in {[r['save_dir'] for r in c]} with launches "
             f"{[r['launches'] for r in c]}")
    with open(save_dir / "results.csv") as f:
        rows = [r.strip().split(",") for r in f.readlines()[1:]]
    if len(rows) != 1 or not np.isfinite([float(v) for v in rows[0]]).all():
        fail(f"train_spatial: cli.train's results.csv rows {rows}")
    gib = 1024 ** 3
    emit("train_spatial", model="skyeye_s", nc=len(DRONE_NAMES), img_size=SPATIAL_IMG,
         batch=SPATIAL_BATCH, accumulate=MULTI_ACCUMULATE, micro_steps=MULTI_MICRO_STEPS,
         dtype="float32", tf32=False, device_aug=True, mesh={"data": 1, "spatial": SPATIAL_WORLD},
         backend=ranks[0]["backend"],
         losses={"one_process": ranks[0]["plain"]["losses"],
                 "ranks": [r["spatial"]["losses"] for r in ranks]},
         peak_gib={"one_process": peaks["one_process"] / gib,
                   "ranks": [b / gib for b in peaks["ranks"]]},
         peak_rank_over_one_process=[b / peaks["one_process"] for b in peaks["ranks"]],
         micro_step_ms={"one_process": ranks[0]["plain"]["ms"],
                        "ranks": [r["spatial"]["ms"] for r in ranks]},
         calls_per_micro_step=[r["spatial"]["collectives"] for r in ranks],
         checks=checks, native_prep_batch_float64=dict(
             losses={"one_process": ranks[0]["plain64"]["losses"],
                     "ranks": [r["spatial64"]["losses"] for r in ranks]}, checks=checks64,
             one_process_float32_against_float64=float32_from_64),
         transformer=dict(tr, img_size=SPATIAL_TRANSFORMER_IMG,
                                         batch=SPATIAL_TRANSFORMER_BATCH),
         cli_spatial_shards_2={"img_size": TRAIN_IMG, "batch": TRAIN_BATCH, "epochs": 1,
                               "results_csv": rows, "k1_launches_rank0": k1_launches,
                               "cli_train_s": c[0]["s"]},
         note="two processes share one card over gloo: no speed is measured",
         command_s=command_s, card=gpu_line, phase_s=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return [dict(name="flash_attention", path="train_spatial", launches=k4),
            dict(name="batched_greedy_nms", path="train_spatial", launches=k1_launches)]


def phase_serve_mesh(torch, gpu_line):
    """``SkyEyeDetector("skyeye_s", mesh=...)`` with two replicas on the one card:
    3 requests of 16 frames at 1280 px and a batch of 3 (the pad path). Each
    request bit for bit what the unmeshed detector gives on each replica's
    share, and the same detections as its whole batch (cuDNN's logits at
    batch 8 and 16 part by about 7e-8, which may swap two detections whose
    scores tie to that); the fused-CSP mode on the mesh (K3 on each
    replica); K1's and K3's launches counted."""
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.models.detector import fused_csp_detector
    from skyeye_tpu_torch.ops import csp_kernel, nms_kernel
    from skyeye_tpu_torch.parallel import create_mesh

    t_phase = time.perf_counter()
    mesh = create_mesh(MULTI_WORLD, devices=["cuda:0"] * MULTI_WORLD)
    plain = SkyEyeDetector("skyeye_s", img_size=1280, device="cuda")
    meshed = SkyEyeDetector("skyeye_s", img_size=1280, device="cuda", mesh=mesh)
    batch, small = frames(seed=40), frames(seed=41, n=3)
    half = len(batch) // MULTI_WORLD
    for det in (plain, meshed):
        det.warmup((TRAIN_BATCH, 3, 1280, 1280))
    want, plain_ms, _ = serve_timed(plain, batch, [nms_kernel])
    got, mesh_ms, launches = serve_timed(meshed, batch, [nms_kernel])
    # the unmeshed detector on each replica's share: what each replica computes
    shares = []
    for conf in REQUESTS:
        plain.conf_thres = conf
        shares.append([d for k in range(MULTI_WORLD)
                       for d in plain(batch[k * half:(k + 1) * half]).xyxy])
    nms_kernel.reset_launch_counts()
    meshed.conf_thres = plain.conf_thres = 0.001
    got_small = meshed(small)  # buckets of 2 and 1, each split in two (a pad row in the 1)
    small_launches = nms_kernel.LAUNCHES["batched_greedy_nms"]
    want_small = plain(small)

    def bitwise(a, b):
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))

    def index_for_index(x, y):
        return (x.shape == y.shape and np.array_equal(x[:, 5], y[:, 5])
                and np.allclose(x[:, :4], y[:, :4], rtol=0, atol=MESH_BOX_ATOL)
                and np.allclose(x[:, 4], y[:, 4], rtol=0, atol=MESH_SCORE_ATOL))

    def same_detections(x, y):
        """The same detections, in the same order up to swaps among those whose
        scores agree within MESH_SCORE_ATOL: each row of x matches one of y."""
        if x.shape != y.shape or not np.allclose(x[:, 4], y[:, 4], rtol=0,
                                                 atol=MESH_SCORE_ATOL):
            return False
        close = ((x[:, None, 5] == y[None, :, 5])
                 & (np.abs(x[:, None, :4] - y[None, :, :4]).max(-1) <= MESH_BOX_ATOL)
                 & (np.abs(x[:, None, 4] - y[None, :, 4]) <= MESH_SCORE_ATOL))
        taken = np.zeros(len(y), bool)
        for row in close:
            free = np.flatnonzero(row & ~taken)
            if not len(free):
                return False
            taken[free[0]] = True
        return True

    per_share = [bitwise(g.xyxy, s_) for g, s_ in zip(got, shares)]
    swapped = [[i for i, (x, y) in enumerate(zip(g.xyxy, w.xyxy)) if not index_for_index(x, y)]
               for g, w in zip(got, want)]
    same = all(same_detections(x, y) for g, w in zip(got, want) for x, y in zip(g.xyxy, w.xyxy))
    small_same = all(index_for_index(x, y) for x, y in zip(got_small.xyxy, want_small.xyxy))
    if not (all(per_share) and same and small_same):
        fail(f"serve_mesh: detections differ from the unmeshed detector's: each share "
             f"bitwise {per_share}, the whole batch {same} (images out of order {swapped}), "
             f"the pad batch {small_same}")
    for r in got:
        check_detections(r, (1080, 1920), meshed.config.nc)
    if launches["batched_greedy_nms"] != MULTI_WORLD * len(REQUESTS):
        fail(f"serve_mesh: K1 launched {launches['batched_greedy_nms']} times "
             f"(want {MULTI_WORLD * len(REQUESTS)}: one a share)")

    # the fused-CSP mode on the mesh: K3 on each replica's share
    plain.model = fused_csp_detector(plain.model)
    meshed.model = fused_csp_detector(meshed.model)
    plain.conf_thres = meshed.conf_thres = 0.25
    want_csp = [d for k in range(MULTI_WORLD) for d in plain(batch[k * half:(k + 1) * half]).xyxy]
    csp_kernel.reset_launch_counts()
    nms_kernel.reset_launch_counts()
    got_csp = meshed(batch)
    k3_launches = csp_kernel.LAUNCHES["csp_fused_v2"]
    k1_csp = nms_kernel.LAUNCHES["batched_greedy_nms"]
    if not bitwise(got_csp.xyxy, want_csp) or k3_launches != MULTI_WORLD:
        fail(f"serve_mesh: the fused-CSP mode on the mesh differs from its shares or "
             f"launched K3 {k3_launches} times")
    emit("serve_mesh", model="skyeye_s", img_size=1280, frames=len(batch), replicas=MULTI_WORLD,
         devices=[str(d) for d in mesh.devices], requests=REQUESTS,
         detections=[int(sum(len(d) for d in r.xyxy)) for r in got],
         equal_to_each_share_bitwise=per_share, same_detections_as_whole_batch=same,
         whole_batch_images_out_of_order=swapped, pad_batch_index_for_index=small_same,
         ms_per_request={"mesh": mesh_ms, "unmeshed": plain_ms},
         k1_launches=launches["batched_greedy_nms"], pad_batch={"frames": len(small),
                                                               "k1_launches": small_launches},
         fused_csp={"k3_launches": k3_launches, "k1_launches": k1_csp},
         note="two replicas share one card: the split's speed across cards is not measured",
         card=gpu_line, phase_s=time.perf_counter() - t_phase)
    del plain, meshed
    torch.cuda.empty_cache()
    return [dict(name="batched_greedy_nms", path="serve_mesh",
                 launches=launches["batched_greedy_nms"] + small_launches + k1_csp),
            dict(name="csp_fused_v2", path="serve_mesh", launches=k3_launches)]


def merge_by_kernel(entries):
    """One entry per kernel: the first one's numbers, ``launches`` summed over
    every path's entry and ``launches_by_path`` listing them."""
    merged = {}
    for e in entries:
        first = merged.setdefault(e["name"], dict(e, launches=0, launches_by_path={}))
        first["launches_by_path"][e["path"]] = e["launches"]
        first["launches"] += e["launches"]
    return list(merged.values())


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    # fails where the port is absent
    from skyeye_tpu_torch.data import imageio, jpeg, native
    from skyeye_tpu_torch.ops import attention_kernel, csp_kernel, nms_kernel

    gpu_line = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=gpu_line, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    # one nvcc per source, all started together
    libraries = {"nms.cu": nms_kernel.nms_library,
                 "attention.cu": attention_kernel.attention_library,
                 "csp.cu": csp_kernel.csp_library,
                 "png_unfilter.cu": imageio.png_unfilter_library,  # host code, no kernel
                 "jpeg.cu": jpeg.jpeg_library,  # host code, no kernel
                 "prep.cu": native.prep_library}  # host code, no kernel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        futures = {src: pool.submit(fn) for src, fn in libraries.items()}
        built = {src: f.result() for src, f in futures.items()}
    emit("build", seconds=time.perf_counter() - t0, libraries={
        src: {"nvcc_seconds": b.seconds, "library": b.path.name,
              "ptxas": [ln.strip() for ln in b.ptxas.splitlines()
                        if any(w in ln for w in ("Function properties", "registers", "spill"))]}
        for src, b in built.items()})

    phase_kernels(torch, nms_kernel)
    phase_kernels_attention_csp(torch, attention_kernel, csp_kernel)
    summary = phase_serve(torch, gpu_line)
    summary += phase_serve_transformer(torch, gpu_line)
    summary += phase_serve_fused_csp(torch, gpu_line)
    summary += phase_serve_enhanced(torch, gpu_line)
    summary += phase_serve_bf16(torch, gpu_line)
    summary += phase_serve_tiled(torch, gpu_line)
    summary += phase_serve_int8(torch, gpu_line)
    summary += phase_serve_int8_early(torch, gpu_line)
    with tempfile.TemporaryDirectory(prefix="skyeye_smoke_") as workdir:
        summary += phase_export(torch, gpu_line, workdir)
        summary += phase_validate(torch, gpu_line, workdir)
        summary += phase_prep_native(torch, gpu_line, workdir)
        summary += phase_detect(torch, gpu_line, workdir)
        summary += phase_train(torch, gpu_line, workdir)
        summary += phase_train_transformer(torch, gpu_line, workdir)
        summary += phase_train_host_aug(torch, gpu_line, workdir)
        summary += phase_train_remat(torch, gpu_line, workdir)
        summary += phase_evolve(torch, gpu_line, workdir)
        summary += phase_train_multi(torch, gpu_line, workdir)
        summary += phase_train_spatial(torch, gpu_line, workdir)
    summary += phase_serve_mesh(torch, gpu_line)
    summary = merge_by_kernel(summary)
    for s in summary:
        kid, replaces, source = KERNELS[s["name"]]
        s.update(id=kid, route="cuda", source=source, replaces=replaces)
    summary.sort(key=lambda s: s["id"])

    keys = ("id", "name", "route", "source", "replaces", "path", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: s[k] for k in keys} for s in summary]}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
