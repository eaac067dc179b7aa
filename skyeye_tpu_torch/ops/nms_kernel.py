"""Greedy class-offset NMS: the Hopper kernels (K1, K2) and their plain versions.

``batched_greedy_nms`` replaces ``pallas_batched_greedy_nms`` (K1) and
``greedy_nms`` replaces ``pallas_greedy_nms`` (K2), both in
``skyeye_tpu/ops/pallas/nms_kernel.py``. The kernels are in ``csrc/nms.cu``,
built by ``nvcc`` at first use and bound with ctypes.

Each wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernel (and adds one to its count in ``LAUNCHES``), a CPU tensor runs the plain
PyTorch version beside it. Up to ``MAX_CANDIDATES`` per image the kernel keeps
the candidates in registers; above it, as JAX takes any k, the wrapper hands the
kernel a (B, k) float32 scratch for the live scores and it runs the same loop
from device memory. The plain versions have the kernel's semantics and
arithmetic, op for op, so the two agree index for index; they serve the CPU and
the on-card comparison, never the main path on a card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from .cuda_build import Built, load_library

# Launches of each kernel since the last reset; only a kernel launch counts.
LAUNCHES: Dict[str, int] = {"batched_greedy_nms": 0, "greedy_nms": 0}

_EPS = 1e-7
# Candidates per image that the register path holds: kThreads * kMaxItems in
# csrc/nms.cu. Above it the kernel keeps its live scores in a device scratch.
MAX_CANDIDATES = 4096


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def nms_library() -> Built:
    """Build (at first use) and bind the NMS kernels, once per process."""
    # -fmad=false: each IoU rounds as PyTorch's separate elementwise ops do
    built = load_library("nms.cu", ("-fmad=false",))
    lib = built.lib
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.skyeye_batched_greedy_nms.argtypes = [ptr, ptr, i32, i32, i32, f32, ptr, ptr, ptr, ptr]
    lib.skyeye_batched_greedy_nms.restype = i32
    lib.skyeye_greedy_nms.argtypes = [ptr, ptr, i32, i32, f32, ptr, ptr, ptr, ptr]
    lib.skyeye_greedy_nms.restype = i32
    return built


# -- plain versions -------------------------------------------------------------

def batched_greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                             max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lockstep greedy NMS over a batch in plain PyTorch.

    boxes (B, k, 4) xyxy, already class-offset; scores (B, k), invalid < 0.
    Returns keep_idx (B, max_det) int32 and keep_valid (B, max_det) bool; rows
    are independent and identical to ``skyeye_tpu.ops.nms._greedy_nms``.
    """
    b, k = scores.shape
    dev = scores.device
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=dev)
    eps = torch.tensor(_EPS, dtype=torch.float32, device=dev)
    lane = torch.arange(k, device=dev).expand(b, k)
    rows = torch.arange(b, device=dev)
    live = scores.float().clone()
    keep_idx = torch.zeros((b, max_det), dtype=torch.int32, device=dev)
    keep_valid = torch.zeros((b, max_det), dtype=torch.bool, device=dev)
    for step in range(max_det):
        best_score = live.max(dim=1, keepdim=True).values
        valid = (best_score > 0).squeeze(1)
        if not bool(valid.any()):
            break
        # first index reaching the row max: ties go to the lowest index
        best = torch.where(live == best_score, lane, k).min(dim=1).values
        bx1, by1, bx2, by2 = (c[rows, best, None] for c in (x1, y1, x2, y2))
        barea = area[rows, best, None]
        iw = (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp(min=0)
        ih = (torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp(min=0)
        inter = iw * ih
        iou = inter / (area + barea - inter + eps)
        suppress = ((iou > thr) & valid[:, None]) | (lane == best[:, None])
        live = torch.where(suppress, torch.full_like(live, -1.0), live)
        keep_idx[:, step] = torch.where(valid, best, 0).int()
        keep_valid[:, step] = valid
    return keep_idx, keep_valid


def greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                     max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS for one image in plain PyTorch: (k, 4), (k,) -> (max_det,) x2."""
    keep_idx, keep_valid = batched_greedy_nms_plain(boxes[None], scores[None], iou_thres,
                                                    max_det)
    return keep_idx[0], keep_valid[0]


# -- kernel wrappers ------------------------------------------------------------

def _check(boxes: torch.Tensor, scores: torch.Tensor, batched: bool) -> None:
    want = 3 if batched else 2
    if boxes.dim() != want or boxes.shape[-1] != 4 or boxes.shape[:-1] != scores.shape:
        raise ValueError(f"expected boxes (..., k, 4) and scores (..., k) with "
                         f"{want - 1} leading dims, got {tuple(boxes.shape)} and "
                         f"{tuple(scores.shape)}")
    for name, t in (("boxes", boxes), ("scores", scores)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores must be on one device")


def _launch(fn_name: str, boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
            max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    out_shape = scores.shape[:-1] + (max_det,)
    k = scores.shape[-1]
    if k == 0 or max_det == 0 or scores.numel() == 0:  # nothing to suppress: no launch
        return (torch.zeros(out_shape, dtype=torch.int32, device=scores.device),
                torch.zeros(out_shape, dtype=torch.bool, device=scores.device))
    scratch_ptr = None
    if k > MAX_CANDIDATES:  # the device-memory path: the live scores in a scratch
        if boxes.data_ptr() % 16:
            raise ValueError("above MAX_CANDIDATES the NMS kernel reads boxes as 16-byte "
                             "vectors: boxes must be 16-byte aligned")
        scratch = torch.empty(scores.shape, dtype=torch.float32, device=scores.device)
        scratch_ptr = scratch.data_ptr()
    keep_idx = torch.empty(out_shape, dtype=torch.int32, device=scores.device)
    keep_valid = torch.empty(out_shape, dtype=torch.bool, device=scores.device)
    lib = nms_library().lib
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        if fn_name == "batched_greedy_nms":
            err = lib.skyeye_batched_greedy_nms(
                boxes.data_ptr(), scores.data_ptr(), scores.shape[0], k, max_det,
                iou_thres, scratch_ptr, keep_idx.data_ptr(), keep_valid.data_ptr(), stream)
        else:
            err = lib.skyeye_greedy_nms(
                boxes.data_ptr(), scores.data_ptr(), k, max_det, iou_thres, scratch_ptr,
                keep_idx.data_ptr(), keep_valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")
    LAUNCHES[fn_name] += 1
    return keep_idx, keep_valid


def batched_greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                       max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (B, k, 4) + (B, k) -> keep_idx (B, max_det) int32, keep_valid (B, max_det) bool."""
    _check(boxes, scores, batched=True)
    if boxes.device.type == "cpu":
        return batched_greedy_nms_plain(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    return _launch("batched_greedy_nms", boxes, scores, iou_thres, max_det)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (k, 4) + (k,) -> keep_idx (max_det,) int32, keep_valid (max_det,) bool."""
    _check(boxes, scores, batched=False)
    if boxes.device.type == "cpu":
        return greedy_nms_plain(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    return _launch("greedy_nms", boxes, scores, iou_thres, max_det)
