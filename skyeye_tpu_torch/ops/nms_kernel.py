"""Greedy class-offset NMS: the Hopper kernels (K1, K2) and their plain versions.

``batched_greedy_nms`` replaces ``pallas_batched_greedy_nms`` (K1) and
``greedy_nms`` replaces ``pallas_greedy_nms`` (K2), both in
``skyeye_tpu/ops/pallas/nms_kernel.py``. The kernels are in ``csrc/nms.cu``,
built by ``nvcc`` at first use and bound with ctypes.

Each wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernels (and adds one to its count in ``LAUNCHES``), a CPU tensor runs the plain
PyTorch version beside it. On the card one wrapper call runs three stages in
order on the current stream, for any number of candidates:

  order  ``nms_order``: the positive candidates (score > 0) in the order score
         descending, index ascending; their boxes in that order, their indices,
         their count ``n_pos`` and whether the row holds a NaN score;
  mask   ``nms_mask``: bit c of word w of row r is IoU(r, c) > iou_thres, for
         sorted positions r < c < n_pos (c = 64 w + bit);
  walk   ``nms_walk``: the candidates that no earlier kept one overlaps, in
         order, up to max_det; none where the row holds a NaN score.

Greedy NMS keeps exactly what the walk keeps, so the stages compose to the
plain versions, which repeat JAX's greedy loop op for op; each stage also has a
plain version (``nms_*_plain``) with the kernel's semantics, for the CPU tests
and the on-card comparison, never the main path on a card. ``scratch_layout``
is the rule for what a call on the card allocates between its stages: one
buffer, most of it the mask.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import Built, load_library

# Launches of each kernel since the last reset; one a wrapper call that runs the
# kernels.
LAUNCHES: Dict[str, int] = {"batched_greedy_nms": 0, "greedy_nms": 0}

_EPS = 1e-7
WORD_BITS = 64  # mask bits a word: one block of the walk
_ALIGN = 256    # bytes: where each part of the scratch buffer starts
_TILE = 256     # sorted positions a mask tile spans: the walk limit's unit
_PLAIN_ROWS = 128  # rows of the plain mask built at once (a multiple of WORD_BITS)


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
    lib.skyeye_nms_order.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.skyeye_nms_mask.argtypes = [ptr, ptr, i32, i32, f32, ptr, ptr]
    lib.skyeye_nms_walk.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.skyeye_nms.argtypes = [ptr, ptr, i32, i32, f32, i32, i32, *[ptr] * 9]
    for fn in (lib.skyeye_nms_order, lib.skyeye_nms_mask, lib.skyeye_nms_walk, lib.skyeye_nms):
        fn.restype = i32
    return built


def words_per_row(k: int) -> int:
    return -(-k // WORD_BITS)


def walk_limit(k: int, max_det: int) -> int:
    """Sorted positions that a call's first mask pass and walk cover: 4 max_det,
    at least 1024, in whole mask tiles. An image whose walk keeps max_det there,
    or runs out of candidates, is done; the mask's second pass and a second walk
    cover the rest for the others. k or more: one pass."""
    return min(-(-max(4 * max_det, 1024) // _TILE) * _TILE, k)


def scratch_layout(batch: int, k: int) -> Dict[str, Tuple[int, Tuple[int, ...], torch.dtype]]:
    """What one call on the card allocates between its stages, as one buffer:
    name -> (byte offset, shape, dtype), each part on a 256-byte boundary. The
    mask (int64 words, read as uint64 by the kernels) is most of it."""
    parts = (("sorted_boxes", (batch, k, 4), torch.float32),
             ("order", (batch, k), torch.int32),
             ("n_pos", (batch,), torch.int32),
             ("has_nan", (batch,), torch.int32),
             ("done", (batch,), torch.int32),
             ("mask", (batch, k, words_per_row(k)), torch.int64))
    layout, offset = {}, 0
    for name, shape, dtype in parts:
        layout[name] = (offset, shape, dtype)
        offset += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return layout


def scratch_bytes(batch: int, k: int) -> int:
    offset, shape, dtype = scratch_layout(batch, k)["mask"]
    return offset + math.prod(shape) * dtype.itemsize


@functools.lru_cache(maxsize=64)
def _call_plan(batch: int, k: int, max_det: int) -> Tuple[int, Tuple[int, ...], int]:
    """(scratch bytes, part offsets, walk limit) of a call, once per shape."""
    offsets = tuple(offset for offset, _, _ in scratch_layout(batch, k).values())
    return scratch_bytes(batch, k), offsets, walk_limit(k, max_det)


class NmsOrder(NamedTuple):
    """The order stage's output: the first n_pos[b] positions of each image's
    sorted_boxes and order are defined."""

    sorted_boxes: torch.Tensor  # (B, k, 4) float32
    order: torch.Tensor         # (B, k) int32: the original index at each position
    n_pos: torch.Tensor         # (B,) int32: candidates with score > 0
    has_nan: torch.Tensor       # (B,) int32: 1 where the row holds a NaN score


def mask_defined(n_pos: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k, words) bool: the mask words the mask stage defines (rows r < n_pos,
    words r // 64 <= w < ceil(n_pos / 64)); the walk reads no other."""
    nw = words_per_row(k)
    dev = n_pos.device
    r = torch.arange(k, device=dev)[None, :, None]
    w = torch.arange(nw, device=dev)[None, None, :]
    n = n_pos.long()[:, None, None]
    return (r < n) & (w >= r // WORD_BITS) & (w * WORD_BITS < n)


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
        # first index reaching the row max: ties go to the lowest index; k in a
        # row whose max is NaN, which is invalid and gathers from a valid index
        best = torch.where(live == best_score, lane, k).min(dim=1).values
        at = best.clamp(max=k - 1)
        bx1, by1, bx2, by2 = (c[rows, at, None] for c in (x1, y1, x2, y2))
        barea = area[rows, at, None]
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


def nms_order_plain(boxes: torch.Tensor, scores: torch.Tensor) -> NmsOrder:
    """The order stage in plain PyTorch; positions from n_pos on hold zeros."""
    b, k = scores.shape
    s = scores.float()
    positive = s > 0
    # a stable descending sort keeps equal scores in index order; -1 puts every
    # score that is not > 0 (NaN included) after the positive ones
    _, idx = torch.sort(torch.where(positive, s, torch.full_like(s, -1.0)), dim=1,
                        descending=True, stable=True)
    n_pos = positive.sum(dim=1).int()
    defined = torch.arange(k, device=s.device)[None] < n_pos[:, None]
    order = torch.where(defined, idx, 0).int()
    sorted_boxes = torch.gather(boxes.float(), 1, idx[..., None].expand(b, k, 4))
    sorted_boxes = torch.where(defined[..., None], sorted_boxes, 0.0)
    return NmsOrder(sorted_boxes, order, n_pos, torch.isnan(s).any(dim=1).int())


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 64 n) bool -> (..., n) int64, bit j of a word from element j."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    byte = (bits.to(torch.uint8).unflatten(-1, (-1, 8)) << shifts).sum(-1, dtype=torch.uint8)
    return byte.contiguous().view(torch.int64)


def nms_mask_plain(sorted_boxes: torch.Tensor, n_pos: torch.Tensor,
                   iou_thres: float) -> torch.Tensor:
    """The mask stage in plain PyTorch, JAX's IoU op for op with the sorted row
    as the winner; words outside ``mask_defined`` hold zeros."""
    b, k, _ = sorted_boxes.shape
    dev = sorted_boxes.device
    nw = words_per_row(k)
    x1, y1, x2, y2 = sorted_boxes.float().unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=dev)
    eps = torch.tensor(_EPS, dtype=torch.float32, device=dev)
    n = n_pos.long()[:, None, None]
    mask = torch.zeros((b, k, nw), dtype=torch.int64, device=dev)
    for r0 in range(0, k, _PLAIN_ROWS):
        r1 = min(k, r0 + _PLAIN_ROWS)
        r = torch.arange(r0, r1, device=dev)[None, :, None]
        c = torch.arange(r0, k, device=dev)[None, None, :]  # words from r0 // 64 on
        rs, cs = slice(r0, r1), slice(r0, k)
        iw = (torch.minimum(x2[:, None, cs], x2[:, rs, None])
              - torch.maximum(x1[:, None, cs], x1[:, rs, None])).clamp(min=0)
        ih = (torch.minimum(y2[:, None, cs], y2[:, rs, None])
              - torch.maximum(y1[:, None, cs], y1[:, rs, None])).clamp(min=0)
        inter = iw * ih
        iou = inter / (area[:, None, cs] + area[:, rs, None] - inter + eps)
        hit = (iou > thr) & (c > r) & (c < n) & (r < n)
        hit = F.pad(hit, (0, nw * WORD_BITS - k))
        mask[:, rs, r0 // WORD_BITS:] = _pack_words(hit)
    return mask


def nms_walk_plain(mask: torch.Tensor, order: torch.Tensor, n_pos: torch.Tensor,
                   has_nan: torch.Tensor, max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk stage in plain PyTorch (on the host): keep_idx (B, max_det) int32
    and keep_valid (B, max_det) bool, on the mask's device."""
    b, k, _ = mask.shape
    words = mask.cpu().numpy()
    orders, counts, nans = order.cpu().tolist(), n_pos.cpu().tolist(), has_nan.cpu().tolist()
    keep_idx = torch.zeros((b, max_det), dtype=torch.int32)
    keep_valid = torch.zeros((b, max_det), dtype=torch.bool)
    for i in range(b):
        n = 0 if nans[i] else counts[i]
        nwp = words_per_row(n)
        removed, kept = 0, []  # removed: one bit a sorted position
        for p in range(n):
            if len(kept) == max_det:
                break
            if (removed >> p) & 1:
                continue
            kept.append(orders[i][p])
            w0 = p // WORD_BITS
            row = int.from_bytes(words[i, p, w0:nwp].tobytes(), "little")
            removed |= row << (WORD_BITS * w0)
        keep_idx[i, :len(kept)] = torch.tensor(kept, dtype=torch.int32)
        keep_valid[i, :len(kept)] = True
    return keep_idx.to(mask.device), keep_valid.to(mask.device)


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


def _check_stage(*named: Tuple[str, torch.Tensor, Tuple[int, ...], torch.dtype]) -> None:
    """Raise unless each (name, tensor, shape, dtype) holds, each tensor is
    contiguous, and all lie on one device."""
    for name, t, shape, dtype in named:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if len({t.device for _, t, _, _ in named}) != 1:
        raise ValueError("a stage's tensors must be on one device")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _call(fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point on the device's current stream; raise on its error."""
    fn = getattr(nms_library().lib, fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError {err}")


def _empty(name: str, batch: int, k: int, device: torch.device) -> torch.Tensor:
    _, shape, dtype = scratch_layout(batch, k)[name]
    return torch.empty(shape, dtype=dtype, device=device)


def _order_kernel(boxes: torch.Tensor, scores: torch.Tensor) -> NmsOrder:
    b, k = scores.shape
    out = NmsOrder(*(_empty(name, b, k, scores.device) for name in NmsOrder._fields))
    _call("skyeye_nms_order", scores.device, boxes.data_ptr(), scores.data_ptr(), b, k,
          *(t.data_ptr() for t in out))
    return out


def _mask_kernel(sorted_boxes: torch.Tensor, n_pos: torch.Tensor,
                 iou_thres: float) -> torch.Tensor:
    b, k, _ = sorted_boxes.shape
    mask = _empty("mask", b, k, sorted_boxes.device)
    _call("skyeye_nms_mask", sorted_boxes.device, sorted_boxes.data_ptr(), n_pos.data_ptr(),
          b, k, iou_thres, mask.data_ptr())
    return mask


def _walk_kernel(mask: torch.Tensor, order: torch.Tensor, n_pos: torch.Tensor,
                 has_nan: torch.Tensor, max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b, k, _ = mask.shape
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=mask.device)
    keep_valid = torch.empty((b, max_det), dtype=torch.bool, device=mask.device)
    _call("skyeye_nms_walk", mask.device, mask.data_ptr(), order.data_ptr(), n_pos.data_ptr(),
          has_nan.data_ptr(), b, k, max_det, keep_idx.data_ptr(), keep_valid.data_ptr())
    return keep_idx, keep_valid


def nms_order(boxes: torch.Tensor, scores: torch.Tensor) -> NmsOrder:
    """The order stage alone: (B, k, 4) + (B, k) float32 -> ``NmsOrder``."""
    _check(boxes, scores, batched=True)
    if _device_kind(scores) == "cpu":
        return nms_order_plain(boxes, scores)
    return _order_kernel(boxes, scores)


def nms_mask(sorted_boxes: torch.Tensor, n_pos: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The mask stage alone: (B, k, words) int64, defined where ``mask_defined``."""
    if sorted_boxes.dim() != 3:
        raise ValueError(f"expected sorted_boxes (B, k, 4), got {tuple(sorted_boxes.shape)}")
    b, k, _ = sorted_boxes.shape
    _check_stage(("sorted_boxes", sorted_boxes, (b, k, 4), torch.float32),
                 ("n_pos", n_pos, (b,), torch.int32))
    if _device_kind(sorted_boxes) == "cpu":
        return nms_mask_plain(sorted_boxes, n_pos, iou_thres)
    return _mask_kernel(sorted_boxes, n_pos, iou_thres)


def nms_walk(mask: torch.Tensor, order: torch.Tensor, n_pos: torch.Tensor,
             has_nan: torch.Tensor, max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk stage alone: keep_idx (B, max_det) int32, keep_valid (B, max_det) bool."""
    if mask.dim() != 3:
        raise ValueError(f"expected mask (B, k, words), got {tuple(mask.shape)}")
    b, k, _ = mask.shape
    _check_stage(("mask", mask, (b, k, words_per_row(k)), torch.int64),
                 ("order", order, (b, k), torch.int32), ("n_pos", n_pos, (b,), torch.int32),
                 ("has_nan", has_nan, (b,), torch.int32))
    if _device_kind(mask) == "cpu":
        return nms_walk_plain(mask, order, n_pos, has_nan, max_det)
    return _walk_kernel(mask, order, n_pos, has_nan, max_det)


def _launch(fn_name: str, boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
            max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three stages on (B, k, 4) + (B, k) CUDA tensors, in one C call: three
    launches, five where ``walk_limit`` is below k."""
    b, k = scores.shape
    dev = scores.device
    if k == 0 or max_det == 0 or b == 0:  # nothing to suppress: no launch
        return (torch.zeros((b, max_det), dtype=torch.int32, device=dev),
                torch.zeros((b, max_det), dtype=torch.bool, device=dev))
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=dev)
    keep_valid = torch.empty((b, max_det), dtype=torch.bool, device=dev)
    nbytes, offsets, limit = _call_plan(b, k, max_det)
    # freed on return, as any temporary: the stream orders its reuse after the kernels
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    _call("skyeye_nms", dev, boxes.data_ptr(), scores.data_ptr(), b, k, iou_thres, max_det,
          limit, *(base + offset for offset in offsets), keep_idx.data_ptr(),
          keep_valid.data_ptr())
    LAUNCHES[fn_name] += 1
    return keep_idx, keep_valid


def batched_greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                       max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (B, k, 4) + (B, k) -> keep_idx (B, max_det) int32, keep_valid (B, max_det) bool."""
    _check(boxes, scores, batched=True)
    if _device_kind(scores) == "cpu":
        return batched_greedy_nms_plain(boxes, scores, iou_thres, max_det)
    return _launch("batched_greedy_nms", boxes, scores, iou_thres, max_det)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (k, 4) + (k,) -> keep_idx (max_det,) int32, keep_valid (max_det,) bool."""
    _check(boxes, scores, batched=False)
    if _device_kind(scores) == "cpu":
        return greedy_nms_plain(boxes, scores, iou_thres, max_det)
    keep_idx, keep_valid = _launch("greedy_nms", boxes[None], scores[None], iou_thres,
                                   max_det)
    return keep_idx[0], keep_valid[0]
