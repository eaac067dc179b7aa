"""Fused CSP block over BN-folded bf16 weights: the Hopper kernel (K3, K3b) and its
plain version.

``csp_fused_v2`` replaces ``csp_fused_v2`` (K3) and ``csp_fused`` replaces
``csp_fused`` (K3b), both in ``skyeye_tpu/ops/pallas/csp_kernel.py``. The two
TPU versions compute one function and differ only in how the TPU stages memory,
so one CUDA kernel (``csrc/csp.cu``) serves both names; each name keeps its own
launch count.

The function: x (B, H, W, C) bf16 NHWC -> cv1 (1x1 C->h) -> nb bottlenecks (1x1
h->h, then 3x3 h->h with a residual) || bypass cv2 (1x1 C->h) -> concat
[chain, bypass] -> cv3 (1x1 2h->C_out), each conv followed by SiLU; output
(B, H, W, C_out) bf16. The rounding points are the TPU kernel's: weights and
biases in bf16, products summed in float32, each SiLU taken in float32 and
rounded to bf16, the residual added in bf16, the 3x3 reading zeros outside the
image.

The kernel takes its weights packed: ``prepare_weights`` rounds the ten tensors
to bf16, zero-pads the channels and lays each weight out in the order of the
kernel's mma fragments, once. ``FusedCSPBlock`` prepares once and reuses the
result, so a served call launches only the kernel; a caller that passes the ten
tensors instead, as JAX's ``csp_fused_v2`` takes them, has them prepared on
every call. Where the packed weights and a tile's halo grid do not fit one
block's shared memory together (csp1 of skyeye_m and skyeye_l), the kernel
reads the weights from device memory instead (``smem_bytes``).

A CUDA tensor launches the kernel (and adds one to ``LAUNCHES``); a CPU tensor
runs ``csp_fused_plain``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F

from .cuda_build import Built, load_library

# Launches of each wrapper since the last reset; only a kernel launch counts.
LAUNCHES: Dict[str, int] = {"csp_fused_v2": 0, "csp_fused": 0}

WEIGHT_NAMES = ("w_cv1", "b_cv1", "w_m1", "b_m1", "w_m2", "b_m2",
                "w_cv2", "b_cv2", "w_cv3", "b_cv3")
TILE_ROWS = 8    # output rows of a block's tile
TILE_COLS = 32   # output columns of a block's tile: kTileCols in csrc/csp.cu
MAX_SMEM = 232448  # shared memory one block of an H100 may use, bytes
# (h padded / 32, C_out padded / 32) pairs the kernel is built for: csrc/csp.cu's
# dispatch. csp1 of skyeye_s is (1, 2), of skyeye_m (2, 3), of the skyeye_l models (2, 4).
SUPPORTED_GROUPS = ((1, 1), (1, 2), (1, 4), (2, 2), (2, 3), (2, 4))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def csp_library() -> Built:
    """Build (at first use) and bind the fused CSP kernel, once per process."""
    built = load_library("csp.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    built.lib.skyeye_csp_fused.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    built.lib.skyeye_csp_fused.restype = i32
    return built


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _padded(c: int, h: int, c_out: int):
    """(C to 16, h to 32, C_out to 32): the kernel's padded channel counts."""
    return _round_up(c, 16), _round_up(h, 32), _round_up(c_out, 32)


def _smem_parts(c: int, h: int, num_blocks: int, tile_rows: int, c_out: int):
    """(packed weight bytes, the rest) of one block's shared memory, as csrc/csp.cu's
    Layout counts them: the rest is the biases and, per pixel of the halo grid, a
    row of X (x, then the bypass and t, then the output) and of W (the chain)."""
    cp, hp, op = _padded(c, h, c_out)
    nb = num_blocks
    frags = 2 * cp * hp + 10 * nb * hp * hp + 2 * hp * op          # bf16
    biases = 2 * hp + 2 * nb * hp + op                             # float32
    xs, ws = max(cp, 2 * hp, op) + 8, hp + 8
    pixels = (tile_rows + 2 * nb) * (TILE_COLS + 2 * nb)
    return frags * 2, biases * 4 + pixels * (xs + ws) * 2


def weights_in_smem(c: int, h: int, num_blocks: int, tile_rows: int,
                    c_out: Optional[int] = None) -> bool:
    """Whether the kernel copies the packed weights into shared memory (they fit
    beside the halo grid) or reads them from device memory: csrc/csp.cu's rule."""
    weights, rest = _smem_parts(c, h, num_blocks, tile_rows, c if c_out is None else c_out)
    return weights + rest <= MAX_SMEM


def smem_bytes(c: int, h: int, num_blocks: int, tile_rows: int,
               c_out: Optional[int] = None) -> int:
    """Shared memory of one block: the packed weights where ``weights_in_smem``,
    the biases and the halo grid's rows."""
    weights, rest = _smem_parts(c, h, num_blocks, tile_rows, c if c_out is None else c_out)
    return weights + rest if weights + rest <= MAX_SMEM else rest


def _check_shapes(c: int, weights: Mapping[str, torch.Tensor], num_blocks: int):
    """(h, C_out) after checking every weight against the JAX layout."""
    missing = [k for k in WEIGHT_NAMES if k not in weights]
    if missing:
        raise KeyError(f"missing fused CSP weights {missing}")
    h = weights["w_cv1"].shape[1]
    c_out = weights["w_cv3"].shape[1]
    nb = num_blocks
    want = {"w_cv1": (c, h), "b_cv1": (h,), "w_m1": (nb, h, h), "b_m1": (nb, h),
            "w_m2": (nb, 3, 3, h, h), "b_m2": (nb, h), "w_cv2": (c, h), "b_cv2": (h,),
            "w_cv3": (2 * h, c_out), "b_cv3": (c_out,)}
    for name, shape in want.items():
        if tuple(weights[name].shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(weights[name].shape)}")
    return h, c_out


def _fragments(w: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """(K, N) weight -> bf16 in mma.m16n8k16 B-fragment order, zero-padded to
    (kp, np_): for each k step of 16, n tile of 8 and lane (g = lane // 4, t =
    lane % 4), the elements at k = 2t, 2t + 1, 2t + 8, 2t + 9 of column g."""
    k, n = w.shape
    wp = torch.zeros((kp, np_), dtype=torch.float32, device=w.device)
    wp[:k, :n] = w
    ks = torch.arange(kp // 16, device=w.device).view(-1, 1, 1, 1)
    nt = torch.arange(np_ // 8, device=w.device).view(1, -1, 1, 1)
    lane = torch.arange(32, device=w.device).view(1, 1, -1, 1)
    e = torch.arange(4, device=w.device).view(1, 1, 1, -1)
    row = ks * 16 + 2 * (lane % 4) + e % 2 + 8 * (e // 2)
    col = nt * 8 + lane // 4
    return wp[row, col].to(torch.bfloat16).reshape(-1)


def _padded_vector(b: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.float32, device=b.device)
    out[: b.numel()] = b
    return out


@dataclass(frozen=True)
class PreparedCSPWeights:
    """The ten weights rounded to bf16 (held as float32, exact) in the JAX layout,
    which the plain version reads, and the kernel's packed copy: ``frags`` (bf16
    mma fragments of cv1, m1, m2, cv2 and cv3, in csrc/csp.cu's Layout order) and
    ``bias`` (float32, each bias zero-padded)."""

    rounded: Dict[str, torch.Tensor]
    frags: torch.Tensor
    bias: torch.Tensor
    c: int
    h: int
    c_out: int
    num_blocks: int


def prepare_weights(weights: Mapping[str, torch.Tensor], num_blocks: int,
                    device=None) -> PreparedCSPWeights:
    """Round, pad and pack the ten fused-CSP weights once, on ``device`` (default:
    where the weights are)."""
    if "w_cv1" not in weights:
        raise KeyError("missing fused CSP weights ['w_cv1']")
    c = weights["w_cv1"].shape[0]
    h, c_out = _check_shapes(c, weights, num_blocks)
    dev = weights["w_cv1"].device if device is None else torch.device(device)
    r = {k: weights[k].detach().to(device=dev, dtype=torch.bfloat16).float()
         for k in WEIGHT_NAMES}
    cp, hp, op = _padded(c, h, c_out)
    nb = num_blocks
    w3 = torch.zeros((2 * hp, c_out), dtype=torch.float32, device=dev)
    w3[:h], w3[hp:hp + h] = r["w_cv3"][:h], r["w_cv3"][h:]  # [chain | bypass], each padded
    frags = torch.cat(
        [_fragments(r["w_cv1"], cp, hp)]
        + [_fragments(r["w_m1"][i], hp, hp) for i in range(nb)]
        + [_fragments(r["w_m2"][i, dy, dx], hp, hp)
           for i in range(nb) for dy in range(3) for dx in range(3)]
        + [_fragments(r["w_cv2"], cp, hp), _fragments(w3, 2 * hp, op)])
    bias = torch.cat([_padded_vector(r["b_cv1"], hp)]
                     + [_padded_vector(r["b_m1"][i], hp) for i in range(nb)]
                     + [_padded_vector(r["b_m2"][i], hp) for i in range(nb)]
                     + [_padded_vector(r["b_cv2"], hp), _padded_vector(r["b_cv3"], op)])
    return PreparedCSPWeights(r, frags.contiguous(), bias.contiguous(), c, h, c_out, nb)


CSPWeights = Union[Mapping[str, torch.Tensor], PreparedCSPWeights]


# -- plain version --------------------------------------------------------------

def _silu_bf16(v: torch.Tensor) -> torch.Tensor:
    """SiLU in float32, rounded to bf16 and held as float32 (exact)."""
    return (v * torch.sigmoid(v)).to(torch.bfloat16).float()


def csp_fused_plain(x: torch.Tensor, weights: CSPWeights, num_blocks: int) -> torch.Tensor:
    """The fused CSP block in PyTorch over the whole image, rounding where the
    kernel rounds (the kernel's tiling changes no value, only the order of sums)."""
    _, h_img, w_img, _ = x.shape
    if isinstance(weights, PreparedCSPWeights):
        w = {k: v.to(x.device) for k, v in weights.rounded.items()}
    else:
        w = {k: weights[k].to(torch.bfloat16).float() for k in WEIGHT_NAMES}
    xf = x.to(torch.bfloat16).float()
    work = _silu_bf16(xf @ w["w_cv1"] + w["b_cv1"])
    for i in range(num_blocks):
        t = _silu_bf16(work @ w["w_m1"][i] + w["b_m1"][i])
        tp = F.pad(t, (0, 0, 1, 1, 1, 1))  # zeros outside the image, in H and W
        acc = w["b_m2"][i].expand_as(t)
        for dy in range(3):
            for dx in range(3):
                acc = acc + tp[:, dy:dy + h_img, dx:dx + w_img, :] @ w["w_m2"][i, dy, dx]
        work = (work.to(torch.bfloat16) + _silu_bf16(acc).to(torch.bfloat16)).float()
    bypass = _silu_bf16(xf @ w["w_cv2"] + w["b_cv2"])
    y = torch.cat([work, bypass], dim=-1)
    return _silu_bf16(y @ w["w_cv3"] + w["b_cv3"]).to(torch.bfloat16)


# -- kernel wrappers ------------------------------------------------------------

def _prepared(weights: CSPWeights, num_blocks: int, device) -> PreparedCSPWeights:
    if isinstance(weights, PreparedCSPWeights):
        return weights
    return prepare_weights(weights, num_blocks, device)


def _run(name: str, x: torch.Tensor, weights: PreparedCSPWeights, num_blocks: int,
         tile_rows: int) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"expected x (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if (weights.c, weights.num_blocks) != (c, num_blocks):
        raise ValueError(f"weights prepared for C {weights.c}, nb {weights.num_blocks}; "
                         f"got C {c}, nb {num_blocks}")
    h, c_out = weights.h, weights.c_out
    if x.device.type == "cpu":
        return csp_fused_plain(x, weights, num_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"x must be contiguous bfloat16, got {x.dtype}")
    if num_blocks < 1 or tile_rows < 1:
        raise ValueError(f"num_blocks and tile_rows must be >= 1, got {num_blocks}, {tile_rows}")
    if c % 2 or h % 2 or c_out % 2:
        raise ValueError(f"the CSP kernel reads channel pairs: C {c}, h {h} and C_out {c_out} "
                         "must be even")
    _, hp, op = _padded(c, h, c_out)
    if (hp // 32, op // 32) not in SUPPORTED_GROUPS:
        raise ValueError(f"the CSP kernel is built for (h, C_out) in {SUPPORTED_GROUPS} "
                         f"groups of 32; got h {h}, C_out {c_out}")
    smem = smem_bytes(c, h, num_blocks, tile_rows, c_out)
    if smem > MAX_SMEM:
        raise ValueError(f"a tile of {tile_rows} rows needs {smem} bytes of shared memory, "
                         f"more than the {MAX_SMEM} a block may use; take fewer rows")
    if weights.frags.device != x.device:
        raise ValueError(f"weights prepared on {weights.frags.device}, x on {x.device}")
    b, h_img, w_img, _ = x.shape
    out = torch.empty((b, h_img, w_img, c_out), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    lib = csp_library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.skyeye_csp_fused(x.data_ptr(), weights.frags.data_ptr(),
                                   weights.bias.data_ptr(), out.data_ptr(), b, h_img, w_img,
                                   c, h, c_out, num_blocks, tile_rows, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def csp_fused_v2(x: torch.Tensor, weights: CSPWeights, num_blocks: int,
                 tile_rows: int = TILE_ROWS) -> torch.Tensor:
    """K3: (B, H, W, C) bf16 -> (B, H, W, C_out) bf16, tiles of tile_rows x 32 pixels.
    ``weights``: the ten tensors, or ``prepare_weights``' result."""
    return _run("csp_fused_v2", x, _prepared(weights, num_blocks, x.device), num_blocks,
                tile_rows)


def csp_fused(x: torch.Tensor, weights: CSPWeights, num_blocks: int,
              tile_rows: int = TILE_ROWS) -> torch.Tensor:
    """K3b: the same function and kernel as ``csp_fused_v2``, under the v1 name."""
    return _run("csp_fused", x, _prepared(weights, num_blocks, x.device), num_blocks, tile_rows)
