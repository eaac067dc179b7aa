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

A CUDA tensor launches the kernel (and adds one to ``LAUNCHES``); a CPU tensor
runs ``csp_fused_plain``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping

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


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def csp_library() -> Built:
    """Build (at first use) and bind the fused CSP kernel, once per process."""
    built = load_library("csp.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    built.lib.skyeye_csp_fused.argtypes = [ptr] * 12 + [i32] * 8 + [ptr]
    built.lib.skyeye_csp_fused.restype = i32
    return built


def smem_bytes(c: int, h: int, num_blocks: int, tile_rows: int) -> int:
    """Shared memory of one block: the input tile, the chain and the 3x3 input,
    each with num_blocks halo pixels a side, in bf16."""
    return (tile_rows + 2 * num_blocks) * (TILE_COLS + 2 * num_blocks) * (c + 2 * h) * 2


def _shapes(x: torch.Tensor, weights: Mapping[str, torch.Tensor], num_blocks: int):
    """(C, h, C_out) after checking every weight against the JAX layout."""
    if x.dim() != 4:
        raise ValueError(f"expected x (B, H, W, C), got {tuple(x.shape)}")
    missing = [k for k in WEIGHT_NAMES if k not in weights]
    if missing:
        raise KeyError(f"missing fused CSP weights {missing}")
    c = x.shape[-1]
    h = weights["w_cv1"].shape[1]
    c_out = weights["w_cv3"].shape[1]
    nb = num_blocks
    want = {"w_cv1": (c, h), "b_cv1": (h,), "w_m1": (nb, h, h), "b_m1": (nb, h),
            "w_m2": (nb, 3, 3, h, h), "b_m2": (nb, h), "w_cv2": (c, h), "b_cv2": (h,),
            "w_cv3": (2 * h, c_out), "b_cv3": (c_out,)}
    for name, shape in want.items():
        if tuple(weights[name].shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(weights[name].shape)}")
    return c, h, c_out


# -- plain version --------------------------------------------------------------

def _silu_bf16(v: torch.Tensor) -> torch.Tensor:
    """SiLU in float32, rounded to bf16 and held as float32 (exact)."""
    return (v * torch.sigmoid(v)).to(torch.bfloat16).float()


def csp_fused_plain(x: torch.Tensor, weights: Mapping[str, torch.Tensor],
                    num_blocks: int) -> torch.Tensor:
    """The fused CSP block in PyTorch over the whole image, rounding where the
    kernel rounds (the kernel's tiling changes no value, only the order of sums)."""
    _, h_img, w_img, _ = x.shape
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

def _run(name: str, x: torch.Tensor, weights: Mapping[str, torch.Tensor], num_blocks: int,
         tile_rows: int) -> torch.Tensor:
    c, h, c_out = _shapes(x, weights, num_blocks)
    if x.device.type == "cpu":
        return csp_fused_plain(x, weights, num_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"x must be contiguous bfloat16, got {x.dtype}")
    if num_blocks < 1 or tile_rows < 1:
        raise ValueError(f"num_blocks and tile_rows must be >= 1, got {num_blocks}, {tile_rows}")
    if c % 2 or h % 2:
        raise ValueError(f"the CSP kernel reads channel pairs: C {c} and h {h} must be even")
    smem = smem_bytes(c, h, num_blocks, tile_rows)
    if smem > MAX_SMEM:
        raise ValueError(f"a tile of {tile_rows} rows needs {smem} bytes of shared memory, "
                         f"more than the {MAX_SMEM} a block may use; take fewer rows")
    b, h_img, w_img, _ = x.shape
    out = torch.empty((b, h_img, w_img, c_out), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    # the kernel takes the bf16-rounded weights as float32, contiguous
    wts = [weights[k].to(device=x.device, dtype=torch.bfloat16).float().contiguous()
           for k in WEIGHT_NAMES]
    lib = csp_library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.skyeye_csp_fused(x.data_ptr(), *[t.data_ptr() for t in wts], out.data_ptr(),
                                   b, h_img, w_img, c, h, c_out, num_blocks, tile_rows, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def csp_fused_v2(x: torch.Tensor, weights: Mapping[str, torch.Tensor], num_blocks: int,
                 tile_rows: int = TILE_ROWS) -> torch.Tensor:
    """K3: (B, H, W, C) bf16 -> (B, H, W, C_out) bf16, tiles of tile_rows x 32 pixels."""
    return _run("csp_fused_v2", x, weights, num_blocks, tile_rows)


def csp_fused(x: torch.Tensor, weights: Mapping[str, torch.Tensor], num_blocks: int,
              tile_rows: int = TILE_ROWS) -> torch.Tensor:
    """K3b: the same function and kernel as ``csp_fused_v2``, under the v1 name."""
    return _run("csp_fused", x, weights, num_blocks, tile_rows)
