"""Fused softmax attention: the Hopper kernel (K4) and its plain versions.

``flash_attention`` replaces ``flash_attention`` / ``padded_flash_attention``
(K4) in ``skyeye_tpu/ops/pallas/attention_kernel.py``: for any (B, N, hd) it
returns what ``padded_flash_attention`` returns after its padding and slicing,
``softmax(q k^T * hd^-0.5) v``. The kernel is in ``csrc/attention.cu``, built by
``nvcc`` at first use and bound with ctypes. It masks the key tail inside the
kernel, so nothing is padded in device memory.

A CUDA tensor launches the kernel (and adds one to ``LAUNCHES``); a CPU tensor
runs ``flash_attention_plain``, the kernel's online softmax over key tiles op
for op. ``attention_reference`` is the einsum, softmax, einsum definition.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from .cuda_build import Built, load_library

# Launches of the kernel since the last reset; only a kernel launch counts.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

NEG_INF = -1e30   # the score of a masked key, as in the TPU kernel
BLOCK_K = 64      # keys per tile: kBK in csrc/attention.cu
MAX_HEAD_DIM = 256  # the widest head the kernel holds: 16 * kMaxCols in csrc/attention.cu


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def attention_library() -> Built:
    """Build (at first use) and bind the attention kernel, once per process."""
    built = load_library("attention.cu")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    built.lib.skyeye_flash_attention.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, f32, ptr]
    built.lib.skyeye_flash_attention.restype = i32
    return built


# -- plain versions -------------------------------------------------------------

def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over (B, N, hd): einsum, softmax, einsum."""
    s = torch.einsum("bqc,bkc->bqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bqk,bkc->bqc", torch.softmax(s, dim=-1), v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: q scaled by hd^-0.5, then an online
    softmax over the kernel's key tiles (the tail tile's missing keys score
    -1e30), and the sum divided by max(l, 1e-30)."""
    b, n, hd = q.shape
    qs = q * hd ** -0.5
    m = torch.full((b, n, 1), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, n, 1), dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    lane = torch.arange(BLOCK_K, device=q.device)
    for j0 in range(0, n, BLOCK_K):
        kt = torch.zeros((b, BLOCK_K, hd), dtype=k.dtype, device=k.device)
        vt = torch.zeros((b, BLOCK_K, hd), dtype=v.dtype, device=v.device)
        kt[:, : n - j0] = k[:, j0 : j0 + BLOCK_K]
        vt[:, : n - j0] = v[:, j0 : j0 + BLOCK_K]
        s = qs @ kt.transpose(1, 2)
        s = torch.where(j0 + lane < n, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vt
        m = m_new
    return acc / l.clamp(min=1e-30)


# -- kernel wrapper -------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4: softmax(q k^T * hd^-0.5) v over (B, N, hd) float32 -> (B, N, hd) float32."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one (B, N, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, n, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel holds heads of at most {MAX_HEAD_DIM}, got {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = attention_library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.skyeye_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), b, n, hd, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out
