"""Fused softmax attention: the Hopper kernel (K4) and its plain versions.

``flash_attention`` replaces ``flash_attention`` / ``padded_flash_attention``
(K4) in ``skyeye_tpu/ops/pallas/attention_kernel.py``: for any (B, N, hd) it
returns what ``padded_flash_attention`` returns after its padding and slicing,
``softmax(q k^T * hd^-0.5) v``. The kernel is in ``csrc/attention.cu``, built by
``nvcc`` at first use and bound with ctypes. It masks the key tail inside the
kernel, so nothing is padded in device memory.

``flash_attention`` is differentiable: it runs through ``FlashAttention``, a
``torch.autograd.Function`` whose backward is ``flash_attention_backward``, the
recompute of JAX's custom VJP (``_padded_flash_bwd``) in float32. That backward
is einsums in JAX too, so it is plain PyTorch here. Without grad (``no_grad``,
``inference_mode`` or inputs that need none) the forward saves nothing.

A CUDA tensor launches the kernel (and adds one to ``LAUNCHES``); a CPU tensor
runs ``flash_attention_plain``, the kernel's online softmax over key tiles op
for op. ``attention_reference`` is the einsum, softmax, einsum definition.

The forward is the custom op ``skyeye::flash_attention`` (``torch.library``),
with a fake implementation for tracing, so a ``torch.export`` program keeps K4
as one node (``cli/export.py``), and with a FLOP formula (4 B N^2 hd, what
JAX's einsums count) for ``torch.utils.flop_counter``, which cannot see into a
ctypes call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .cuda_build import Built, load_library

# Launches of the kernel since the last reset; only a kernel launch counts.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

NEG_INF = -1e30   # the score of a masked key, as in the TPU kernel
BLOCK_K = 32      # keys per tile: kBK in csrc/attention.cu
MAX_HEAD_DIM = 256  # the widest head the kernel holds: kMaxHeadDim in csrc/attention.cu


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def attention_library(*extra_flags: str) -> Built:
    """Build (at first use) and bind the attention kernel, once per process and
    set of extra ``nvcc`` flags (``-DSKYEYE_SCORE_FP32``: the score product on
    float32 FMAs, ``tools/attention_precision.py``'s comparison)."""
    built = load_library("attention.cu", extra_flags)
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


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             g: torch.Tensor):
    """dq, dk, dv of softmax(q k^T * hd^-0.5) v for the output gradient g: the
    exact backward recomputed in float32, as ``_padded_flash_bwd`` does."""
    scale = q.shape[-1] ** -0.5
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bqc,bkc->bqk", q32, k32) * scale, dim=-1)
    dv = torch.einsum("bqk,bqc->bkc", p, g32)
    dp = torch.einsum("bqc,bkc->bqk", g32, v32)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkc->bqc", ds, k32) * scale
    dk = torch.einsum("bqk,bqc->bkc", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrapper -------------------------------------------------------------

def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = run_kernel(q, k, v)
    if out.numel():
        LAUNCHES["flash_attention"] += 1
    return out


def run_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               extra_flags: Tuple[str, ...] = ()) -> torch.Tensor:
    """The kernel built with ``extra_flags`` on contiguous float32 CUDA q, k, v;
    counts nothing (``flash_attention`` is the entry point)."""
    b, n, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel holds heads of at most {MAX_HEAD_DIM}, got {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = attention_library(*extra_flags).lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.skyeye_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), b, n, hd, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    return out


@torch.library.custom_op("skyeye::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4's forward as one operator: the kernel on CUDA, its plain version on the CPU."""
    return _forward(q, k, v)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.skyeye.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    b, n, hd = q_shape
    return 4 * b * n * k_shape[1] * hd  # q k^T and p v, 2 a multiply-add


class FlashAttention(torch.autograd.Function):
    """K4 with JAX's custom VJP: the forward is the kernel (or its plain version),
    the backward ``flash_attention_backward`` on the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, keep_for_backward: bool):
        if keep_for_backward:
            ctx.save_for_backward(q, k, v)
        return flash_attention_op(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_backward(*ctx.saved_tensors, g), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4: softmax(q k^T * hd^-0.5) v over (B, N, hd) float32 -> (B, N, hd) float32,
    differentiable through ``FlashAttention``."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, True)
    return flash_attention_op(q, k, v)
