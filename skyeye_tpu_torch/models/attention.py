"""CBAM attention and the enhanced variant's cross-layer attention (NCHW), and
the transformer layer of the P5 head (tokens).

Port of ``ChannelAttention``, ``SpatialAttention``, ``CBAM``,
``CrossLayerAttention`` (with ``_bilinear_resize``), ``MultiHeadSelfAttention``
and ``TransformerLayer`` in ``skyeye_tpu/models/attention.py``. Multi-head
attention over 256 tokens or more, with no mask or bias, runs through the fused
kernel (K4, ``ops/attention_kernel.py``) in float32 whatever ``dtype`` is, as
the JAX module's flash gate does. Every module computes in ``dtype`` with
float32 parameters (flax's ``dtype``/``param_dtype``); LayerNorm normalises in
float32 and the softmaxes run where flax runs them.

Under spatial sharding (``parallel.spatial``) each module holds this rank's
image rows: channel attention's mean and max over H x W are reduced over the
spatial group, spatial attention's 7 x 7 conv reads 3 halo rows each side,
and cross-layer attention gathers the coarser level's K/V, resizes it whole
and reads its own rows and the shift's row below. The transformer layer of
the P5 head runs on gathered tokens (``models/head.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_kernel import MAX_HEAD_DIM, flash_attention
from ..parallel.spatial import current_spatial, gather_spatial, spatial_max, spatial_sum, \
    split_spatial
from .blocks import Conv2d, Linear, conv_rows

FLASH_MIN_TOKENS = 256  # the JAX gate: below it the einsum path runs


def takes_flash_path(n: int, hd: int, mask, bias) -> bool:
    """The shape rule of the fused path: JAX's gate (no mask or bias, 256 tokens
    or more) and heads the kernel holds."""
    return mask is None and bias is None and n >= FLASH_MIN_TOKENS and hd <= MAX_HEAD_DIM


class ChannelAttention(nn.Module):
    """SE-style gate: (avg-pool + max-pool) -> shared MLP -> sigmoid."""

    def __init__(self, channels: int, reduction_ratio: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        reduced = max(channels // reduction_ratio, 1)
        self.fc1 = Linear(channels, reduced, bias=False, compute_dtype=dtype)
        self.fc2 = Linear(reduced, channels, bias=False, compute_dtype=dtype)

    def _mlp(self, v: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(v)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        share = current_spatial()
        if share is None:
            avg = x.mean(dim=(2, 3))
        else:  # over every rank's rows
            avg = spatial_sum(x.sum(dim=(2, 3))) / (x.shape[2] * share.n * x.shape[3])
        mx = spatial_max(x.amax(dim=(2, 3)))
        gate = torch.sigmoid(self._mlp(avg) + self._mlp(mx))
        return x * gate[:, :, None, None]


class SpatialAttention(nn.Module):
    """Channel-mean/max maps -> k x k conv -> sigmoid gate."""

    def __init__(self, kernel_size: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False,
                           compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(conv_rows(self.conv, stats))


class CBAM(nn.Module):
    """Sequential channel then spatial attention."""

    def __init__(self, channels: int, reduction_ratio: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channel = ChannelAttention(channels, reduction_ratio, dtype=dtype)
        self.spatial = SpatialAttention(dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial(self.channel(x))


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NCHW bilinear resize as ``jax.image.resize(..., "bilinear")``: half-pixel
    centres, edges clamped, and the triangle kernel widened along an axis that
    shrinks (JAX's antialiasing, which PyTorch computes only in float32 and up)."""
    if out_h >= x.shape[2] and out_w >= x.shape[3]:
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False)
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    return F.interpolate(wide, size=(out_h, out_w), mode="bilinear", align_corners=False,
                         antialias=True).to(x.dtype)


class CrossLayerAttention(nn.Module):
    """Local-region multi-head cross-attention between pyramid levels (NCHW).

    The query comes from the finer level; K and V from the coarser level,
    projected, resized to the query grid and shifted (edges replicated) over a
    ``region_size`` x ``region_size`` neighbourhood, offsets from
    ``-(r - 1) // 2``. Each head's logits use the first min(hq, hk) channels of
    its query and key heads, scaled by 1 / sqrt(query_channels); the softmax
    runs over the r^2 positions. A channel index is head * head_width + c, as
    flax's reshape of NHWC gives it.

    ``ref_exact``: the reference's repaired semantics (``skyeye_tpu``'s
    ``CrossLayerAttention.ref_exact``): q projected to ``key_channels``, one
    resized K/V, the softmax over image rows, the output scaled by r^2.

    The shifts are taken one at a time rather than stacked, so no (B, r^2, C, H,
    W) tensor is made; the sums are JAX's in another order.
    """

    def __init__(self, query_channels: int, key_channels: int,
                 value_channels: Optional[int] = None, region_size: int = 2,
                 output_channels: Optional[int] = None, heads: int = 4,
                 ref_exact: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query_channels, self.key_channels = query_channels, key_channels
        self.value_channels = value_channels or key_channels
        self.region_size, self.heads, self.ref_exact, self.dtype = (
            region_size, heads, ref_exact, dtype)
        q_out = key_channels if ref_exact else query_channels
        out_ch = output_channels or query_channels
        self.q_proj = Conv2d(query_channels, q_out, 1, compute_dtype=dtype)
        self.k_proj = Conv2d(key_channels, key_channels, 1, compute_dtype=dtype)
        self.v_proj = Conv2d(key_channels, self.value_channels, 1, compute_dtype=dtype)
        self.out_proj = Conv2d(self.value_channels, out_ch, 1, compute_dtype=dtype)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: Optional[torch.Tensor] = None) -> torch.Tensor:
        value = key if value is None else value
        n, r = self.heads, self.region_size
        scale = 1.0 / float(np.sqrt(self.query_channels))
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        share = current_spatial()
        row0, rows = 0, q.shape[2]  # the query's first row in the whole map, its rows
        if share is not None:  # K/V whole on every rank; the query its own rows
            k, v, rows = gather_spatial(k), gather_spatial(v), q.shape[2] * share.n
            if self.ref_exact:  # its softmax runs over every row
                q = gather_spatial(q)
            else:
                row0 = share.rank * q.shape[2]
        b, _, h, w = q.shape
        k = bilinear_resize(k, rows, w)
        v = bilinear_resize(v, rows, w)
        heads = lambda t: t.reshape(b, n, t.shape[1] // n, t.shape[2], w)  # noqa: E731
        if self.ref_exact:
            scores = (heads(q) * heads(k)).sum(dim=2) * scale          # (B, n, H, W)
            attn = torch.softmax(scores.float(), dim=2)                # over image rows
            out = (float(r * r) * attn[:, :, None]).to(self.dtype) * heads(v)
            return self.out_proj(split_spatial(out.reshape(b, self.value_channels, h, w)))

        lo = -(r - 1) // 2
        shifts = [(lo + i, lo + j) for i in range(r) for j in range(r)]
        at_rows = [(torch.arange(row0, row0 + h, device=q.device) - dy).clamp(0, rows - 1)
                   for dy, _ in shifts]
        at_cols = [(torch.arange(w, device=q.device) - dx).clamp(0, w - 1) for _, dx in shifts]

        def shifted(t, i):  # t[..., y - dy, x - dx], edges replicated
            return t.index_select(-2, at_rows[i]).index_select(-1, at_cols[i])

        qh = heads(q)
        d = min(qh.shape[2], self.key_channels // n)
        kh = heads(k)[:, :, :d]
        logits = torch.stack([(qh[:, :, :d] * shifted(kh, i)).sum(dim=2)
                              for i in range(len(shifts))], dim=1) * scale  # (B, r^2, n, H, W)
        attn = torch.softmax(logits, dim=1)
        vh = heads(v)
        out = sum(attn[:, i, :, None] * shifted(vh, i) for i in range(len(shifts)))
        return self.out_proj(out.reshape(b, self.value_channels, h, w))


class MultiHeadSelfAttention(nn.Module):
    """MHSA over (B, N, C) tokens: one fused qkv GEMM whose output splits as
    (N, 3, heads, hd), the attention core, and an output projection."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Linear(dim, 3 * dim, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, hd).unbind(2)
        if takes_flash_path(n, hd, mask, bias):
            def heads_first(t):
                return t.transpose(1, 2).reshape(b * self.num_heads, n, hd).float().contiguous()

            out = flash_attention(heads_first(q), heads_first(k), heads_first(v))
            out = out.reshape(b, self.num_heads, n, hd).transpose(1, 2).reshape(b, n, c)
            out = out.to(self.dtype)
        else:
            logits = torch.einsum("bqhc,bkhc->bhqk", q, k) * hd ** -0.5
            if bias is not None:
                logits = logits + bias
            if mask is not None:
                logits = logits + mask
            attn = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
            out = torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, n, c)
        return self.proj(out)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` as flax's: statistics and normalisation in float32 (or
    wider), the result in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = x.to(torch.promote_types(x.dtype, torch.float32))
        return super().forward(wide).to(self.compute_dtype)


class Dropout(nn.Module):
    """Dropout as flax's: keep with probability 1 - p, kept values / (1 - p).
    The mask is drawn from ``generator``, which the train step sets (one a
    step, as JAX folds the step into its key); in train mode with p > 0 and
    no generator it raises rather than draw from the global RNG."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: "
                               "train.trainer.set_dropout_generator sets one")
        keep = 1.0 - self.p
        kept = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class TransformerLayer(nn.Module):
    """Pre-norm MHSA + ReLU FFN (width 4 C) over (B, N, C) tokens; LayerNorm eps
    1e-6 and dropout 0.1 as in flax (dropout is the identity in eval)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, compute_dtype=dtype)
        self.attn = MultiHeadSelfAttention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, compute_dtype=dtype)
        self.ff1 = Linear(dim, 4 * dim, compute_dtype=dtype)
        self.ff2 = Linear(4 * dim, dim, compute_dtype=dtype)
        self.dropout = Dropout(0.1)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t + self.dropout(self.attn(self.norm1(t)))
        y = self.dropout(F.relu(self.ff1(self.norm2(t))))
        return t + self.dropout(self.ff2(y))
