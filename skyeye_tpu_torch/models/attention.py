"""CBAM attention (NCHW) and the transformer layer of the P5 head (tokens).

Port of ``ChannelAttention``, ``SpatialAttention``, ``CBAM``,
``MultiHeadSelfAttention`` and ``TransformerLayer`` in
``skyeye_tpu/models/attention.py``. Multi-head attention over 256 tokens or
more, with no mask or bias, runs through the fused kernel (K4,
``ops/attention_kernel.py``), as the JAX module's flash gate does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_kernel import MAX_HEAD_DIM, flash_attention

FLASH_MIN_TOKENS = 256  # the JAX gate: below it the einsum path runs


def takes_flash_path(n: int, hd: int, mask, bias) -> bool:
    """The shape rule of the fused path: JAX's gate (no mask or bias, 256 tokens
    or more) and heads the kernel holds."""
    return mask is None and bias is None and n >= FLASH_MIN_TOKENS and hd <= MAX_HEAD_DIM


class ChannelAttention(nn.Module):
    """SE-style gate: (avg-pool + max-pool) -> shared MLP -> sigmoid."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        reduced = max(channels // reduction_ratio, 1)
        self.fc1 = nn.Linear(channels, reduced, bias=False)
        self.fc2 = nn.Linear(reduced, channels, bias=False)

    def _mlp(self, v: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(v)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3))
        mx = x.amax(dim=(2, 3))
        gate = torch.sigmoid(self._mlp(avg) + self._mlp(mx))
        return x * gate[:, :, None, None]


class SpatialAttention(nn.Module):
    """Channel-mean/max maps -> k x k conv -> sigmoid gate."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(stats))


class CBAM(nn.Module):
    """Sequential channel then spatial attention."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.channel = ChannelAttention(channels, reduction_ratio)
        self.spatial = SpatialAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial(self.channel(x))


class MultiHeadSelfAttention(nn.Module):
    """MHSA over (B, N, C) tokens: one fused qkv GEMM whose output splits as
    (N, 3, heads, hd), the attention core, and an output projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

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
            out = out.to(x.dtype)
        else:
            logits = torch.einsum("bqhc,bkhc->bhqk", q, k) * hd ** -0.5
            if bias is not None:
                logits = logits + bias
            if mask is not None:
                logits = logits + mask
            attn = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
            out = torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, n, c)
        return self.proj(out)


class TransformerLayer(nn.Module):
    """Pre-norm MHSA + ReLU FFN (width 4 C) over (B, N, C) tokens; LayerNorm eps
    1e-6 and dropout 0.1 as in flax (dropout is the identity in eval)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadSelfAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.ff1 = nn.Linear(dim, 4 * dim)
        self.ff2 = nn.Linear(4 * dim, dim)
        self.dropout = nn.Dropout(0.1)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t + self.dropout(self.attn(self.norm1(t)))
        y = self.dropout(F.relu(self.ff1(self.norm2(t))))
        return t + self.dropout(self.ff2(y))
