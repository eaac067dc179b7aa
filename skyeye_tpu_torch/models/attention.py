"""CBAM attention (NCHW): channel gate, then spatial gate.

Port of ``ChannelAttention``, ``SpatialAttention`` and ``CBAM`` in
``skyeye_tpu/models/attention.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
