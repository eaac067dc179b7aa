"""Primitive building blocks (NCHW): conv+BN+SiLU, bottleneck, CSP, SPP, Focus.

Port of ``skyeye_tpu/models/blocks.py`` on its serving path. Module and
attribute names follow the flax module names, so a flax variable path maps to
a ``state_dict`` key one to one (``utils/checkpoint.py``).

``dtype`` is flax's: parameters and the ``state_dict`` stay float32 and the
compute runs in ``dtype``. Convs and dense layers cast their input and weights
to it (``Conv2d``, ``Linear``). ``BatchNorm2d`` takes the conv's output in
``dtype`` beside its float32 statistics and parameters, normalises in float32
and returns ``dtype``, as flax's ``_normalize`` does.

Train mode is flax's too: ``BatchNorm2d`` keeps the biased batch variance in
its running statistics, and SPP's pools become JAX's shift-max chain, whose
gradient splits ties as ``jnp.maximum``'s does.

``remat(fn, *args)`` is the port of flax's ``nn.remat`` (JAX's training
memory lever): ``torch.utils.checkpoint`` without reentrancy, so ``fn``'s
activations are recomputed in the backward pass instead of kept. JAX's remat
is functional, a recompute changes no state; here the recompute runs the
same modules again, so ``BatchNorm2d`` reads a flag that the recompute sets
and leaves its running statistics and ``num_batches_tracked`` alone then (it
updated them once, in the forward). The wrapped regions hold no dropout, so
no random draw is replayed.

In a data-parallel step (``parallel.collectives.data_parallel``) a train-mode
``BatchNorm2d`` takes its statistics over the global batch, as flax's does
over a batch axis that GSPMD shards: ``SyncBatchNorm``, whose forward and
backward reduce over the group. A recompute runs the same collectives on
every rank, in the same order, and leaves the running statistics alone.

Under spatial sharding (``parallel.spatial.spatial_parallel``) each module
sees this rank's share of the image rows. Every windowed op reads the rows
its window needs from the neighbouring shares first (``conv_rows``: a k x k
conv with stride s and top padding p reads p rows above the share and
max(0, k - 1 - p - (s - 1)) below it, zeros past the image's edges, then
runs with no row padding; SPP's pools read 13 // 2 rows of -inf). A
``ConvBlock`` whose share is shorter than 4 rows runs its conv on the
gathered rows and keeps its own rows of the result, as JAX's
``_spatial_guard`` gathers such maps. BatchNorm reduces over the world.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import current_group, sync_batch_norm
from ..parallel.spatial import (
    MIN_ROWS_PER_SHARD, current_spatial, gather_spatial, halo_exchange, halo_rows, split_spatial,
)

_RECOMPUTE = threading.local()  # the autograd thread that runs a recompute sets it


def recomputing() -> bool:
    """Whether this thread runs the backward's recompute of a ``remat`` region."""
    return getattr(_RECOMPUTE, "on", False)


@contextlib.contextmanager
def _recompute_context():
    before = recomputing()
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


def _contexts():
    return contextlib.nullcontext(), _recompute_context()


def remat(fn, *args):
    """``fn(*args)``, with its activations recomputed in the backward pass
    instead of kept while autograd records; plainly ``fn(*args)`` otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_contexts)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in ``compute_dtype``
    (flax's ``nn.Conv(dtype=..., param_dtype=float32)``)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)

    def padded(self, x: torch.Tensor, pad) -> torch.Tensor:
        """The conv with ``pad`` = (left, right, top, bottom) zero padding in place
        of its own."""
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        left, right, top, bottom = pad
        if left == right and top == bottom:
            padding = (top, left)
        else:
            x, padding = F.pad(x, pad), 0
        return F.conv2d(x.to(d), self.weight.to(d), bias, self.stride, padding, self.dilation,
                        self.groups)


def conv_rows(conv: Conv2d, x: torch.Tensor, pad=None) -> torch.Tensor:
    """``conv`` over ``x`` zero-padded by ``pad`` = (left, right, top, bottom) (a
    conv built without padding), else with the conv's own padding. Under
    spatial sharding, over this rank's rows: the halo its window reads, then
    the conv without row padding (not through the module's call, so its
    forward hooks do not run); a share of fewer than ``MIN_ROWS_PER_SHARD``
    rows runs on the whole map and keeps its rows of the result."""
    if current_spatial() is None:
        return conv(x if pad is None else F.pad(x, pad))
    if pad is None:
        ph, pw = conv.padding
        pad = (pw, pw, ph, ph)
    if x.shape[2] < MIN_ROWS_PER_SHARD:
        return split_spatial(conv.padded(gather_spatial(x), pad))
    above, below = halo_rows(conv.kernel_size[0], conv.stride[0], pad[2])
    return conv.padded(halo_exchange(x, above, below), (pad[0], pad[1], 0, 0))


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``compute_dtype``
    (flax's ``nn.Dense(dtype=..., param_dtype=float32)``)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running variance is flax's: the biased
    batch variance (``nn.BatchNorm2d`` takes the unbiased one, n / (n - 1) of
    it). torch momentum 0.1 is flax momentum 0.9. The batch statistics that
    normalise, and their gradient, are torch's own; in a data-parallel step,
    those of the global batch (``SyncBatchNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = current_group()
        if group is not None:
            return self._synced(x, group)
        if recomputing():  # the same op on copies: the statistics stay as the forward left them
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        old = self.running_var.detach().clone()
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = 1.0 - self.momentum
            # torch added momentum * var * n / (n - 1) to keep * old: take it back to var.
            # Through .data: the train-mode backward reads the batch's own statistics,
            # not the running ones it was handed
            rv = self.running_var.data
            rv.copy_(keep * old + (rv - keep * old) * ((n - 1) / n))
        return y

    def _synced(self, x: torch.Tensor, group) -> torch.Tensor:
        y, mean, var = sync_batch_norm(x, self.weight, self.bias, self.eps, group)
        if not recomputing():  # flax's update, with the biased global variance
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
                self.running_var.mul_(keep).add_(var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        return y


class ConvBlock(nn.Module):
    """Conv2d (no bias) + BatchNorm (eps 1e-5) + SiLU, symmetric k//2 padding, or
    ``padding`` ((top, bottom), (left, right)) as flax's ConvBlock takes it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, dtype: torch.dtype = torch.float32, padding=None):
        super().__init__()
        self.pad = None if padding is None else (*padding[1], *padding[0])  # F.pad's order
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding=kernel_size // 2 if padding is None else 0, bias=False,
                           compute_dtype=dtype)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(conv_rows(self.conv, x, self.pad)))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with a residual when the channel counts match."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 expansion: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.cv1 = ConvBlock(in_channels, hidden, 1, dtype=dtype)
        self.cv2 = ConvBlock(hidden, out_channels, 3, dtype=dtype)
        self.add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CSPBlock(nn.Module):
    """Cross-stage-partial: split -> N bottlenecks || bypass -> concat -> 1x1."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.cv1 = ConvBlock(in_channels, hidden, 1, dtype=dtype)
        self.cv2 = ConvBlock(in_channels, hidden, 1, dtype=dtype)
        self.num_blocks = num_blocks
        for i in range(num_blocks):  # named m0, m1, ... as in flax
            self.add_module(f"m{i}", Bottleneck(hidden, hidden, shortcut, 1.0, dtype=dtype))
        self.cv3 = ConvBlock(2 * hidden, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cv1(x)
        for i in range(self.num_blocks):
            y1 = getattr(self, f"m{i}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class SPPBlock(nn.Module):
    """Spatial pyramid pooling: stride-1 max pools (k = 5, 9, 13), concat, 1x1."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_channels // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.cv1 = ConvBlock(in_channels, hidden, 1, dtype=dtype)
        self.cv2 = ConvBlock(hidden * (len(self.kernel_sizes) + 1), out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        h = x.shape[2]
        # under spatial sharding the pools run on the share and the rows their
        # windows read (-inf past the image, as the pools' own padding), and keep
        # the share's rows; else halo is 0 and xe is x
        halo = max(self.kernel_sizes) // 2 if current_spatial() is not None else 0
        xe = halo_exchange(x, halo, halo, fill=float("-inf"))
        if self.training:  # JAX's train path: incremental shift-max pools
            chain, prev_k = [xe], 1
            for k in self.kernel_sizes:
                grow = k - prev_k + 1
                chain.append(maxpool_same_shiftmax(chain[-1], grow) if grow >= 2 and prev_k > 1
                             else maxpool_same_shiftmax(xe, k))
                prev_k = k
            pools = [x] + [p.narrow(2, halo, h) for p in chain[1:]]
        elif halo:
            pools = [x] + [F.max_pool2d(xe.narrow(2, halo - k // 2, h + 2 * (k // 2)), k,
                                        stride=1, padding=(0, k // 2))
                           for k in self.kernel_sizes]
        else:  # max_pool2d pads with -inf, as flax's max_pool does
            pools = [x] + [F.max_pool2d(x, k, stride=1, padding=k // 2)
                           for k in self.kernel_sizes]
        return self.cv2(torch.cat(pools, dim=1))


def _shift_left(t: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """t shifted left by s along dim (2 or 3), the vacated tail -inf."""
    if s == 0:
        return t
    pad = (0, s, 0, 0) if dim == 3 else (0, 0, 0, s)
    return F.pad(t, pad, value=float("-inf")).narrow(dim, s, t.shape[dim])


def _window_max_1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """out[i] = max(x[i .. i + k - 1]) along dim by doubling spans."""
    m, span = x, 1
    while span * 2 <= k:
        m = torch.maximum(m, _shift_left(m, span, dim))
        span *= 2
    if span < k:
        m = torch.maximum(m, _shift_left(m, k - span, dim))
    return m


def maxpool_same_shiftmax(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 SAME k x k max pool (NCHW) as JAX's separable shift-max chain
    (``_maxpool_same_shiftmax``): the values of ``max_pool2d``, and a gradient
    of elementwise maxima, rows then columns."""
    p = k // 2
    out = x
    for dim in (2, 3):
        pad = (0, 0, p, 0) if dim == 2 else (p, 0, 0, 0)
        m = _window_max_1d(F.pad(out, pad, value=float("-inf")), k, dim)
        out = m.narrow(dim, 0, x.shape[dim])
    return out


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), patches in the order
    [top-left, bottom-left, top-right, bottom-right] (the JAX layout and order)."""
    return torch.cat(
        [x[:, ::2, ::2, :], x[:, 1::2, ::2, :], x[:, ::2, 1::2, :], x[:, 1::2, 1::2, :]],
        dim=-1,
    )


class FocusBlock(nn.Module):
    """Focus stem as one fused conv: space-to-depth 2x2 followed by a k x k conv
    equals a 2k x 2k stride-2 conv on the raw image with permuted weights."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kf = 2 * kernel_size
        self.conv = Conv2d(in_channels, out_channels, kf, stride=2,
                           padding=2 * (kernel_size // 2), bias=False, compute_dtype=dtype)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(conv_rows(self.conv, x)))
