"""The collectives of a data-parallel step, and the group they run over.

Under GSPMD, JAX's step over a batch sharded on the data axis computes what
one device computes on the global batch: BatchNorm takes its statistics
over the global batch, the loss divides by the global batch's sums, and the
gradient is the global one. The port's step makes the same three
reductions explicit over the data axis's process group:

  * ``data_parallel(group)``: the context the step's forward and backward run
    in; ``models/blocks.py::BatchNorm2d`` and ``losses/detection.py`` read
    ``current_group()`` and reduce over it;
  * ``SyncBatchNorm``: train-mode batch statistics over the group (two-pass,
    centred variance), and the backward's two sums over the group too;
  * ``all_reduce_sum``: the loss's normalisers, summed over the group;
  * ``all_reduce_flat``: the gradients (and the step's metrics) in one
    flat sum.

Outside the context every one of these is the identity, so a single-card
step runs the code it ran before.

Under spatial sharding (``parallel/spatial.py``) each rank holds some image
rows of its data share: the step runs in ``data_parallel`` over the world
(both mesh axes), so BatchNorm's statistics, the loss's normalisers and the
gradient sum take every rank's rows of every image, as JAX's synced BN over
sharded spatial rows does. Inside ``spatial_parallel`` alone, with no
``data_parallel`` around it, they run over the spatial group.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist

from .spatial import current_spatial

_STATE = {"group": None}


@contextlib.contextmanager
def data_parallel(group):
    """Run the enclosed forward and backward data-parallel over ``group``
    (None: not at all). A plain module global, not thread-local: the CUDA
    backward, and a remat region's recompute in it, run on autograd's own
    device thread."""
    before = _STATE["group"]
    _STATE["group"] = group
    try:
        yield
    finally:
        _STATE["group"] = before


def current_group():
    """The process group of the data-parallel step being run; else, inside
    ``spatial_parallel``, the spatial group; else None."""
    if _STATE["group"] is not None:
        return _STATE["group"]
    share = current_spatial()
    return share.group if share is not None else None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group`` (default: the current one); ``t`` itself
    outside a data-parallel step. Not differentiable: for normalisers and
    statistics."""
    group = current_group() if group is None else group
    if group is None:
        return t
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, through one flat buffer (one
    collective for all of them). Tensors of one dtype and device."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation over the global batch of ``group``.

    Forward: mean = sum(x) / N over the group, then var = sum((x - mean)^2) /
    N over the group (flax's two-pass variance, ``use_fast_variance=False``),
    y = (x - mean) * rsqrt(var + eps) * weight + bias in float32 (float64 for
    a float64 x), returned in x's dtype. Returns (y, mean, var), mean and var
    for the running statistics.

    Backward: the gradient of the sum of every rank's loss. With xhat the
    normalised input and g the incoming gradient, the sums of g and of g *
    xhat are taken over the group (one collective), and
    dx = weight * rsqrt(var + eps) * (g - sum(g) / N - xhat * sum(g xhat) / N);
    the weight's and bias's gradients are this rank's own sums (the step sums
    parameter gradients over the group afterwards).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        dims = [d for d in range(x.dim()) if d != 1]
        count = torch.tensor([xf.numel() // c], dtype=xf.dtype, device=x.device)
        first = torch.cat([xf.sum(dims), count])
        dist.all_reduce(first, group=group)
        n = first[c]
        mean = first[:c] / n
        shape = [1, c] + [1] * (x.dim() - 2)
        xc = xf - mean.view(shape)
        sq = (xc * xc).sum(dims)
        dist.all_reduce(sq, group=group)
        var = sq / n
        invstd = torch.rsqrt(var + eps)
        y = xc * invstd.view(shape) * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, c] + [1] * (x.dim() - 2)
        g = gy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        grad_bias, grad_weight = local[:c].clone(), local[c:].clone()
        dist.all_reduce(local, group=ctx.group)
        sum_g, sum_gx = local[:c] / n, local[c:] / n
        dx = (weight * invstd).view(shape) * (g - sum_g.view(shape) - xhat * sum_gx.view(shape))
        return dx.to(x.dtype), grad_weight, grad_bias, None, None


def sync_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                    group) -> tuple:
    """(y, mean, var): ``SyncBatchNorm`` over ``group``."""
    return SyncBatchNorm.apply(x, weight, bias, eps, group)


def broadcast_object(obj, group=None, src: int = 0):
    """``obj`` of global rank ``src``, on every process (``obj`` itself without a
    process group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the first dimension, in rank order
    (the same shape on every rank)."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out, 0)
