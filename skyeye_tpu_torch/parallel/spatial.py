"""Spatial sharding: image rows split over the mesh's spatial axis.

JAX shards an image batch's rows over a "spatial" mesh axis and lets GSPMD
insert each windowed op's halo exchange. The port writes that traffic
itself. Inside ``spatial_parallel(group, n, rank)`` every activation of the
model is this rank's share of the image rows: rows ``[rank * h, (rank + 1) *
h)`` of a map of ``n * h`` rows, at every pyramid level (the mesh requires
H to be a multiple of 32 n, so every stride keeps the shares aligned). The
differentiable collectives, each an ``autograd.Function`` whose backward is
the transpose of its forward:

  * ``halo_exchange(x, above, below, fill)``: this rank's rows with the
    ``above`` rows before them and the ``below`` rows after them, taken
    from the neighbouring shares, ``fill`` (zero: a conv's padding; -inf: a
    max pool's) past the image's top and bottom. Backward: the halo rows'
    gradients go back to the ranks that own the rows and are added there;
  * ``gather_spatial(x)``: the whole map, every share in rank order.
    Backward: each rank gets the sum over the group of its rows' gradients;
  * ``split_spatial(x)``: this rank's rows of a whole map. Backward: the
    gradient in this rank's rows, zeros elsewhere;
  * ``spatial_sum`` / ``spatial_max``: a tensor reduced over the group (the
    pooled statistics of channel attention).

Each exchange is one ``all_gather`` in the spatial group (the edge rows of
every rank), not point-to-point sends: gloo's point-to-point ops do not take
CUDA tensors, and one code path then serves gloo and NCCL alike. When a halo
is deeper than a share (a 13 x 13 pool on a share of 4 rows), the whole map
is gathered instead.

The gradient convention is the data-parallel step's: every rank's partial
loss depends on its own rows, and the sum over the ranks of each
parameter's gradient is the gradient of the global loss.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

MIN_ROWS_PER_SHARD = 4  # JAX's ``_spatial_guard``: shorter shares run on gathered rows
ROWS = 2  # NCHW's H, the dimension the shares split


@dataclass(frozen=True)
class SpatialShare:
    """The spatial group, its size and this process's index in it."""

    group: object
    n: int
    rank: int


_STATE = {"share": None}


@contextlib.contextmanager
def spatial_parallel(group, n: int, rank: int):
    """Run the enclosed forward and backward on this rank's image rows, the
    rows split over ``group`` (``n`` ranks; this one is ``rank``). With ``n``
    1 (or ``group`` None) it changes nothing. A module global, as
    ``collectives.data_parallel``: the CUDA backward runs on autograd's own
    thread."""
    before = _STATE["share"]
    _STATE["share"] = SpatialShare(group, int(n), int(rank)) if group is not None and n > 1 \
        else None
    try:
        yield
    finally:
        _STATE["share"] = before


def current_spatial() -> Optional[SpatialShare]:
    """The spatial split being run, or None."""
    return _STATE["share"]


def halo_rows(kernel: int, stride: int, pad_top: int) -> tuple:
    """(rows above, rows below) a share must read for a window of ``kernel``
    rows at ``stride`` with ``pad_top`` rows of padding above the image,
    when the share starts at a multiple of ``stride``: output row o reads
    input rows o s - p .. o s - p + k - 1."""
    return pad_top, max(0, (kernel - 1 - pad_top) - (stride - 1))


def _all_gather(t: torch.Tensor, group) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above: int, below: int, fill: float, share: SpatialShare):
        dim = ROWS
        h, n, r = x.shape[dim], share.n, share.rank
        ctx.meta = (above, below, share, h)
        if above <= h and below <= h:  # the neighbours' edge rows, one all_gather
            send = torch.cat([x.narrow(dim, h - above, above), x.narrow(dim, 0, below)], dim)
            parts = _all_gather(send, share.group)

            def edge(q, start, rows):
                if 0 <= q < n:
                    return parts[q].narrow(dim, start, rows)
                shape = list(x.shape)
                shape[dim] = rows
                return x.new_full(shape, fill)

            return torch.cat([edge(r - 1, 0, above), x, edge(r + 1, above, below)], dim)
        whole = torch.cat(_all_gather(x, share.group), dim)  # a halo deeper than a share
        shape = list(x.shape)
        shape[dim] = above
        top = x.new_full(shape, fill)
        shape[dim] = below
        padded = torch.cat([top, whole, x.new_full(shape, fill)], dim)
        return padded.narrow(dim, r * h, h + above + below).clone()

    @staticmethod
    def backward(ctx, g):
        above, below, share, h = ctx.meta
        n, r, dim = share.n, share.rank, ROWS
        if above <= h and below <= h:
            gx = g.narrow(dim, above, h).clone()
            send = torch.cat([g.narrow(dim, 0, above), g.narrow(dim, above + h, below)], dim)
            parts = _all_gather(send, share.group)
            if r + 1 < n and above:  # the next share's rows above it are this share's last
                gx.narrow(dim, h - above, above).add_(parts[r + 1].narrow(dim, 0, above))
            if r > 0 and below:  # the previous share's rows below it are this share's first
                gx.narrow(dim, 0, below).add_(parts[r - 1].narrow(dim, above, below))
            return gx, None, None, None, None
        shape = list(g.shape)
        shape[dim] = n * h + above + below
        buf = g.new_zeros(shape)
        buf.narrow(dim, r * h, h + above + below).copy_(g)
        buf = _all_reduce(buf, share.group)
        return buf.narrow(dim, above + r * h, h).clone(), None, None, None, None


def halo_exchange(x: torch.Tensor, above: int, below: int, fill: float = 0.0) -> torch.Tensor:
    """This rank's rows of an NCHW map with ``above`` rows of the previous shares
    before them and ``below`` rows of the next shares after them; ``fill``
    past the image's edges. ``x`` itself outside ``spatial_parallel`` or when
    no halo is asked for."""
    share = current_spatial()
    if share is None or (above == 0 and below == 0):
        return x
    return _Halo.apply(x, int(above), int(below), float(fill), share)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share: SpatialShare):
        ctx.meta = (share, x.shape[ROWS])
        return torch.cat(_all_gather(x, share.group), ROWS)

    @staticmethod
    def backward(ctx, g):
        share, h = ctx.meta
        total = _all_reduce(g, share.group)
        return total.narrow(ROWS, share.rank * h, h).clone(), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share: SpatialShare):
        whole = x.shape[ROWS]
        if whole % share.n:
            raise ValueError(f"{whole} rows do not split evenly over {share.n} spatial ranks")
        h = whole // share.n
        ctx.meta = (share, whole, h)
        return x.narrow(ROWS, share.rank * h, h).clone()

    @staticmethod
    def backward(ctx, g):
        share, whole, h = ctx.meta
        shape = list(g.shape)
        shape[ROWS] = whole
        out = g.new_zeros(shape)
        out.narrow(ROWS, share.rank * h, h).copy_(g)
        return out, None


def gather_spatial(x: torch.Tensor) -> torch.Tensor:
    """The whole NCHW map from every rank's rows, in rank order; ``x`` outside
    ``spatial_parallel``."""
    share = current_spatial()
    return x if share is None else _Gather.apply(x, share)


def split_spatial(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole NCHW map; ``x`` outside ``spatial_parallel``."""
    share = current_spatial()
    return x if share is None else _Split.apply(x, share)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share: SpatialShare):
        ctx.share = share
        return _all_reduce(x, share.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.share.group), None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share: SpatialShare):
        top = _all_reduce(x.detach(), share.group, dist.ReduceOp.MAX)
        ctx.share = share
        ctx.save_for_backward(x, top)
        return top

    @staticmethod
    def backward(ctx, g):
        x, top = ctx.saved_tensors
        holds = (x == top).to(g.dtype)
        # the gradient of every rank's copy, split among the ranks that hold the maximum
        total = _all_reduce(torch.stack([g, holds]), ctx.share.group)
        return total[0] * holds / total[1].clamp(min=1.0), None


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the spatial group (every rank gets the sum)."""
    share = current_spatial()
    return x if share is None else _Sum.apply(x, share)


def spatial_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the spatial group; the gradient goes
    to the ranks that hold it (split evenly among them)."""
    share = current_spatial()
    return x if share is None else _Max.apply(x, share)
