"""FSDP (ZeRO-3) training state over the mesh's data axis.

Port of ``skyeye_tpu/parallel/fsdp.py``. JAX places every state leaf on a
sharding of its largest dimension divisible by the data axis and lets XLA
all-gather the weights for each use and reduce-scatter the gradients. The
port does the same with ``torch.distributed.fsdp.fully_shard`` (FSDP2):

  * ``leaf_sharding``: JAX's rule, as a DTensor placement: ``Shard(d)`` on
    the largest dimension that the axis size divides, else ``Replicate()``,
    the dimensions taken in JAX's order (a conv kernel's (kh, kw, in, out),
    a dense kernel's (in, out)), so that of two equal dimensions the one JAX
    picks is sharded;
  * ``shard_train_state``: the model's parameters become DTensors on those
    placements (``shard_placement_fn``; a parameter without a divisible
    dimension is left whole on every rank, ``ignored_params``), and the
    optimizer's momentum or moments, its accumulated gradient and the EMA
    are rebuilt as DTensors on their parameter's placement, so the
    optimizer's and the EMA's foreach arithmetic runs on each rank's shard;
  * gradients reach each shard summed over the group (a divide factor of 1,
    sum reductions: the partial losses of ``losses/detection.py`` sum to the
    global loss), and the step sums the replicated parameters' gradients
    itself (``train/trainer.py``);
  * ``jit_fsdp_step``: the step, checked after each call to have kept every
    sharded leaf on its placement (JAX pins ``out_shardings``).

BatchNorm's running statistics stay whole on every rank (JAX shards them
too): a few floats a channel, updated from statistics every rank shares.

A mesh with a spatial axis raises NotImplementedError (ROADMAP item 8c).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch import nn

from .mesh import DATA_AXIS, Mesh, replicated


CONV_LAYOUT = (2, 3, 1, 0)   # JAX's (kh, kw, in, out) in torch's (out, in, kh, kw) dims
DENSE_LAYOUT = (1, 0)        # JAX's (in, out) in torch's (out, in)


def leaf_sharding(mesh: Mesh, x: Any, axis: str = DATA_AXIS, layout=None):
    """The placement of one state tensor: ``(Shard(d),)`` on its largest
    dimension divisible by the axis size (conv kernels -> c_out, vectors -> channels),
    ``(Replicate(),)`` when none is (scalars, small heads). ``layout``: JAX's
    dimensions in order, as dimensions of ``x`` (``CONV_LAYOUT`` for a conv
    weight, ``DENSE_LAYOUT`` for a dense one); default ``x``'s own order."""
    from torch.distributed.tensor import Shard

    n = int(mesh.shape[axis])
    shape = tuple(getattr(x, "shape", ()))
    if n <= 1 or not shape:
        return replicated(mesh)
    order = tuple(layout) if layout is not None else tuple(range(len(shape)))
    jshape = [shape[d] for d in order]
    for j in sorted(range(len(jshape)), key=lambda i: jshape[i], reverse=True):
        if jshape[j] >= n and jshape[j] % n == 0:
            return (Shard(order[j]),)
    return replicated(mesh)


def param_layouts(model: nn.Module) -> Dict[str, tuple]:
    """Parameter name -> its JAX layout (``leaf_sharding``'s ``layout``), for the
    conv and dense weights; other parameters keep their own order."""
    out = {}
    for mod_name, mod in model.named_modules():
        layout = (CONV_LAYOUT if isinstance(mod, nn.Conv2d)
                  else DENSE_LAYOUT if isinstance(mod, nn.Linear) else None)
        if layout is not None and getattr(mod, "weight", None) is not None:
            out[f"{mod_name}.weight" if mod_name else "weight"] = layout
    return out


def _sharded(placement) -> bool:
    from torch.distributed.tensor import Shard

    return isinstance(placement[0], Shard)


def state_shardings(mesh: Mesh, state, axis: str = DATA_AXIS) -> Dict[str, Any]:
    """Placement per state tensor, by name: ``model:<param>``, ``ema:<param>``
    and ``opt.<field>:<param>`` (the optimizer's tensors mirror their parameter's
    shape, so one rule shards them alike)."""
    layouts = param_layouts(state.model)
    out = {}
    for k, p in state.model.named_parameters():
        out[f"model:{k}"] = leaf_sharding(mesh, p, axis, layouts.get(k))
    for k, t in state.ema.params.items():
        out[f"ema:{k}"] = leaf_sharding(mesh, t, axis, layouts.get(k))
    for field, tensors in _opt_tensors(state.opt).items():
        for k, t in tensors.items():
            out[f"opt.{field}:{k}"] = leaf_sharding(mesh, t, axis, layouts.get(k))
    return out


def _opt_tensors(opt) -> Dict[str, Dict[str, torch.Tensor]]:
    fields = ("mu", "nu") if opt.adam else ("trace",)
    fields += ("acc_grads",) if opt.acc_grads is not None else ()
    return {f: getattr(opt, f) for f in fields}


def _like(t: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``t`` (whole, equal on every rank) as a DTensor on ``param``'s mesh and
    placement, each rank keeping its own chunk (no collective); ``t`` itself
    where ``param`` is not sharded."""
    from torch.distributed.tensor import DTensor

    if not isinstance(param, DTensor):
        return t
    mesh, placement = param.device_mesh, param.placements[0]
    chunk = t.detach().to(param.device).chunk(mesh.size(), placement.dim)[mesh.get_local_rank()]
    return DTensor.from_local(chunk.clone(), mesh, param.placements, run_check=False)


def fsdp_with_spatial_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "FSDP over a mesh with a spatial axis is not ported: it needs FSDP2 over the data "
        "dimension of the 2-D mesh with the gradients summed over the spatial one "
        "(ROADMAP.md, Queue 1 item 8c)")


def shard_train_state(mesh: Mesh, state, axis: str = DATA_AXIS):
    """Shard ``state`` (``train.TrainState``) over ``mesh``'s data axis in
    place, as above; returns it. Every rank must hold the same state."""
    from torch.distributed.fsdp import fully_shard

    if mesh.device_mesh is None:
        raise ValueError("FSDP needs a mesh over a process group (initialize_distributed)")
    if mesh.n_spatial > 1:
        raise fsdp_with_spatial_not_ported()
    layouts = param_layouts(state.model)
    placements = {p: leaf_sharding(mesh, p, axis, layouts.get(k))
                  for k, p in state.model.named_parameters()}
    ignored = {p for p, pl in placements.items() if not _sharded(pl)}
    fully_shard(state.model, mesh=mesh.device_mesh[axis],
                shard_placement_fn=lambda p: placements[p][0], ignored_params=ignored)
    state.model.set_gradient_divide_factor(1.0)
    state.model.set_force_sum_reduction_for_comms(True)  # gloo has no pre-scaled sum
    params = dict(state.model.named_parameters())
    for tensors in _opt_tensors(state.opt).values():
        for k in list(tensors):
            tensors[k] = _like(tensors[k], params[k])
    for k in list(state.ema.params):
        state.ema.params[k] = _like(state.ema.params[k], params[k])
    return state


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective every rank must join); another
    tensor as it is. Through ``all_gather`` of the shards (``leaf_sharding``
    shards only dimensions the axis divides, so they are equal):
    ``DTensor.full_tensor``'s functional collectives crash with SIGSEGV over
    gloo on CUDA tensors (torch 2.11 on the card)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    local, placement = t.to_local(), t.placements[0]
    if not isinstance(placement, Shard):
        return local
    group = t.device_mesh.get_group()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, placement.dim)


def full_tensors(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each DTensor gathered whole (``whole``); other tensors as they are."""
    return {k: whole(v) for k, v in tensors.items()}


def check_placements(mesh: Mesh, state, axis: str = DATA_AXIS) -> None:
    """Raise unless every parameter, optimizer tensor and EMA tensor that
    ``leaf_sharding`` shards is a DTensor on that placement."""
    from torch.distributed.tensor import DTensor

    want = state_shardings(mesh, state, axis)
    named = {f"model:{k}": p for k, p in state.model.named_parameters()}
    named.update({f"ema:{k}": t for k, t in state.ema.params.items()})
    for field, tensors in _opt_tensors(state.opt).items():
        named.update({f"opt.{field}:{k}": t for k, t in tensors.items()})
    for name, t in named.items():
        pl = want[name]
        if _sharded(pl) and not (isinstance(t, DTensor) and tuple(t.placements) == tuple(pl)):
            got = tuple(t.placements) if isinstance(t, DTensor) else "a whole tensor"
            raise RuntimeError(f"FSDP state {name} left its placement {pl}: {got}")


def jit_fsdp_step(step_fn: Callable, mesh: Mesh, state, axis: str = DATA_AXIS) -> Callable:
    """``step_fn`` over a state sharded by ``shard_train_state``, with the
    placements checked after every step (JAX pins them as the jitted step's
    ``out_shardings``)."""
    def step(st, batch):
        st, metrics = step_fn(st, batch)
        check_placements(mesh, st, axis)
        return st, metrics

    return step
