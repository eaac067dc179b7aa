"""The mesh, process-group set-up and batch placement of multi-device runs.

Port of ``skyeye_tpu/parallel/mesh.py``. JAX runs one controller over a
``Mesh`` of devices and lets XLA insert the collectives; the port runs one
process per card in a ``torch.distributed`` process group (NCCL between
CUDA cards, gloo on the CPU) and issues the collectives itself
(``parallel/collectives.py``). The names are JAX's:

  * ``create_mesh``: in a process group, a ``Mesh`` over every process, its
    ``device_mesh`` a ``DeviceMesh`` with JAX's ("data", "spatial") axes,
    the ranks laid out as JAX's ``np.array(devices).reshape(n_data,
    n_spatial)`` (global rank d * n_spatial + s); ``group`` is the data
    axis's process group (what FSDP shards over and the device augmentation
    gathers over), ``spatial_group`` the spatial axis's and ``world_group``
    both axes'. In a single process (a server that keeps one model replica
    per card), a ``Mesh`` of local devices with no group. Either way
    ``mesh.shape[DATA_AXIS]`` is the number of batch shares;
  * ``shard_batch`` / ``shard_batch_multihost``: the rows each device holds
    (with ``spatial=True``, its data share's image rows
    ``[s H / n, (s + 1) H / n)`` of every 4-d array, JAX's
    ``addressable_shards``);
  * ``replicate_multihost``: rank 0's values on every rank, checked;
  * ``batch_sharding`` / ``replicated``: the DTensor placements of a batch
    and of a replicated tensor.

Spatial shares must be even: H a multiple of 32 n_spatial, so every level of
the pyramid splits into whole rows (``check_spatial_rows``; GSPMD pads an
uneven split instead).
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
DEFAULT_TIMEOUT_S = 600.0


SPATIAL_ROW_MULTIPLE = 32  # the deepest stride: every level's share is whole rows


def check_spatial_rows(height: int, n_spatial: int) -> None:
    """Raise ValueError unless ``height`` rows split evenly into ``n_spatial``
    shares at every level of the pyramid (a multiple of 32 n_spatial)."""
    if n_spatial > 1 and height % (SPATIAL_ROW_MULTIPLE * n_spatial):
        raise ValueError(
            f"spatial sharding splits {height} image rows over {n_spatial} ranks only when "
            f"they are a multiple of {SPATIAL_ROW_MULTIPLE} x {n_spatial} = "
            f"{SPATIAL_ROW_MULTIPLE * n_spatial}, so that every pyramid level splits into "
            "whole rows")


class Mesh:
    """A ("data", "spatial") mesh: ``shape`` maps each axis name to its size, as
    JAX's ``Mesh.shape`` does; ``devices`` are this process's devices in
    data-major order (one per process in a process group); ``device_mesh`` is
    the ``DeviceMesh`` and ``group``, ``spatial_group`` and ``world_group`` the
    process groups of the data axis, the spatial axis and both, None in a
    single process."""

    def __init__(self, devices: Sequence[torch.device], n_data: int, device_mesh=None,
                 n_spatial: int = 1):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.shape: Dict[str, int] = {DATA_AXIS: int(n_data), SPATIAL_AXIS: int(n_spatial)}
        self.device_mesh = device_mesh
        self.group = self.spatial_group = self.world_group = None
        if device_mesh is not None:
            self.group = device_mesh.get_group(DATA_AXIS)
            if n_spatial > 1:
                self.spatial_group = device_mesh.get_group(SPATIAL_AXIS)
                self.world_group = dist.group.WORLD
            else:
                self.world_group = self.group

    @property
    def rank(self) -> int:
        """This process's index on the data axis (0 in a single process)."""
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def spatial_rank(self) -> int:
        """This process's index on the spatial axis (0 without one)."""
        return dist.get_rank(self.spatial_group) if self.spatial_group is not None else 0

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_spatial(self) -> int:
        return self.shape[SPATIAL_AXIS]

    def __repr__(self) -> str:
        where = "process group" if self.group is not None else "one process"
        return f"Mesh({self.shape}, devices={self.devices}, {where})"


def default_devices() -> List[torch.device]:
    """Every visible CUDA card, else the CPU (JAX's ``jax.devices()``)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def process_device() -> torch.device:
    """This process's device in a process group: its card (``LOCAL_RANK`` modulo
    the visible cards) where the group runs NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cpu")


def create_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "spatial") mesh. Defaults to data parallelism over every
    process of the group, or, in a single process, over ``devices`` (default:
    every visible card). In a process group, ``devices`` is this process's
    device (default ``process_device()``) and ``n_data * n_spatial`` must be
    the world size (``n_data`` defaults to world / ``n_spatial``)."""
    if n_spatial < 1:
        raise ValueError(f"a spatial axis of {n_spatial}")
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if n_data is None:
            if world % n_spatial:
                raise ValueError(f"a spatial axis of {n_spatial} in a process group of {world}")
            n_data = world // n_spatial
        if n_data * n_spatial != world:
            raise ValueError(f"a mesh of {n_data} x {n_spatial} in a process group of {world}: "
                             "the port runs one process per device")
        dev = torch.device(list(devices)[0]) if devices else process_device()
        if n_spatial > 1:
            device_mesh = init_device_mesh(dev.type, (n_data, n_spatial),
                                           mesh_dim_names=(DATA_AXIS, SPATIAL_AXIS))
        else:
            device_mesh = init_device_mesh(dev.type, (n_data,), mesh_dim_names=(DATA_AXIS,))
        return Mesh([dev], n_data, device_mesh, n_spatial)
    devices = list(devices) if devices is not None else default_devices()
    if n_data is None:
        n_data = max(len(devices) // n_spatial, 1)
    if n_data * n_spatial > len(devices):
        raise ValueError(f"a mesh of {n_data} x {n_spatial} over {len(devices)} devices")
    return Mesh(devices[:n_data * n_spatial], n_data, n_spatial=n_spatial)


def batch_sharding(mesh: Mesh, spatial_dim: Optional[int] = None):
    """The DTensor placement of an image batch (B, H, W, C): rows over the data
    axis, and with ``spatial_dim`` that dimension over the spatial axis."""
    from torch.distributed.tensor import Replicate, Shard

    if spatial_dim is None:
        return (Shard(0),)
    return (Shard(0), Shard(spatial_dim) if mesh.n_spatial > 1 else Replicate())


def replicated(mesh: Mesh):
    """The DTensor placement of a tensor every device holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def _rows(x, lo: int, hi: int, device):
    x = np.asarray(x) if not isinstance(x, torch.Tensor) else x
    if x.ndim == 0:
        return torch.as_tensor(x).to(device)
    t = torch.as_tensor(np.ascontiguousarray(x[lo:hi])) if isinstance(x, np.ndarray) \
        else x[lo:hi]
    return t.to(device)


def shard_batch(mesh: Mesh, batch, spatial: bool = False):
    """A global host batch (a dict of arrays) split by rows over the data axis
    and, with ``spatial``, each 4-d array's image rows (dim 1) over the spatial
    axis. In a process group: this process's share, on its device. In a single
    process: one dict per device of the mesh, in data-major order. Arrays
    without a batch dimension go whole to every device."""
    n, n_sp = mesh.size, mesh.n_spatial

    def share(r, s, device):
        out = {}
        for k, v in batch.items():
            a = v if isinstance(v, torch.Tensor) else np.asarray(v)
            rows = a.shape[0] if a.ndim else 0
            if rows and rows % n:
                raise ValueError(f"global batch {rows} not divisible by data axis {n}")
            per = rows // n
            t = _rows(v, r * per, (r + 1) * per, device)
            if spatial and n_sp > 1 and t.dim() >= 4:
                check_spatial_rows(t.shape[1], n_sp)
                h = t.shape[1] // n_sp
                t = t[:, s * h:(s + 1) * h].contiguous()
            out[k] = t
        return out

    if mesh.group is not None:
        return share(mesh.rank, mesh.spatial_rank, mesh.devices[0])
    return [share(i // n_sp, i % n_sp, d) for i, d in enumerate(mesh.devices)]


def shard_batch_multihost(mesh: Mesh, local_batch):
    """Each process passes its own rows of the global batch (the loader's
    share) and gets them back as tensors on its device; scalars pass whole (every
    process must pass the same value)."""
    dev = mesh.devices[0]
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
            .to(dev) for k, v in local_batch.items()}


def replicate_multihost(mesh: Mesh, tree):
    """A dict of tensors made identical on every process of the mesh: rank 0's
    values broadcast, then checked against each process's own (they must have
    been the same, as from one seed). Raises ValueError on every rank when any
    rank's values differed."""
    dev = mesh.devices[0]
    group = mesh.world_group  # both axes
    out, same = {}, True
    for k, v in tree.items():
        mine = torch.as_tensor(v).to(dev)
        got = mine.clone()
        if group is not None:
            dist.broadcast(got, src=dist.get_global_rank(group, 0), group=group)
        same = same and bool(torch.equal(got, mine))
        out[k] = got
    if group is not None:
        flag = torch.tensor([1 if same else 0], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
        same = bool(flag.item())
    if not same:
        raise ValueError("replicate_multihost: the processes passed different values")
    return out


def _from_env() -> bool:
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (``torch.distributed.init_process_group`` over
    TCP at ``coordinator_address``, "host:port"). With no arguments it joins
    the group ``torchrun`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); for one process it does
    nothing, as JAX's does. ``backend`` defaults to NCCL where CUDA is
    available and gloo elsewhere. A collective that waits past ``timeout_s``
    raises. Non-main processes log warnings only."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes in (None, 1) and not _from_env():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init = "env://"
    else:
        world, rank = int(num_processes), int(process_id)
        init = f"tcp://{coordinator_address}"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=timeout,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=timeout)
    from ..utils.general import set_logging

    set_logging()


def is_main_process() -> bool:
    """Rank 0 of the process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {n}")
    return global_batch // n
