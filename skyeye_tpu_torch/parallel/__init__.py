"""Multi-device runs: the mesh, process groups, data-parallel collectives,
spatial sharding, FSDP and the launcher (port of ``skyeye_tpu/parallel``)."""
from .collectives import current_group, data_parallel
from .fsdp import jit_fsdp_step, leaf_sharding, shard_train_state, state_shardings
from .launch import WorkerFailed, launch
from .mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    batch_sharding,
    create_mesh,
    initialize_distributed,
    is_main_process,
    local_batch_size,
    replicate_multihost,
    replicated,
    shard_batch,
    shard_batch_multihost,
)
from .spatial import (
    gather_spatial, halo_exchange, spatial_max, spatial_parallel, spatial_sum, split_spatial,
)

__all__ = [
    "DATA_AXIS",
    "jit_fsdp_step",
    "leaf_sharding",
    "shard_train_state",
    "state_shardings",
    "SPATIAL_AXIS",
    "Mesh",
    "WorkerFailed",
    "batch_sharding",
    "create_mesh",
    "current_group",
    "data_parallel",
    "initialize_distributed",
    "is_main_process",
    "launch",
    "local_batch_size",
    "replicate_multihost",
    "replicated",
    "shard_batch",
    "shard_batch_multihost",
    "gather_spatial",
    "halo_exchange",
    "spatial_max",
    "spatial_parallel",
    "spatial_sum",
    "split_spatial",
]
