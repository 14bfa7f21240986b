"""Data parallelism over several devices: the mesh, sharding and process
groups (``dtqn_tpu/parallel``)."""

from dtqn_tpu_torch.parallel.mesh import (
    make_distributed_train_chunk,
    make_mesh,
    shard_state,
    state_shardings,
)
from dtqn_tpu_torch.parallel.distributed import init_distributed, process_info

__all__ = [
    "make_mesh",
    "shard_state",
    "state_shardings",
    "make_distributed_train_chunk",
    "init_distributed",
    "process_info",
]
