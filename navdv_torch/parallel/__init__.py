"""Parallelism over ranks with ``torch.distributed`` (counterpart of the
JAX package's ``navdv_tpu.parallel``): data-parallel agents, a library
axis combined by ``all_reduce(MIN)`` inside every step, sweep cells spread
over ranks, and the multi-process entry."""

from navdv_torch.parallel.distributed import global_mesh, init_distributed, launch_ranks
from navdv_torch.parallel.mesh import (
    DATA_AXIS,
    LIB_AXIS,
    Mesh,
    collective_counts,
    gather_data,
    make_mesh,
    make_navigate_cells,
    make_navigate_sharded,
    pad_library,
    reset_collective_counts,
    shard_statics,
)

__all__ = [
    "DATA_AXIS",
    "LIB_AXIS",
    "Mesh",
    "collective_counts",
    "gather_data",
    "global_mesh",
    "init_distributed",
    "launch_ranks",
    "make_mesh",
    "make_navigate_cells",
    "make_navigate_sharded",
    "pad_library",
    "reset_collective_counts",
    "shard_statics",
]
