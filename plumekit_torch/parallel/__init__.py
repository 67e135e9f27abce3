"""Parallelism (``plumekit/parallel``): device meshes, shards of a tensor
over a mesh axis, halo exchange, the collectives of data-parallel training
and the launcher of its ranks. ``plumekit/parallel/compat.py`` is a JAX
API shim and has no counterpart."""

from plumekit_torch.parallel.halo import exchange_halo_blocks, halo_pad
from plumekit_torch.parallel.mesh import (
    AXES,
    Mesh,
    gather,
    init_distributed,
    make_mesh,
    run_per_device,
    shard,
)

__all__ = ["AXES", "Mesh", "exchange_halo_blocks", "gather", "halo_pad",
           "init_distributed", "make_mesh", "run_per_device", "shard"]
