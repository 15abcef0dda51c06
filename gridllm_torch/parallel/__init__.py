"""Parallelism layer: the worker group's process group, its mesh, the
parameter shards and the collectives (the JAX package's parallel/, for
tensor parallelism).

In the JAX package one process drives a mesh of devices and GSPMD inserts
the collectives; here one process drives one device, so a tensor-parallel
logical worker is a group of processes in SPMD lockstep (worker/group.py,
worker/plan.py), and the model code calls parallel/collectives.py itself.
"""

from gridllm_torch.parallel.distributed import (
    GroupConfig,
    initialize_group,
    rank_device,
    shutdown_group,
)
from gridllm_torch.parallel.mesh import AXES, Mesh, MeshConfig, build_mesh
from gridllm_torch.parallel.sharding import (
    param_shardings,
    pool_kv_heads,
    shard_params,
)

__all__ = [
    "AXES",
    "GroupConfig",
    "Mesh",
    "MeshConfig",
    "build_mesh",
    "initialize_group",
    "param_shardings",
    "pool_kv_heads",
    "rank_device",
    "shard_params",
    "shutdown_group",
]
