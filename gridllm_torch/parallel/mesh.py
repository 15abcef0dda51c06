"""Device-mesh construction over a worker group's ranks.

The counterpart of the JAX package's parallel/mesh.py, with its axis
vocabulary (pp, dp, ep, tp, sp) and `MeshConfig.resolve`'s rules. There a
mesh is an array of the devices one program drives; here every device is
driven by its own process (parallel/distributed.py), so a `Mesh` is this
rank's view of the group: the axis sizes, this rank's coordinate on each
axis, and a torch.distributed process group per axis of more than one rank
(None where the axis is 1), over which parallel/collectives.py sums and
gathers.

Only "tp" is ported: `build_mesh` refuses any other axis above 1, naming
ROADMAP A 9, and the model code runs every collective on the tp group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

AXES = ("pp", "dp", "ep", "tp", "sp")
# the axes this package can shard over; the rest wait for their slice
PORTED_AXES = ("tp",)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. -1 on at most one axis means "absorb the rest"."""

    pp: int = 1
    dp: int = 1
    ep: int = 1
    tp: int = -1
    sp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int, int]:
        dims = [self.pp, self.dp, self.ep, self.tp, self.sp]
        wild = [i for i, d in enumerate(dims) if d == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(d for d in dims if d != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by {fixed}")
            dims[wild[0]] = n_devices // fixed
        if math.prod(dims) != n_devices:
            raise ValueError(
                f"mesh {dims} needs {math.prod(dims)} devices, have {n_devices}"
            )
        return tuple(dims)  # type: ignore[return-value]


def unported_axes(shape: dict[str, int]) -> list[str]:
    """The axes above 1 that this package cannot shard over yet."""
    return [f"{ax}={n}" for ax, n in shape.items() if n > 1 and ax not in PORTED_AXES]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the worker group's mesh."""

    shape: dict[str, int]               # axis → size, in AXES order
    rank: int                           # this process's rank in the group
    coords: dict[str, int]              # axis → this rank's index on it
    groups: dict[str, Any]              # axis → process group (None: size 1)

    def axis_rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The axis's process group, or None for an axis of one rank."""
        return self.groups.get(axis)


def build_mesh(config: MeshConfig | None = None, world_size: int | None = None,
               rank: int | None = None) -> Mesh:
    """This rank's mesh over the group's ranks (default: the initialized
    torch.distributed world, else one process). "sp" is innermost and "pp"
    outermost, as in the JAX package's device order. Every rank must call
    this with the same config, in the same order: building an axis's
    process groups is collective."""
    import torch.distributed as dist

    config = config or MeshConfig()
    live = dist.is_available() and dist.is_initialized()
    world = world_size if world_size is not None else (dist.get_world_size() if live else 1)
    me = rank if rank is not None else (dist.get_rank() if live else 0)
    dims = config.resolve(world)
    shape = dict(zip(AXES, dims))
    bad = unported_axes(shape)
    if bad:
        raise ValueError(f"mesh axes {', '.join(bad)}: only tp is ported to the torch "
                         "package yet (ROADMAP A 9)")
    ranks = np.arange(world).reshape(dims)
    coords = dict(zip(AXES, (int(i) for i in np.unravel_index(me, dims))))
    groups: dict[str, Any] = {}
    for i, ax in enumerate(AXES):
        if dims[i] == 1:
            groups[ax] = None
            continue
        if not live:
            raise RuntimeError(f"mesh axis {ax}={dims[i]} needs an initialized process "
                               "group (parallel.distributed.initialize_group)")
        # one group per line of ranks along the axis; every rank creates all
        # of them (new_group is collective) and keeps the one it is on
        lines = np.moveaxis(ranks, i, -1).reshape(-1, dims[i])
        for line in lines:
            members = [int(r) for r in line]
            g = (dist.group.WORLD if len(members) == world
                 else dist.new_group(members))
            if me in members:
                groups[ax] = g
    return Mesh(shape=shape, rank=me, coords=coords, groups=groups)
