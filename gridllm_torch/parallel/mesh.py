"""Device-mesh construction over a worker group's ranks.

The counterpart of the JAX package's parallel/mesh.py, with its axis
vocabulary (pp, dp, ep, tp, sp) and `MeshConfig.resolve`'s rules. There a
mesh is an array of the devices one program drives; here every device is
driven by its own process (parallel/distributed.py), so a `Mesh` is this
rank's view of the group: the axis sizes, this rank's coordinate on each
axis, and a torch.distributed process group per axis that carries a collective (None where the axis is 1), over which
parallel/collectives.py sums and gathers.

"dp", "ep" and "tp" are ported; `build_mesh` refuses pp and sp above 1,
naming ROADMAP A 9. tp splits attention, the MLP and the vocabulary; ep
splits mixtral's experts (on their X axis, and over tp on their hidden F
axis), whose outputs are summed over the (ep, tp) plane in one
all-reduce (`Mesh.group(("ep", "tp"))`). dp replicates, as in the JAX
package, where no PartitionSpec names it: a dp line holds every weight and
runs no collective, so it has no process group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

AXES = ("pp", "dp", "ep", "tp", "sp")
# the axes this package can shard over; the rest wait for their slice
PORTED_AXES = ("dp", "ep", "tp")
# the axes the model code runs collectives over (dp only replicates)
GROUP_AXES = ("ep", "tp")


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
    # axis, or a tuple of axes (a plane), → process group (None: one rank)
    groups: dict[Any, Any]

    def axis_rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axes: str | tuple[str, ...]):
        """The process group of this rank's line along one axis, or of its
        plane over a tuple of axes (("ep", "tp"): the ranks that share
        every other coordinate); None where the axes hold one rank."""
        if isinstance(axes, str):
            return self.groups.get(axes)
        live = tuple(ax for ax in axes if self.shape.get(ax, 1) > 1)
        if len(live) <= 1:
            return self.groups.get(live[0]) if live else None
        return self.groups.get(live)


def build_mesh(config: MeshConfig | None = None, world_size: int | None = None,
               rank: int | None = None) -> Mesh:
    """This rank's mesh over the group's ranks (default: the initialized
    torch.distributed world, else one process). "sp" is innermost and "pp"
    outermost, as in the JAX package's device order. Every rank must call
    this with the same config, in the same order: building a process group
    is collective, so every rank creates every line's (and plane's) group
    in one order and keeps those it is on."""
    import torch.distributed as dist

    config = config or MeshConfig()
    live = dist.is_available() and dist.is_initialized()
    world = world_size if world_size is not None else (dist.get_world_size() if live else 1)
    me = rank if rank is not None else (dist.get_rank() if live else 0)
    dims = config.resolve(world)
    shape = dict(zip(AXES, dims))
    bad = unported_axes(shape)
    if bad:
        raise ValueError(f"mesh axes {', '.join(bad)}: only {', '.join(PORTED_AXES)} are "
                         "ported to the torch package yet (ROADMAP A 9)")
    ranks = np.arange(world).reshape(dims)
    coords = dict(zip(AXES, (int(i) for i in np.unravel_index(me, dims))))
    groups: dict[Any, Any] = {ax: None for ax in AXES}
    # a line along each collective axis, then the (ep, tp) plane where both
    # split (where one does, the plane is that axis's line)
    spans = [(ax,) for ax in GROUP_AXES if shape[ax] > 1]
    if len(spans) == len(GROUP_AXES):
        spans.append(GROUP_AXES)
    for axes in spans:
        if not live:
            raise RuntimeError(f"mesh axes {axes} of {shape} need an initialized process "
                               "group (parallel.distributed.initialize_group)")
        idx = [AXES.index(ax) for ax in axes]
        size = math.prod(dims[i] for i in idx)
        lines = np.moveaxis(ranks, idx, range(-len(idx), 0)).reshape(-1, size)
        for line in lines:
            members = [int(r) for r in line]
            g = dist.group.WORLD if len(members) == world else dist.new_group(members)
            if me in members:
                groups[axes[0] if len(axes) == 1 else axes] = g
    return Mesh(shape=shape, rank=me, coords=coords, groups=groups)
