"""The tensor-parallel collectives of the model code.

The JAX package has no such module: GSPMD inserts its collectives from the
shardings (parallel/sharding.py). Here each rank is a process and the model
code calls these at the three places a tp split needs one:

- `all_reduce_sum` after the row-parallel products (wo, w_down): each
  rank's product is a partial sum over its slice of the inner dim;
- `embed_lookup`, the vocab-split embedding: each rank looks up the ids in
  its rows, zeroes the others, and the ranks sum (exactly one rank holds
  each id, so the sum adds zeros and is exact);
- `gather_last`, lm_head's vocab-split logits concatenated on every rank
  for the sampler, so every rank samples the same tokens.

With no mesh, or tp of 1, each is the identity and launches nothing.

Backends: NCCL, and gloo (the CPU, and CUDA tensors where several ranks
share one device). On the card's torch (2.11, CUDA 12.8) gloo has
all_reduce and all_gather_into_tensor for CUDA tensors of float32 and
bfloat16, so no op is built from others; chip_smoke.py's tp phase checks
this on the card. Gloo moves a CUDA tensor through host memory: each call
is a round trip to the host.

`CALLS` counts the collectives issued, by kind (never at tp 1).
"""

from __future__ import annotations

import torch

CALLS: dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def reset_counts() -> None:
    for k in CALLS:
        CALLS[k] = 0


def tp_group(mesh):
    """The tp axis's process group, or None (no mesh, or tp of 1)."""
    if mesh is None or mesh.shape.get("tp", 1) == 1:
        return None
    return mesh.group("tp")


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the tp ranks, in place; x at tp 1."""
    g = tp_group(mesh)
    if g is None:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    dist.all_reduce(x, group=g)
    CALLS["all_reduce"] += 1
    return x


def gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """The tp ranks' x [..., n] concatenated in rank order on the last dim:
    [..., tp·n] on every rank; x at tp 1."""
    g = tp_group(mesh)
    if g is None:
        return x
    import torch.distributed as dist

    tp = mesh.shape["tp"]
    out = torch.empty(tp * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=g)
    CALLS["all_gather"] += 1
    return out.view(tp, *x.shape).movedim(0, -2).reshape(*x.shape[:-1], tp * x.shape[-1])


def embed_lookup(rows: torch.Tensor, ids: torch.Tensor, lo: int, mesh) -> torch.Tensor:
    """Embedding rows of `ids` (already in [0, V)) from a vocab-split table:
    `rows` [n, E] holds ids [lo, lo + n). Each rank gathers its ids, zeroes
    the rest, and the ranks sum."""
    n = rows.shape[0]
    local = ids - lo
    mine = (local >= 0) & (local < n)
    out = rows[local.clamp(0, n - 1)]
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return all_reduce_sum(out, mesh)
