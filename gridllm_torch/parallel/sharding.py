"""Which dim of each parameter a rank keeps a slice of, and the slice.

The counterpart of the JAX package's parallel/sharding.py, with its leaf
names and Megatron layout on the "tp" axis (_LAYER_SPECS, _TOP_SPECS):

  wq/wk/wv, w_gate/w_up   [L, E, out]   out split        (column parallel)
  wo, w_down              [L, in, E]    in  split        (row parallel: the
                                        rank's product is a partial sum,
                                        summed over tp by
                                        parallel/collectives.py)
  bq/bk/bv                [L, out]      out split with their projection
  embed                   [V, E]        vocab split      (masked lookup + sum)
  lm_head                 [E, V]        vocab split      (logits gathered)
  norms                   replicated
  kv page pools  [L, P, ps, KVH, D]     KVH split: each rank's pool holds
                                        its own kv heads

The split rule differs from the JAX package's in one place. JAX's `_fit`
checks divisibility on the FLATTENED out dim, so wk [L, E, KVH·D] splits
even when KVH does not divide by tp, and GSPMD re-shards around the
kernels. This package has no GSPMD: a rank runs the CUDA kernels on whole
heads. So attention (wq, wk, wv, wo and their biases) is split by whole
heads, and only where `ops.kvcache.kernel_mesh_axis` gives "tp" (KVH and H
divide by tp); otherwise every rank keeps all of attention, computes it
whole and sums nothing after wo. The MLP splits by its hidden dim where F
divides by tp, embed and lm_head by vocab where V does; each falls back to
replicated on its own.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gridllm_torch.ops.kvcache import kernel_mesh_axis, local_kv_heads

_LAYER_SPECS: dict[str, tuple[str | None, ...]] = {
    "wq": ("pp", None, "tp"),
    "wk": ("pp", None, "tp"),
    "wv": ("pp", None, "tp"),
    "wo": ("pp", "tp", None),
    "w_gate": ("pp", None, "tp"),
    "w_up": ("pp", None, "tp"),
    "w_down": ("pp", "tp", None),
    "attn_norm": ("pp", None),
    "mlp_norm": ("pp", None),
    # gemma2's four-norm block
    "post_attn_norm": ("pp", None),
    "pre_ffn_norm": ("pp", None),
    "post_ffn_norm": ("pp", None),
    # qwen2 qkv bias: [L, out] splits with its projection's out dim
    "bq": ("pp", "tp"),
    "bk": ("pp", "tp"),
    "bv": ("pp", "tp"),
    # qwen3 per-head qk norms: [L, D]
    "q_norm": ("pp", None),
    "k_norm": ("pp", None),
    # MoE router + experts (mixtral): experts stacked on a [L, X, ...] axis
    "router": ("pp", None, None),
    "we_gate": ("pp", "ep", None, "tp"),
    "we_up": ("pp", "ep", None, "tp"),
    "we_down": ("pp", "ep", "tp", None),
}
_TOP_SPECS: dict[str, tuple[str | None, ...]] = {
    "embed": ("tp", None),
    "lm_head": (None, "tp"),
    "final_norm": (None,),
}
# split by whole heads, all or none (see the module docstring)
ATTENTION_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv"})


def attention_split(cfg, mesh) -> bool:
    """Whether attention is split over tp: whole heads on every rank."""
    return kernel_mesh_axis(mesh, cfg.num_kv_heads, cfg.num_heads) == ("wrap", "tp")


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(np.shape(leaf))


def leaf_split(name: str, shape: tuple[int, ...], cfg, mesh, top: bool = False) -> int | None:
    """The dim of leaf `name` (full shape `shape`) that tp splits, or None."""
    tp = 1 if mesh is None else mesh.shape.get("tp", 1)
    spec = (_TOP_SPECS if top else _LAYER_SPECS).get(name)
    if tp == 1 or spec is None or len(spec) != len(shape):
        return None
    for dim, (size, ax) in enumerate(zip(shape, spec)):
        if ax != "tp":
            continue
        if name in ATTENTION_LEAVES and not top:
            return dim if attention_split(cfg, mesh) else None
        return dim if size % tp == 0 else None
    return None


def param_shardings(params: dict[str, Any], cfg, mesh) -> dict[str, Any]:
    """The split dim (None: replicated) of every leaf of a params tree
    (embed, layers, final_norm, lm_head; leaves arrays or shape tuples),
    congruent with it."""
    out: dict[str, Any] = {}
    for name, leaf in params.items():
        if name == "layers":
            out[name] = {k: leaf_split(k, _shape(v), cfg, mesh) for k, v in leaf.items()}
        else:
            out[name] = leaf_split(name, _shape(leaf), cfg, mesh, top=True)
    return out


def shard_range(size: int, mesh) -> tuple[int, int]:
    """[lo, hi) of a tp-split dim of `size` on this rank."""
    tp = mesh.shape.get("tp", 1)
    n = size // tp
    r = mesh.axis_rank("tp")
    return r * n, (r + 1) * n


def shard_leaf(x, dim: int | None, mesh):
    """This rank's slice of a full leaf (numpy or torch) along `dim`."""
    if dim is None:
        return x
    lo, hi = shard_range(x.shape[dim], mesh)
    index = [slice(None)] * x.ndim
    index[dim] = slice(lo, hi)
    return x[tuple(index)]


def shard_params(params: dict[str, Any], cfg, mesh) -> dict[str, Any]:
    """Cut a full params tree down to this rank's slices (views)."""
    dims = param_shardings(params, cfg, mesh)
    out: dict[str, Any] = {}
    for name, leaf in params.items():
        if name == "layers":
            out[name] = {k: shard_leaf(v, dims[name][k], mesh) for k, v in leaf.items()}
        else:
            out[name] = shard_leaf(leaf, dims[name], mesh)
    return out


def pool_kv_heads(cfg, mesh) -> int:
    """KV heads of this rank's page pool."""
    return local_kv_heads(cfg.num_kv_heads, mesh)
