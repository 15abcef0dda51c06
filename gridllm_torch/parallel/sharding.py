"""Which dims of each parameter a rank keeps a slice of, and the slice.

The counterpart of the JAX package's parallel/sharding.py, with its leaf
names, its Megatron layout on the "tp" axis and its expert layout on the
"ep" axis (_LAYER_SPECS, _TOP_SPECS). A leaf's split is a map {dim: axis}
(empty: whole on every rank), so a leaf may split on two dims:

  wq/wk/wv, w_gate/w_up   [L, E, out]   out split        (column parallel)
  wo, w_down              [L, in, E]    in  split        (row parallel: the
                                        rank's product is a partial sum,
                                        summed over tp by
                                        parallel/collectives.py)
  bq/bk/bv                [L, out]      out split with their projection
  embed                   [V, E]        vocab split      (masked lookup + sum)
  lm_head                 [E, V]        vocab split      (logits gathered)
  norms, router           replicated
  we_gate/we_up           [L, X, E, F]  X split over ep, F over tp
  we_down                 [L, X, F, E]  X split over ep, F over tp (a
                                        rank's MoE output is a partial sum
                                        over its experts and its F slice,
                                        summed over ep × tp in one
                                        all-reduce)
  kv page pools  [L, P, ps, KVH, D]     KVH split: each rank's pool holds
                                        its own kv heads

dp names no dim, as in the JAX package: a dp > 1 mesh replicates.

The split rule differs from the JAX package's in one place. JAX's `_fit`
checks divisibility on the FLATTENED out dim, so wk [L, E, KVH·D] splits
even when KVH does not divide by tp, and GSPMD re-shards around the
kernels. This package has no GSPMD: a rank runs the CUDA kernels on whole
heads. So attention (wq, wk, wv, wo and their biases) is split by whole
heads, and only where `ops.kvcache.kernel_mesh_axis` gives "tp" (KVH and H
divide by tp); otherwise every rank keeps all of attention, computes it
whole and sums nothing after wo. The MLP splits by its hidden dim where F
divides by tp, embed and lm_head by vocab where V does, the experts' X
where it divides by ep and their F where it divides by tp; each dim falls
back to whole on its own, as JAX `_fit` does.

The same specs cut the other families' trees, as the JAX package's do (it
resolves a leaf's spec by its nearest dict key, `layers` anywhere on the
path selecting the layer table): llava's vision tower (`vision.layers`:
wq/wk/wv and bq/bk/bv by the tower's heads, wo by rows; bo, fc1/fc2, the
norms, the tower's top leaves and the projector whole) and bert_embed's
encoder (the same attention split; w_in/w_out, bo and word_embed whole).
An int8 leaf (a QuantizedTensor) splits its `q` as the float leaf; its
`scale [..., out]` follows a column split and stays whole under a row
split (`scale_split`). JAX's `_fit` keeps every scale whole (its rank
differs from the spec's); a rank here multiplies only its own output
channels, so it keeps only their scales.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gridllm_torch.ops.kvcache import kernel_mesh_axis, local_kv_heads
from gridllm_torch.parallel.mesh import GROUP_AXES

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


def attention_split(cfg, mesh, heads: tuple[int, int] | None = None) -> bool:
    """Whether attention is split over tp: whole heads on every rank.
    `heads` = (kv heads, q heads), default the config's (the text stack)."""
    kvh, h = heads or (cfg.num_kv_heads, cfg.num_heads)
    return kernel_mesh_axis(mesh, kvh, h) == ("wrap", "tp")


def vision_heads(cfg) -> tuple[int, int]:
    """(kv heads, q heads) of llava's vision tower: multi-head attention."""
    return cfg.vision_cfg.num_heads, cfg.vision_cfg.num_heads


def _shape(leaf) -> tuple[int, ...]:
    if isinstance(leaf, tuple):
        return leaf
    return tuple((leaf.q if hasattr(leaf, "q") else leaf).shape)


def leaf_split(name: str, shape: tuple[int, ...], cfg, mesh, top: bool = False,
               heads: tuple[int, int] | None = None) -> dict[int, str]:
    """The dims of leaf `name` (full shape `shape`) that the mesh splits,
    {dim: axis} (empty: whole on every rank). Each dim splits on its own
    where its size divides by its axis (JAX `_fit`); an attention leaf
    splits over tp only where `heads` (attention_split's) do."""
    spec = (_TOP_SPECS if top else _LAYER_SPECS).get(name)
    if mesh is None or spec is None or len(spec) != len(shape):
        return {}
    out = {}
    for dim, (size, ax) in enumerate(zip(shape, spec)):
        # dp names no dim; pp and sp are refused with the mesh
        n = mesh.shape.get(ax, 1) if ax in GROUP_AXES else 1
        if n == 1:
            continue
        if name in ATTENTION_LEAVES and not top:
            ok = attention_split(cfg, mesh, heads)
        else:
            ok = size % n == 0
        if ok:
            out[dim] = ax
    return out


def scale_split(split: dict[int, str], ndim: int) -> dict[int, str]:
    """The split of an int8 leaf's scale [..., out] given its q's (`split`
    of an `ndim`-dim q): a column split (out) cuts the scale with it, a
    leading dim keeps its index; a row split (in, the axis the scale
    spans) leaves it whole."""
    return {d if d < ndim - 2 else d - 1: ax for d, ax in split.items() if d != ndim - 2}


def param_shardings(params: dict[str, Any], cfg, mesh) -> dict[str, Any]:
    """The split ({dim: axis}; empty: replicated) of every leaf of a params
    tree (leaves arrays, QuantizedTensors, whose q's split is given, or
    shape tuples), congruent with it: `layers` by the layer table, llava's
    `vision.layers` by it at the tower's heads, every other leaf of a
    subtree (the tower's top leaves, the projector) whole, and the top
    leaves by the top table."""
    def layer_dims(layers, heads=None):
        return {k: leaf_split(k, _shape(v), cfg, mesh, heads=heads) for k, v in layers.items()}

    out: dict[str, Any] = {}
    for name, leaf in params.items():
        if name == "layers":
            out[name] = layer_dims(leaf)
        elif isinstance(leaf, dict):
            out[name] = {k: layer_dims(v, vision_heads(cfg)) if k == "layers" else {}
                         for k, v in leaf.items()}
        else:
            out[name] = leaf_split(name, _shape(leaf), cfg, mesh, top=True)
    return out


def shard_range(size: int, mesh, axis: str) -> tuple[int, int]:
    """[lo, hi) of a dim of `size` split over `axis` on this rank."""
    n = size // mesh.shape.get(axis, 1)
    r = mesh.axis_rank(axis)
    return r * n, (r + 1) * n


def shard_leaf(x, split: dict[int, str] | None, mesh, lead: int = 0):
    """This rank's slice of a full leaf (numpy or torch, or an int8 pair,
    its q and scale cut by `scale_split`) on every dim of `split`; with
    `lead`, x is one index of the leaf's first `lead` dims (a layer, or a
    layer's expert), whose splits it no longer has."""
    if hasattr(x, "q"):
        return type(x)(shard_leaf(x.q, split, mesh, lead),
                       shard_leaf(x.scale, scale_split(split or {}, x.q.ndim + lead), mesh,
                                  lead))
    index = [slice(None)] * x.ndim
    for dim, ax in (split or {}).items():
        if dim >= lead:
            lo, hi = shard_range(x.shape[dim - lead], mesh, ax)
            index[dim - lead] = slice(lo, hi)
    return x[tuple(index)]


def shard_params(params: dict[str, Any], cfg, mesh) -> dict[str, Any]:
    """Cut a full params tree down to this rank's slices (views)."""
    def cut(tree, dims):
        if isinstance(tree, dict):
            return {k: cut(v, dims[k] if isinstance(dims, dict) and k in dims else {})
                    for k, v in tree.items()}
        return shard_leaf(tree, dims, mesh)

    return cut(params, param_shardings(params, cfg, mesh))


def pool_kv_heads(cfg, mesh) -> int:
    """KV heads of this rank's page pool."""
    return local_kv_heads(cfg.num_kv_heads, mesh)
