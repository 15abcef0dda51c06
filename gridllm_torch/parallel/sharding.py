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
               heads: tuple[int, int] | None = None) -> int | None:
    """The dim of leaf `name` (full shape `shape`) that tp splits, or None;
    an attention leaf splits only where `heads` (attention_split's) do."""
    tp = 1 if mesh is None else mesh.shape.get("tp", 1)
    spec = (_TOP_SPECS if top else _LAYER_SPECS).get(name)
    if tp == 1 or spec is None or len(spec) != len(shape):
        return None
    for dim, (size, ax) in enumerate(zip(shape, spec)):
        if ax != "tp":
            continue
        if name in ATTENTION_LEAVES and not top:
            return dim if attention_split(cfg, mesh, heads) else None
        return dim if size % tp == 0 else None
    return None


def scale_split(dim: int | None, ndim: int) -> int | None:
    """The split dim of an int8 leaf's scale [..., out] given its q's
    (`dim` of `ndim`): a column split (out) cuts the scale with it; a row
    split (in, the axis the scale spans) leaves it whole."""
    return dim - 1 if dim is not None and dim == ndim - 1 else None


def param_shardings(params: dict[str, Any], cfg, mesh) -> dict[str, Any]:
    """The split dim (None: replicated) of every leaf of a params tree
    (leaves arrays, QuantizedTensors, whose q's dim is given, or shape
    tuples), congruent with it: `layers` by the layer table, llava's
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
            out[name] = {k: layer_dims(v, vision_heads(cfg)) if k == "layers" else None
                         for k, v in leaf.items()}
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
    """This rank's slice of a full leaf (numpy or torch, or an int8 pair,
    its q and scale cut by `scale_split`) along `dim`."""
    if hasattr(x, "q"):
        return type(x)(shard_leaf(x.q, dim, mesh),
                       shard_leaf(x.scale, scale_split(dim, x.q.ndim), mesh))
    if dim is None:
        return x
    lo, hi = shard_range(x.shape[dim], mesh)
    index = [slice(None)] * x.ndim
    index[dim] = slice(lo, hi)
    return x[tuple(index)]


def shard_params(params: dict[str, Any], cfg, mesh) -> dict[str, Any]:
    """Cut a full params tree down to this rank's slices (views)."""
    def cut(tree, dims):
        if isinstance(tree, dict):
            return {k: cut(v, dims[k] if isinstance(dims, dict) else dims)
                    for k, v in tree.items()}
        return shard_leaf(tree, dims, mesh)

    return cut(params, param_shardings(params, cfg, mesh))


def pool_kv_heads(cfg, mesh) -> int:
    """KV heads of this rank's page pool."""
    return local_kv_heads(cfg.num_kv_heads, mesh)
