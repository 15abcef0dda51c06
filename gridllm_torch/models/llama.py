"""Llama-family decoder (Llama 3/3.1/3.2, Qwen2/Qwen3) as an nn.Module.

Parameters keep the JAX package's layout: per-layer weights STACKED on a
leading [L] axis and projections stored [in, out] (forward is x @ W), so
`params_from_jax` copies a JAX pytree leaf for leaf and both packages
compute the same function.

Entry points, all taking host scalars for lengths and positions:
- `forward`: cache-free full logits (the oracle the paged paths match);
- `hidden_states`: cache-free final-norm hidden states of a [B, T] batch
  with a valid length per row (the embeddings path; no head);
- `prefill`: one slot's whole prompt bucket, writes the paged cache;
- `prefill_chunk`: one chunk of a slot against its cached prefix;
- `decode_step`: one token for every slot;
- `verify_step`: K+1 speculative candidates (a chain, or the nodes of a
  draft model's token tree) for every slot, written optimistically with
  the lengths left as they were;
- `mixed_step`: one slot's prefill chunk plus one decode token for every
  slot, one ragged attention launch per layer.
Every paged entry point defers its pool writes to ONE all-layer write after
the layer loop, as the JAX package does; the pool holds the prefix only
while the layers run and the fresh K/V are merged inside the attention.
The cache is updated in place and returned.

Attention mode (`ragged_attention`, the counterpart of the JAX package's
GRIDLLM_RAGGED_ATTN), fixed when the model is built: on, decode, verify and
chunks run the unified ragged kernel; off, they run the per-phase
dispatchers (`paged_attention_decode`, `paged_attention_verify`,
`attention_prefix_chunk`). `mixed_step` exists only with it on.

Every attention call takes layer li's sliding window (`_window(li)`) and
the config's logit softcap, so a family whose layers differ only there
(gemma2, models/gemma.py; mixtral, models/mixtral.py) shares the entry
points and overrides the pieces: `_layer_shapes`, `_embed`, `_embed_in`,
`_block`, `_mlp`, `_window`, `_final_norm`, `_unembed`.

`prefill`, `prefill_chunk`, `mixed_step`, `forward` and `hidden_states`
take `embeds`, rows that replace the token-embedding lookup of the prompt
(the vision splice of models/llava.py); the tokens still give the shapes.

Int8 weights (`quantize="int8"`, the JAX package's ops/quant.py scheme):
the QUANT_LEAVES (the attention and dense-FFN projections and an untied
lm_head) are int8 parameters in `layers` (and `lm_head`) with float32
per-out-channel scales in `scales` under the same names, so
`named_parameters()` carries both halves and a parked snapshot restores
them as they are. No bf16 copy of a whole quantized leaf is ever
allocated: weights are quantized a layer slice at a time as they are drawn
or placed. Every projection goes through `qdot` on the layer's weight
(`_w`), which is the plain (x @ q) * scale for a quantized leaf.

Tensor parallelism (`mesh`, a parallel.mesh.Mesh with tp > 1; every
family but mixtral, MESH_FAMILIES): each rank holds its slices of the leaves
(parallel/sharding.py: attention by whole heads where the heads divide by
tp, the MLP by its hidden dim, embed and lm_head by vocab), runs attention
on its heads against a pool of its kv heads, and the sums of
parallel/collectives.py join the ranks: after wo and w_down, in the
embedding lookup, and the logits are gathered, so every rank ends each
entry point with the same hidden states and the full logits. Weights
arrive whole and each rank keeps its slices: `init_params` draws the full
tensors from the seed (a layer, or a block of rows, at a time),
`params_from_jax` cuts a full pytree, and `params_from_hf` takes slices
(`hf_slices` names them, so a reader reads only those). An int8 leaf's
pair is the slice of the whole leaf's quantization: a column-split leaf
keeps its columns of q and scale; a row-split one (wo, w_down) keeps its
rows of q and the whole scale, each scale the amax over ALL rows, so its
layer is quantized whole and cut (`_quantize_layer`) and a checkpoint
reader reads it whole.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gridllm_torch.models.configs import ModelConfig
from gridllm_torch.parallel import collectives
from gridllm_torch.parallel.sharding import (
    attention_split,
    param_shardings,
    scale_split,
    shard_leaf,
    shard_range,
)
from gridllm_torch.ops.attention import (
    attention_prefill,
    attention_prefix_chunk,
    paged_attention_decode,
    paged_attention_verify,
    ragged_paged_attention,
)
from gridllm_torch.ops.kvcache import (
    PagedKVCache,
    write_decode_all,
    write_multi_all,
    write_prefill_all,
)
from gridllm_torch.ops.layers import precompute_rope, rms_norm, rope_tables, rotate
from gridllm_torch.ops.quant import (
    QUANT_LEAVES,
    QuantizedTensor,
    qdot,
    quantize_into,
    scale_of,
    to_int8,
)

# the most values a random draw of init_params fills at once (64 MB in float32)
_DRAW_NUMEL = 1 << 24
# the families whose model runs under a tensor-parallel mesh (mixtral's
# experts wait for ep, ROADMAP A 9)
MESH_FAMILIES = ("llama", "qwen2", "qwen3", "gemma2", "llava", "bert_embed")


def validate_mesh(cfg: ModelConfig, mesh) -> None:
    """Engine-init mesh check: ring-attention (sp) prefill has no
    sliding-window variant (the JAX package's rule; sp itself waits for
    ROADMAP A 9), and only MESH_FAMILIES run under a mesh."""
    if cfg.sliding_window and mesh is not None and mesh.shape.get("sp", 1) > 1:
        raise ValueError(
            f"{cfg.name}: sliding-window attention cannot combine with sp "
            "(ring-attention prefill) yet — shape the mesh without sp"
        )
    if mesh is not None and cfg.family not in MESH_FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family} family under a mesh is not "
                         "ported to the torch package yet (ROADMAP A 9)")


class Llama(nn.Module):
    """Llama-skeleton decoder; `layers` holds the stacked [L, ...] leaves
    under the JAX pytree's names."""

    # the norm leaves and the value init_params gives them (and final_norm)
    NORMS: tuple[str, ...] = ("attn_norm", "mlp_norm", "q_norm", "k_norm")
    NORM_INIT = 1.0
    # leaves drawn at a fixed scale (the others: fan_in ** -0.5, norms NORM_INIT)
    FIXED_INIT = {"bq": 0.02, "bk": 0.02, "bv": 0.02}

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda", ragged_attention: bool = True,
                 quantize: str | None = None, mesh=None):
        super().__init__()
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        if mesh is not None and mesh.shape.get("tp", 1) == 1:
            mesh = None
        if mesh is not None:
            validate_mesh(cfg, mesh)
        self.cfg = cfg
        self.dtype = dtype
        self.quantize = quantize
        self.mesh = mesh
        self._ragged_attention = ragged_attention
        e, v, d = cfg.hidden_size, cfg.vocab_size, cfg.head_dim_
        # this rank's heads, and the split dim of every leaf (None: whole)
        tp = 1 if mesh is None else mesh.shape["tp"]
        heads_split = mesh is not None and attention_split(cfg, mesh)
        self.n_heads = cfg.num_heads // tp if heads_split else cfg.num_heads
        self.n_kv_heads = cfg.num_kv_heads // tp if heads_split else cfg.num_kv_heads
        self._full = {"embed": (v, e), "layers": self._layer_shapes(), "final_norm": (e,)}
        if not cfg.tie_embeddings:
            self._full["lm_head"] = (e, v)
        self._split = param_shardings(self._full, cfg, mesh)

        def p(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        def quantized(name):
            return quantize is not None and name in QUANT_LEAVES

        shapes = {k: self._local_shape(s, self._split["layers"][k])
                  for k, s in self._full["layers"].items()}
        self.embed = p(*self._local_shape((v, e), self._split["embed"]))
        self.layers = nn.ParameterDict({
            k: p(*s, dt=torch.int8 if quantized(k) else dtype) for k, s in shapes.items()})
        # the float32 scales of the int8 leaves, [..., out], by leaf name
        self.scales = nn.ParameterDict({
            k: p(*s[:-2], s[-1], dt=torch.float32) for k, s in shapes.items() if quantized(k)})
        self.final_norm = p(e)
        self.lm_head = None
        if not cfg.tie_embeddings:
            head = self._local_shape((e, v), self._split["lm_head"])
            self.lm_head = p(*head, dt=torch.int8 if quantized("lm_head") else dtype)
            if quantized("lm_head"):
                self.scales["lm_head"] = p(head[-1], dt=torch.float32)
        self.register_buffer(
            "inv_freq",
            precompute_rope(d, cfg.rope_theta, cfg.rope_scaling, device=device),
            persistent=False,
        )

    def _layer_shapes(self) -> dict[str, tuple[int, ...]]:
        """The stacked [L, ...] layer leaves by their JAX pytree names."""
        cfg = self.cfg
        e, f = cfg.hidden_size, cfg.intermediate_size
        h, kvh, d, n = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
        shapes = {
            "attn_norm": (n, e), "wq": (n, e, h * d), "wk": (n, e, kvh * d),
            "wv": (n, e, kvh * d), "wo": (n, h * d, e), "mlp_norm": (n, e),
            "w_gate": (n, e, f), "w_up": (n, e, f), "w_down": (n, f, e),
        }
        if cfg.attn_bias:
            shapes.update(bq=(n, h * d), bk=(n, kvh * d), bv=(n, kvh * d))
        if cfg.qk_norm:
            shapes.update(q_norm=(n, d), k_norm=(n, d))
        return shapes

    def _local_shape(self, shape: tuple[int, ...], dim: int | None) -> tuple[int, ...]:
        """A leaf's shape on this rank: `dim` cut to its tp share."""
        if dim is None:
            return tuple(shape)
        return tuple(n // self.mesh.shape["tp"] if i == dim else n for i, n in enumerate(shape))

    def _full_shape(self, name: str) -> tuple[int, ...]:
        """The unsplit shape of leaf `name` (a layer leaf or a top-level one)."""
        layers = self._full["layers"]
        return layers[name] if name in layers else self._full[name]

    def _leaf_split(self, name: str) -> int | None:
        """The split dim of leaf `name` (None: every rank holds it whole)."""
        layers = self._split["layers"]
        return layers[name] if name in layers else self._split.get(name)

    def _range(self, name: str) -> tuple[int, int] | None:
        """[lo, hi) of leaf `name`'s split dim on this rank, or None."""
        dim = self._leaf_split(name)
        return None if dim is None else shard_range(self._full_shape(name)[dim], self.mesh)

    def _cut(self, name: str, x, layer_slice: bool = False):
        """This rank's share of a full tensor of leaf `name` (or, with
        layer_slice, of one layer of a stacked leaf)."""
        dim = self._leaf_split(name)
        if dim is None:
            return x
        if layer_slice:
            dim -= 1
        lo, hi = self._range(name)
        return x.narrow(dim, lo, hi - lo) if isinstance(x, torch.Tensor) \
            else x[(slice(None),) * dim + (slice(lo, hi),)]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def ragged_attention(self) -> bool:
        """The attention mode the model was built with."""
        return self._ragged_attention

    # ------------------------------------------------------------ weights

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Llama":
        """Random weights with the JAX package's scales (normal × fan_in
        ** -0.5 for projections, 0.02 for embedding/head and FIXED_INIT,
        NORM_INIT for norms), drawn in float32 on the module's device one
        layer of a stacked leaf, or one block of rows of a 2-D leaf, at a
        time. An int8 leaf draws the same numbers, rounds
        them to the model dtype and quantizes them, as the JAX package
        quantizes its initialized weights: an int8 model's weights are the
        int8 pairs of the unquantized model's from the same generator."""

        def slices(name: str, t: torch.Tensor, scale: float, cut: bool = True):
            # bounded memory: a stacked leaf one layer at a time, a 2-D leaf
            # in blocks of rows of at most _DRAW_NUMEL values, one draw a
            # block (a draw a row is ~400k launches for a 128k-row embedding).
            # The draws are of the FULL leaf, so every rank of a mesh draws
            # the same numbers as an unmeshed model; each keeps its share
            # (a stacked layer's whole draw with cut=False)
            full = self._full_shape(name)
            dim = self._leaf_split(name)
            rows = self._range(name) if dim == 0 and len(full) == 2 else None
            step = max(1, _DRAW_NUMEL // full[-1]) if len(full) == 2 else 1
            for i in range(0, full[0], step):
                shape = (min(step, full[0] - i), full[1]) if len(full) == 2 else full[1:]
                w = torch.randn(shape, generator=generator, device=t.device,
                                dtype=torch.float32) * scale
                if rows is not None:      # a vocab-split embed: the rows it holds
                    lo, hi = max(i, rows[0]), min(i + shape[0], rows[1])
                    if lo < hi:
                        yield i, t[lo - rows[0]:hi - rows[0]], w[lo - i:hi - i]
                elif len(full) == 2:
                    yield i, t[i:i + step], self._cut(name, w)
                else:
                    yield i, t[i], self._cut(name, w, layer_slice=True) if cut else w

        def normal_(name: str, t: torch.Tensor, scale: float) -> None:
            if name not in self.scales:
                for _, part, w in slices(name, t, scale):
                    part.copy_(w)
            elif t.ndim > 2:      # a stacked leaf: each layer's slice quantizes alone
                for i, part, w in slices(name, t, scale, cut=False):
                    self._quantize_layer(name, QuantizedTensor(part, self.scales[name][i]),
                                         w.to(self.dtype))
            else:
                # a 2-D leaf (the head) is drawn by rows, and its scales need
                # every row: a first pass finds each column's largest
                # magnitude, a second draws the same rows again and rounds
                state = generator.get_state()
                amax = torch.zeros(t.shape[-1], dtype=torch.float32, device=t.device)
                for _, _, w in slices(name, t, scale):
                    amax = torch.maximum(amax, w.to(self.dtype).float().abs().amax(dim=0))
                generator.set_state(state)
                s = scale_of(amax)
                self.scales[name].copy_(s)
                for _, part, w in slices(name, t, scale):
                    part.copy_(to_int8(w.to(self.dtype), s))

        normal_("embed", self.embed, 0.02)
        for name, t in self.layers.items():
            if name in self.NORMS:
                t.fill_(self.NORM_INIT)
            else:
                # the fan-in of the full leaf (a rank's row-split share is smaller)
                fan_in = self._full_shape(name)[-2]
                normal_(name, t, self.FIXED_INIT.get(name, fan_in ** -0.5))
        self.final_norm.fill_(self.NORM_INIT)
        if self.lm_head is not None:
            normal_("lm_head", self.lm_head, 0.02)
        return self

    @torch.no_grad()
    def params_from_jax(self, np_params: dict[str, Any]) -> "Llama":
        """Copy a JAX-layout pytree (numpy leaves: stacked [L] layer
        leaves, [in, out] projections; a quantized leaf as the JAX
        package's QuantizedTensor of numpy `q` and `scale`) into this
        module's parameters. A float leaf for an int8 parameter is
        quantized on the host first (quantize_np_leaf's rule). Under a mesh
        the leaves are whole and each keeps this rank's slice."""
        from gridllm_torch.ops.quant import quantize_np_leaf

        def put(dst: torch.Tensor, src, dtype=np.float32, name: str | None = None) -> None:
            if name is not None:
                src = self._cut(name, np.asarray(src))
            arr = np.array(src, dtype=dtype)  # a writable copy
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"shape {arr.shape} != {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(arr))

        def put_leaf(name: str, dst: torch.Tensor, src) -> None:
            if name not in self.scales:
                if hasattr(src, "q"):
                    raise ValueError(f"{name}: an int8 leaf for an unquantized model")
                put(dst, src, name=name)
                return
            if not hasattr(src, "q"):   # the whole leaf's quantization, then the cut
                src = quantize_np_leaf(name, np.asarray(src, np.float32))
            dim = self._leaf_split(name)
            q, scale = np.asarray(src.q), np.asarray(src.scale)
            put(dst, shard_leaf(q, dim, self.mesh), np.int8)
            put(self.scales[name], shard_leaf(scale, scale_split(dim, q.ndim), self.mesh))

        put(self.embed, np_params["embed"], name="embed")
        for name, t in self.layers.items():
            put_leaf(name, t, np_params["layers"][name])
        put(self.final_norm, np_params["final_norm"])
        if self.lm_head is not None:
            put_leaf("lm_head", self.lm_head, np_params["lm_head"])
        return self

    def _row_split(self, name: str) -> bool:
        """Whether leaf `name` is split on its contracted `in` axis (wo,
        w_down: row parallel), the axis an int8 scale spans."""
        dim = self._leaf_split(name)
        return dim is not None and dim == len(self._full_shape(name)) - 2

    def _quantize_layer(self, name: str, dst: QuantizedTensor, w: torch.Tensor) -> None:
        """Quantize one whole layer `w` [in, out] of int8 leaf `name` into
        this rank's pair `dst`: a row-split leaf's scales from all of w's
        rows, its q from the rank's rows; otherwise the rank's columns."""
        if self._row_split(name):
            quantize_into(dst, w, rows=self._range(name))
        else:
            quantize_into(dst, self._cut(name, w, layer_slice=True))

    def _leaf(self, name: str, t: torch.Tensor):
        """Parameter `t` of leaf `name`, paired with its scales when int8."""
        return QuantizedTensor(t, self.scales[name]) if name in self.scales else t

    def params_tree(self) -> dict[str, Any]:
        """The parameters as the JAX-layout pytree (embed, layers, final_norm
        and, untied, lm_head; int8 leaves as QuantizedTensor), tensors
        shared with the module."""
        tree: dict[str, Any] = {
            "embed": self.embed,
            "layers": {k: self._leaf(k, t) for k, t in self.layers.items()},
            "final_norm": self.final_norm}
        if self.lm_head is not None:
            tree["lm_head"] = self._leaf("lm_head", self.lm_head)
        return tree

    @torch.no_grad()
    def params_from_hf(self, get: Callable[[str], torch.Tensor]) -> "Llama":
        """Fill the parameters from HF-named tensors (`get`, e.g. a
        safetensors reader) through `name_map()`: each layer's tensor goes
        to the module's device as stored, is transposed there when the map
        says so and converted into its slot of the preallocated [L, ...]
        parameter, so no stacked or transposed copy is made on the host.
        An int8 leaf's layer is quantized from the stored values as it is
        placed (the JAX loader's host-side rule, one layer slice here), so
        no whole float copy of the leaf is made. Tied embeddings read no
        lm_head.weight. Under a mesh a tensor may come whole or as this
        rank's slice (`hf_slices`); a whole one is cut here (an int8
        row-split leaf arrives whole and is quantized whole, then cut)."""
        from gridllm_torch.models import hf_layout

        tree = self.params_tree()

        def place(path, layer, t, transpose):
            dst = tree[path[0]] if len(path) == 1 else tree[path[0]][path[1]]
            if layer is not None:
                dst = dst[layer]
            src = t.to(dst.device)
            src = src.T if transpose else src
            # an int8 row-split layer (wo, w_down) stays whole until quantized
            whole = isinstance(dst, QuantizedTensor) and self._row_split(path[-1])
            want = self._full_shape(path[-1])[1:] if whole else tuple(dst.shape)
            if tuple(src.shape) != tuple(want):
                src = self._cut(path[-1], src, layer_slice=layer is not None)
            if tuple(src.shape) != tuple(want):
                raise ValueError(f"{'/'.join(path)}: checkpoint shape {tuple(src.shape)} "
                                 f"!= {tuple(want)}")
            if whole:
                self._quantize_layer(path[-1], dst, src)
            elif isinstance(dst, QuantizedTensor):
                quantize_into(dst, src)
            else:
                dst.copy_(src)

        hf_layout.to_pytree(self.cfg, get, self.name_map(), place)
        return self

    def hf_slices(self) -> dict[str, tuple[int, int, int]]:
        """The HF tensors this rank keeps a slice of: name → (dim in the
        stored HF orientation, lo, hi). Empty without a mesh. An int8
        row-split leaf is read whole: its scales span every row."""
        from gridllm_torch.models.hf_layout import hf_names

        out: dict[str, tuple[int, int, int]] = {}
        for leaf, name, transpose, stacked in hf_names(self.cfg, self.name_map()):
            dim = self._leaf_split(leaf)
            if dim is None or (leaf in self.scales and self._row_split(leaf)):
                continue
            dim -= stacked                        # one layer of a stacked leaf
            if transpose:
                dim = 1 - dim                     # HF stores [out, in]
            out[name] = (dim, *self._range(leaf))
        return out

    def name_map(self) -> dict[str, tuple[str, bool]]:
        """The family's HF layout contract (leaf → HF name template,
        transpose?)."""
        return hf_map(self.cfg)

    def hf_tensors(self) -> dict[str, torch.Tensor]:
        """Inverse of params_from_hf: HF name → tensor view in HF
        orientation (the checkpoint writer materializes one at a time)."""
        from gridllm_torch.models import hf_layout

        return hf_layout.to_hf_tensors(self.params_tree(), self.cfg, self.name_map())

    def free_params(self) -> None:
        """Drop every parameter's storage (the engine's unload after its
        weights are parked): the tensors become empty, so the module serves
        nothing after this and the device memory returns to the allocator."""
        for p in self.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # ------------------------------------------------------------ pieces

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # out-of-vocab ids (the byte tokenizer's BOS on a 256-token vocab)
        # clamp to the last row, as the JAX package's gather does
        ids = tokens.long().clamp(0, self.cfg.vocab_size - 1)
        rows = self._range("embed")
        if rows is None:
            return self.embed[ids]
        return collectives.embed_lookup(self.embed, ids, rows[0], self.mesh)

    def _embed_in(self, tokens: torch.Tensor, embeds: torch.Tensor | None) -> torch.Tensor:
        """The input rows: the tokens' embeddings, or `embeds` (rows shaped
        like them) in the model's dtype."""
        return self._embed(tokens) if embeds is None else embeds.to(self.dtype)

    def _w(self, name: str, li: int):
        """Layer li's slice of projection leaf `name`: a tensor, or for an
        int8 leaf the QuantizedTensor of its q and scale slices."""
        return self._leaf(name, self.layers[name])[li]

    def _qkv(self, li: int, x: torch.Tensor):
        """x: [..., T, E] → q [..., T, H, D], k/v [..., T, KVH, D]."""
        cfg, lp = self.cfg, self.layers
        d = cfg.head_dim_
        q, k, v = (qdot(x, self._w("wq", li)), qdot(x, self._w("wk", li)),
                   qdot(x, self._w("wv", li)))
        if cfg.attn_bias:
            q, k, v = q + lp["bq"][li], k + lp["bk"][li], v + lp["bv"][li]
        q = q.reshape(*x.shape[:-1], self.n_heads, d)
        k = k.reshape(*x.shape[:-1], self.n_kv_heads, d)
        v = v.reshape(*x.shape[:-1], self.n_kv_heads, d)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"][li], cfg.rms_eps)
            k = rms_norm(k, lp["k_norm"][li], cfg.rms_eps)
        return q, k, v

    def _mlp(self, li: int, x: torch.Tensor) -> torch.Tensor:
        gate, up = qdot(x, self._w("w_gate", li)), qdot(x, self._w("w_up", li))
        return self._row_sum("w_down", qdot(F.silu(gate) * up, self._w("w_down", li)))

    def _row_sum(self, name: str, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial y summed over tp where leaf
        `name` is split (y as it is otherwise)."""
        return y if self._leaf_split(name) is None else collectives.all_reduce_sum(y, self.mesh)

    def _block(self, li: int, x: torch.Tensor, rope, attend) -> tuple:
        """One decoder layer: returns (x out, k, v). `attend(q, k, v)`
        gives the attention output shaped like q."""
        cfg, lp = self.cfg, self.layers
        hx = rms_norm(x, lp["attn_norm"][li], cfg.rms_eps)
        q, k, v = self._qkv(li, hx)
        q, k = rotate(q, *rope), rotate(k, *rope)
        att = attend(q, k, v).reshape(*x.shape[:-1], -1)
        x = x + self._row_sum("wo", qdot(att, self._w("wo", li)))
        hx = rms_norm(x, lp["mlp_norm"][li], cfg.rms_eps)
        return x + self._mlp(li, hx), k, v

    def _final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.final_norm, self.cfg.rms_eps)

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = self._final_norm(x)
        head = self.embed.T if self.lm_head is None else self._leaf("lm_head", self.lm_head)
        logits = qdot(x, head, out_dtype=torch.float32)
        split = self._leaf_split("embed" if self.lm_head is None else "lm_head")
        return logits if split is None else collectives.gather_last(logits, self.mesh)

    def _window(self, li: int) -> int:
        """Layer li's sliding window (0: full attention)."""
        return self.cfg.sliding_window

    # ------------------------------------------------------------ entry points

    def _bucket_layers(self, x: torch.Tensor, seq_lens: torch.Tensor | None) -> torch.Tensor:
        """The layer loop over a cache-free batch x [B, T, E] at positions
        0..T-1, the keys of row b at seq_lens[b] and past masked (None: all
        valid); one attention_prefill per layer."""
        b, t = x.shape[:2]
        pos = torch.arange(t, device=x.device)[None].expand(b, t)
        rope = rope_tables(pos, self.inv_freq)
        if seq_lens is None:
            seq_lens = torch.full((b,), t, dtype=torch.int32, device=x.device)
        seq_lens = seq_lens.to(device=x.device, dtype=torch.int32)
        cap = self.cfg.attn_logit_softcap

        for li in range(self.cfg.num_layers):
            def attend(q, k, v, li=li):
                return attention_prefill(q, k, v, seq_lens, logit_softcap=cap,
                                         window=self._window(li))

            x, _, _ = self._block(li, x, rope, attend)
        return x

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Cache-free full forward: tokens [B, T] (or `embeds` [B, T, E] in
        their place) → logits [B, T, V] f32."""
        return self._unembed(self._bucket_layers(self._embed_in(tokens, embeds), None))

    @torch.no_grad()
    def hidden_states(self, tokens: torch.Tensor, seq_lens: torch.Tensor | None = None,
                      embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Final-norm hidden states [B, T, E] of tokens [B, T] (the
        embeddings path; no head). seq_lens [B] masks each row's padding
        keys out of attention (None: all valid); `embeds` [B, T, E]
        replaces the embedding lookup."""
        return self._final_norm(self._bucket_layers(self._embed_in(tokens, embeds), seq_lens))

    def _kv_buffers(self, n: int, like: torch.Tensor):
        cfg = self.cfg
        shape = (cfg.num_layers, n, self.n_kv_heads, cfg.head_dim_)
        return (torch.empty(shape, dtype=like.dtype, device=like.device),
                torch.empty(shape, dtype=like.dtype, device=like.device))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, length: int, cache: PagedKVCache,
                slot: int, table_row: torch.Tensor,
                embeds: torch.Tensor | None = None) -> tuple[torch.Tensor, PagedKVCache]:
        """Prefill ONE slot. tokens: [T] (padded bucket), length: valid
        count, table_row: [max_pages] the slot's pages, embeds: [T, E] rows
        in place of the tokens' embeddings (the vision splice). Returns
        (last-valid-token logits [V] f32, cache with lengths[slot] =
        length)."""
        t = tokens.shape[0]
        x = self._embed_in(tokens, embeds)[None]             # [1, T, E]
        rope = rope_tables(torch.arange(t, device=x.device)[None], self.inv_freq)
        seq_lens = torch.tensor([length], dtype=torch.int32, device=x.device)
        k_new, v_new = self._kv_buffers(t, x)
        cap = self.cfg.attn_logit_softcap

        for li in range(self.cfg.num_layers):
            def attend(q, k, v, li=li):
                return attention_prefill(q, k, v, seq_lens, logit_softcap=cap,
                                         window=self._window(li))

            x, k, v = self._block(li, x, rope, attend)
            k_new[li], v_new[li] = k[0], v[0]
        logits = self._unembed(x[0, max(length - 1, 0)])
        write_prefill_all(cache.k, cache.v, k_new, v_new, table_row, 0, length,
                          cache.page_size)
        cache.page_table[slot] = table_row
        cache.lengths[slot] = length
        return logits, cache

    def _chunk_rows(self, cache: PagedKVCache, tokens: torch.Tensor, start: int,
                    total: int, table_row: torch.Tensor, group=None,
                    embeds: torch.Tensor | None = None):
        """Layer loop of a chunk: the chunk rows (one slot's prefill chunk at
        positions start + i) plus, with `group` = (tokens [S], positions
        [S]), one decode row per slot, in one ragged launch per layer; with
        ragged attention off (never with a group), through
        attention_prefix_chunk. `embeds` [C, E] replaces the chunk rows'
        embeddings (never the decode rows').
        Returns (hidden rows [1, C+S, E], k_new, v_new [L, C+S, KVH, D])."""
        c = tokens.shape[0]
        dev = cache.k.device
        pos = start + torch.arange(c, device=dev, dtype=torch.int32)
        x = self._embed_in(tokens, embeds)
        if group is not None:
            g_tokens, g_pos = group
            x = torch.cat([x, self._embed(g_tokens)])
            pos = torch.cat([pos, g_pos])
        x = x[None]
        rope = rope_tables(pos[None], self.inv_freq)
        k_new, v_new = self._kv_buffers(x.shape[1], x)
        ps, cap = cache.page_size, self.cfg.attn_logit_softcap
        per_phase = not self.ragged_attention
        if per_phase:  # start and total as device scalars for every layer's kernel
            bounds = torch.tensor([start, total], dtype=torch.int32, device=dev)

        for li in range(self.cfg.num_layers):
            window = self._window(li)

            def attend(q, k, v, li=li, window=window):
                if per_phase:
                    return attention_prefix_chunk(
                        q, cache.k, cache.v, table_row, bounds[0:1], bounds[1:2], ps,
                        k_cur=k[0], v_cur=v[0], layer=li, logit_softcap=cap, window=window)
                kw = {}
                if group is not None:
                    kw = dict(q_group=q[0, c:][:, None], page_table=cache.page_table,
                              group_lengths=group[1], k_group=k[0, c:][:, None],
                              v_group=v[0, c:][:, None])
                oc, og = ragged_paged_attention(
                    cache.k, cache.v, ps, q_chunk=q[:, :c], chunk_row=table_row,
                    chunk_start=start, chunk_total=total, k_chunk=k[0, :c],
                    v_chunk=v[0, :c], layer=li, logit_softcap=cap, window=window, **kw)
                return oc if og is None else torch.cat([oc, og[:, 0][None]], dim=1)

            x, k, v = self._block(li, x, rope, attend)
            k_new[li], v_new[li] = k[0], v[0]
        return x, k_new, v_new

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, start: int, length: int,
                      cache: PagedKVCache, slot: int, table_row: torch.Tensor,
                      embeds: torch.Tensor | None = None) -> tuple[torch.Tensor, PagedKVCache]:
        """Prefill ONE chunk of one slot against its cached prefix. tokens:
        [C] (padded chunk), start: absolute position of tokens[0] (page-
        aligned), length: valid tokens in this chunk, embeds: [C, E] rows in
        place of the tokens' embeddings. Returns (last-valid-token logits
        [V] f32, cache with lengths[slot] = start + length)."""
        x, k_new, v_new = self._chunk_rows(cache, tokens, start, start + length,
                                           table_row, embeds=embeds)
        logits = self._unembed(x[0, max(length - 1, 0)])
        write_prefill_all(cache.k, cache.v, k_new, v_new, table_row, start, length,
                          cache.page_size)
        cache.page_table[slot] = table_row
        cache.lengths[slot] = start + length
        return logits, cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: PagedKVCache,
                    active: torch.Tensor) -> tuple[torch.Tensor, PagedKVCache]:
        """One decode step for ALL slots. tokens: [S] last token per slot,
        active: [S] bool. Returns (logits [S, V] f32, cache with lengths
        advanced for active slots, capped at the pool-wide capacity)."""
        s = tokens.shape[0]
        positions = cache.lengths.clone()   # the new token's position per slot
        x = self._embed(tokens)
        rope = rope_tables(positions[:, None], self.inv_freq)
        k_new, v_new = self._kv_buffers(s, x)
        ps, cap = cache.page_size, self.cfg.attn_logit_softcap

        for li in range(self.cfg.num_layers):
            window = self._window(li)

            def attend(q, k, v, li=li, window=window):  # one query row per slot: Td = 1
                if not self.ragged_attention:
                    return paged_attention_decode(
                        q[:, 0], cache.k, cache.v, cache.page_table, positions, ps,
                        k_cur=k[:, 0], v_cur=v[:, 0], layer=li, logit_softcap=cap,
                        window=window)[:, None]
                _, og = ragged_paged_attention(
                    cache.k, cache.v, ps, q_group=q, page_table=cache.page_table,
                    group_lengths=positions, k_group=k, v_group=v, layer=li,
                    logit_softcap=cap, window=window)
                return og

            x, k, v = self._block(li, x[:, None], rope, attend)
            x, k_new[li], v_new[li] = x[:, 0], k[:, 0], v[:, 0]
        logits = self._unembed(x)
        write_decode_all(cache.k, cache.v, k_new, v_new, cache.page_table,
                         positions, active, ps)
        cache.lengths.copy_(torch.clamp(positions + active.to(positions.dtype),
                                        max=cache.max_context))
        return logits, cache

    @torch.no_grad()
    def verify_step(self, tokens: torch.Tensor, cache: PagedKVCache, active: torch.Tensor,
                    tree_pos=None, tree_mask=None) -> tuple[torch.Tensor, PagedKVCache]:
        """One speculative-verify forward for ALL slots. tokens: [S, T]
        candidate blocks (col 0 the committed last token, cols 1.. the
        drafts), active: [S] bool. Returns (logits [S, T, V] f32, row j the
        distribution after candidates 0..j; the cache with the candidates'
        K/V written OPTIMISTICALLY at lengths[s] + j and the lengths left
        unchanged: the caller commits the accepted length with
        ops.kvcache.rollback_to_length).

        Tree verify: with `tree_pos` ([T] node depths) and `tree_mask`
        ([T, T] ancestor-or-self), host arrays of one topology for all
        slots, cols 1.. are the nodes of a token tree. Node j takes rope at
        its LOGICAL position lengths[s] + tree_pos[j] and attends the prefix
        plus its ancestors; its K/V are still written at the STORAGE
        position lengths[s] + j (the caller compacts the accepted path with
        ops.kvcache.commit_tree_path), and logits row j is the distribution
        after node j's root path."""
        cfg = self.cfg
        s, t = tokens.shape
        base = cache.lengths.clone()
        offsets = torch.arange(t, device=base.device, dtype=base.dtype)
        storage = base[:, None] + offsets
        tree = {}
        logical = storage
        if tree_pos is not None:
            tree = dict(tree_pos=tree_pos, tree_mask=tree_mask)
            logical = base[:, None] + torch.as_tensor(np.asarray(tree_pos), dtype=base.dtype,
                                                      device=base.device)
        x = self._embed(tokens)                                  # [S, T, E]
        rope = rope_tables(logical, self.inv_freq)
        shape = (cfg.num_layers, s, t, self.n_kv_heads, cfg.head_dim_)
        k_new = torch.empty(shape, dtype=x.dtype, device=x.device)
        v_new = torch.empty(shape, dtype=x.dtype, device=x.device)
        ps, cap = cache.page_size, cfg.attn_logit_softcap

        for li in range(cfg.num_layers):
            window = self._window(li)

            def attend(q, k, v, li=li, window=window):
                if not self.ragged_attention:
                    return paged_attention_verify(
                        q, cache.k, cache.v, cache.page_table, base, ps, k, v,
                        layer=li, logit_softcap=cap, window=window, **tree)
                _, og = ragged_paged_attention(
                    cache.k, cache.v, ps, q_group=q, page_table=cache.page_table,
                    group_lengths=base, k_group=k, v_group=v, layer=li, logit_softcap=cap,
                    window=window, **tree)
                return og

            x, k_new[li], v_new[li] = self._block(li, x, rope, attend)
        logits = self._unembed(x)
        write_multi_all(cache.k, cache.v, k_new, v_new, cache.page_table, storage,
                        active, ps)
        return logits, cache

    @torch.no_grad()
    def mixed_step(self, chunk_tokens: torch.Tensor, chunk_start: int, chunk_len: int,
                   slot: int, table_row: torch.Tensor, tokens: torch.Tensor,
                   cache: PagedKVCache, active: torch.Tensor,
                   embeds: torch.Tensor | None = None):
        """One fused chunked-prefill + decode step: the prefill chunk of ONE
        admitting slot plus one decode token for every active slot, one
        ragged attention launch per layer; `embeds` [C, E] replaces the
        chunk rows' embeddings. Returns (chunk last-valid-token logits [V],
        decode logits [S, V], cache with the chunk written and active slots
        advanced by one). Needs ragged attention."""
        if not self.ragged_attention:
            raise ValueError("mixed_step needs a model built with ragged_attention=True")
        c = chunk_tokens.shape[0]
        positions = cache.lengths.clone()
        total = chunk_start + chunk_len
        x, k_new, v_new = self._chunk_rows(cache, chunk_tokens, chunk_start, total,
                                           table_row, group=(tokens, positions),
                                           embeds=embeds)
        chunk_logits = self._unembed(x[0, max(chunk_len - 1, 0)])
        dec_logits = self._unembed(x[0, c:])
        # the two regions write disjoint pages (the admitting slot is not
        # active yet), so their order is immaterial
        write_prefill_all(cache.k, cache.v, k_new[:, :c].contiguous(),
                          v_new[:, :c].contiguous(), table_row, chunk_start,
                          chunk_len, cache.page_size)
        write_decode_all(cache.k, cache.v, k_new[:, c:].contiguous(),
                         v_new[:, c:].contiguous(), cache.page_table, positions,
                         active, cache.page_size)
        new_lengths = torch.clamp(positions + active.to(positions.dtype),
                                  max=cache.max_context)
        new_lengths[slot] = total
        cache.lengths.copy_(new_lengths)
        cache.page_table[slot] = table_row
        return chunk_logits, dec_logits, cache


# ---------------------------------------------------------------------------
# HF weight layout (the contract with transformers' LlamaForCausalLM)
# ---------------------------------------------------------------------------

# The JAX package's HF_MAP: leaf name → (HF tensor name template, transpose?);
# {} is the layer index. HF stores projections [out, in], this module
# [in, out], hence transpose on the matmul leaves.
HF_MAP: dict[str, tuple[str, bool]] = {
    "attn_norm": ("model.layers.{}.input_layernorm.weight", False),
    "wq": ("model.layers.{}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{}.self_attn.o_proj.weight", True),
    "mlp_norm": ("model.layers.{}.post_attention_layernorm.weight", False),
    "w_gate": ("model.layers.{}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{}.mlp.down_proj.weight", True),
}


def hf_map(cfg: ModelConfig) -> dict[str, tuple[str, bool]]:
    """HF_MAP with the config's family leaves: qwen2's q/k/v bias and
    qwen3's q/k norms."""
    m = dict(HF_MAP)
    if cfg.attn_bias:
        m["bq"] = ("model.layers.{}.self_attn.q_proj.bias", False)
        m["bk"] = ("model.layers.{}.self_attn.k_proj.bias", False)
        m["bv"] = ("model.layers.{}.self_attn.v_proj.bias", False)
    if cfg.qk_norm:
        m["q_norm"] = ("model.layers.{}.self_attn.q_norm.weight", False)
        m["k_norm"] = ("model.layers.{}.self_attn.k_norm.weight", False)
    return m
