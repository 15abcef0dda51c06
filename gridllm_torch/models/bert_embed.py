"""BERT-family encoder for the embeddings path (all-minilm,
mxbai-embed-large) as an nn.Module.

The counterpart of the JAX package's ``models/bert_embed.py``: post-LN
encoder layers, bidirectional attention with the padding keys masked
(`seq_lens`), logits and softmax in float32, exact GELU; one pass per
batch, no KV cache and no incremental state. The JAX package computes this
attention in plain jnp, outside any Pallas kernel, so here it is plain
torch as well.

Parameters keep the JAX pytree's names and layout (stacked [L] layer
leaves, projections [in, out]), so `params_from_jax` copies a JAX pytree
leaf for leaf. Weight layout contract: HF `BertModel` (`HF_MAP`,
`_TOP_MAP`; names with or without the "bert." prefix are read, the pooler
head is ignored).

Under a tensor-parallel mesh (the JAX package's param_shardings on this
tree) wq/wk/wv and bq/bk/bv split by heads and wo by rows: each rank
attends with its heads, the partial wo products are summed over tp and bo
is added once after the sum. w_in/w_out, bo, the norms and the embeddings
stay whole; every leaf arrives whole and each rank keeps its share.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gridllm_torch.models.configs import ModelConfig
from gridllm_torch.ops.layers import layer_norm
from gridllm_torch.parallel import collectives
from gridllm_torch.parallel.sharding import param_shardings, shard_leaf

_NEG_INF = -1e30


class BertEmbed(nn.Module):
    """BERT encoder; `layers` holds the stacked [L, ...] leaves under the
    JAX pytree's names. Generation entry points do not exist: the engine
    serves such a model through `embed` only."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda", ragged_attention: bool = True,
                 quantize: str | None = None, mesh=None):
        super().__init__()
        del ragged_attention  # no paged attention: a family-API argument only
        if quantize:
            # the encoder's weights are consumed by plain products (no qdot)
            raise ValueError(f"{cfg.name}: quantize is not supported for embedding-only models")
        self.cfg = cfg
        self.dtype = dtype
        self.quantize = None
        self.mesh = mesh if mesh is not None and mesh.shape.get("tp", 1) > 1 else None
        e, f, v, n = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.word_embed = p(v, e)
        self.pos_embed = p(cfg.max_seq_len, e)
        self.type_embed = p(2, e)
        self.embed_ln_w = p(e)
        self.embed_ln_b = p(e)
        shapes = {
            "wq": (n, e, e), "bq": (n, e), "wk": (n, e, e), "bk": (n, e),
            "wv": (n, e, e), "bv": (n, e), "wo": (n, e, e), "bo": (n, e),
            "attn_ln_w": (n, e), "attn_ln_b": (n, e),
            "w_in": (n, e, f), "b_in": (n, f), "w_out": (n, f, e), "b_out": (n, e),
            "mlp_ln_w": (n, e), "mlp_ln_b": (n, e),
        }
        # the whole shape and split dim (None: whole) of each layer leaf
        self._full = shapes
        self._dims = param_shardings({"layers": shapes}, cfg, self.mesh)["layers"]
        tp = 1 if self.mesh is None else self.mesh.shape["tp"]
        self.n_heads = cfg.num_heads // tp if self._dims["wq"] is not None else cfg.num_heads
        self.layers = nn.ParameterDict({
            k: p(*(n_ // tp if i == self._dims[k] else n_ for i, n_ in enumerate(s)))
            for k, s in shapes.items()})

    @property
    def device(self) -> torch.device:
        return self.word_embed.device

    # ------------------------------------------------------------ weights

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "BertEmbed":
        """Random weights with the JAX package's scheme: every matrix and
        embedding normal × 0.02, biases 0, LayerNorm weights 1 (drawn in
        float32 on the module's device, one layer of a stacked leaf at a
        time; a split leaf's layers drawn whole and cut)."""
        def normal_(t: torch.Tensor, name: str | None = None) -> None:
            if t.ndim < 3:
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                                    dtype=torch.float32) * 0.02)
                return
            for part in t:
                w = torch.randn(self._full[name][1:], generator=generator, device=t.device,
                                dtype=torch.float32) * 0.02
                dim = self._dims[name]
                part.copy_(w if dim is None else shard_leaf(w, dim - 1, self.mesh))

        for t in (self.word_embed, self.pos_embed, self.type_embed):
            normal_(t)
        self.embed_ln_w.fill_(1.0)
        self.embed_ln_b.zero_()
        for name, t in self.layers.items():
            if name.endswith("_ln_w"):
                t.fill_(1.0)
            elif t.ndim == 2:
                t.zero_()
            else:
                normal_(t, name)
        return self

    def params_tree(self) -> dict[str, Any]:
        """The parameters as the JAX-layout pytree, tensors shared with the
        module."""
        tree: dict[str, Any] = {k: getattr(self, k) for k in _TOP_MAP}
        tree["layers"] = dict(self.layers.items())
        return tree

    @torch.no_grad()
    def params_from_jax(self, np_params: dict[str, Any]) -> "BertEmbed":
        """Copy a JAX-layout pytree (numpy leaves; whole, each rank keeping
        its share) into the parameters."""
        tree = self.params_tree()
        pairs = [(tree[k], np_params[k]) for k in _TOP_MAP]
        pairs += [(t, shard_leaf(np.asarray(np_params["layers"][k]), self._dims[k], self.mesh))
                  for k, t in tree["layers"].items()]
        for dst, src in pairs:
            arr = np.array(src, dtype=np.float32)
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"shape {arr.shape} != {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(arr))
        return self

    @torch.no_grad()
    def params_from_hf(self, get: Callable[[str], torch.Tensor]) -> "BertEmbed":
        """Fill the parameters from HF `BertModel` tensors (`get`, e.g. a
        safetensors reader), with or without the "bert." prefix, each layer's
        tensor transposed on the module's device where the map says so."""
        from gridllm_torch.models import hf_layout

        def get_any(name: str) -> torch.Tensor:
            try:
                return get(name)
            except KeyError:
                return get("bert." + name)

        tree = self.params_tree()

        def place(path, layer, t, transpose):
            dst = tree[path[0]] if len(path) == 1 else tree[path[0]][path[1]]
            if layer is not None:
                dst = dst[layer]
            src = t.to(dst.device)
            src = src.T if transpose else src
            dim = self._dims.get(path[-1]) if len(path) > 1 else None
            if dim is not None and tuple(src.shape) != tuple(dst.shape):
                src = shard_leaf(src, dim - (layer is not None), self.mesh)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{'/'.join(path)}: checkpoint shape {tuple(src.shape)} "
                                 f"!= {tuple(dst.shape)}")
            dst.copy_(src)

        for k, name in _TOP_MAP.items():
            place((k,), None, get_any(name), False)
        hf_layout.stack_layer_leaves(self.cfg, get_any, HF_MAP, place)
        return self

    def hf_slices(self) -> dict[str, tuple[int, int, int]]:
        """No tensor is read in slices: the encoder is small, a rank reads
        each whole and keeps its share (`params_from_hf`)."""
        return {}

    def hf_tensors(self) -> dict[str, torch.Tensor]:
        """Inverse of params_from_hf: HF name → tensor view in HF
        orientation (the checkpoint writer materializes one at a time)."""
        from gridllm_torch.models import hf_layout

        out = {name: getattr(self, k) for k, name in _TOP_MAP.items()}
        out.update(hf_layout.flatten_layer_leaves(dict(self.layers.items()), self.cfg, HF_MAP))
        return out

    def free_params(self) -> None:
        """Drop every parameter's storage (the engine's unload)."""
        for p in self.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # ------------------------------------------------------------ forward

    @torch.no_grad()
    def hidden_states(self, tokens: torch.Tensor,
                      seq_lens: torch.Tensor | None = None) -> torch.Tensor:
        """tokens [B, T] → final hidden states [B, T, E]. Bidirectional
        attention; keys at positions >= seq_lens are masked, so padding
        never leaks into the valid tokens' attention."""
        cfg, lp = self.cfg, self.layers
        b, t = tokens.shape
        h = self.n_heads
        d = cfg.hidden_size // cfg.num_heads
        eps = cfg.rms_eps
        dev = self.device
        if seq_lens is None:
            seq_lens = torch.full((b,), t, dtype=torch.int32, device=dev)
        ids = tokens.to(dev).long().clamp(0, cfg.vocab_size - 1)
        x = self.word_embed[ids] + self.pos_embed[:t][None] + self.type_embed[0][None, None]
        x = layer_norm(x, self.embed_ln_w, self.embed_ln_b, eps)
        key_valid = (torch.arange(t, device=dev)[None]
                     < seq_lens.to(dev)[:, None])[:, None, None, :]   # [B, 1, 1, T]
        scale = 1.0 / float(np.sqrt(d))

        for li in range(cfg.num_layers):
            def proj(w, bias):
                return (x @ lp[w][li] + lp[bias][li]).reshape(b, t, h, d)

            q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
            logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
            logits = logits.masked_fill(~key_valid, _NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            attn = torch.einsum("bhts,bshd->bthd", probs, v.float()).to(x.dtype)
            attn = attn.reshape(b, t, -1) @ lp["wo"][li]
            if self._dims["wo"] is not None:   # the rank's heads: a partial sum
                attn = collectives.all_reduce_sum(attn, self.mesh)
            attn = attn + lp["bo"][li]
            x = layer_norm(x + attn, lp["attn_ln_w"][li], lp["attn_ln_b"][li], eps)
            ff = F.gelu(x @ lp["w_in"][li] + lp["b_in"][li], approximate="none")
            ff = ff @ lp["w_out"][li] + lp["b_out"][li]
            x = layer_norm(x + ff, lp["mlp_ln_w"][li], lp["mlp_ln_b"][li], eps)
        return x


def pool(hidden: torch.Tensor, seq_lens: torch.Tensor, mode: str) -> torch.Tensor:
    """[B, T, E] → [B, E] float32, L2-normalized. mode: "mean" (all-minilm,
    the sentence-transformers default, and every decoder family) over the
    valid positions, or "cls" (mxbai: position 0)."""
    hidden = hidden.float()
    if mode == "cls":
        pooled = hidden[:, 0]
    else:
        t = hidden.shape[1]
        mask = (torch.arange(t, device=hidden.device)[None]
                < seq_lens.to(hidden.device)[:, None])[..., None].float()
        pooled = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


# ---------------------------------------------------------------------------
# HF weight layout (the contract with transformers' BertModel)
# ---------------------------------------------------------------------------

# layer leaf → (BertModel tensor template, transpose?)
HF_MAP: dict[str, tuple[str, bool]] = {
    "wq": ("encoder.layer.{}.attention.self.query.weight", True),
    "bq": ("encoder.layer.{}.attention.self.query.bias", False),
    "wk": ("encoder.layer.{}.attention.self.key.weight", True),
    "bk": ("encoder.layer.{}.attention.self.key.bias", False),
    "wv": ("encoder.layer.{}.attention.self.value.weight", True),
    "bv": ("encoder.layer.{}.attention.self.value.bias", False),
    "wo": ("encoder.layer.{}.attention.output.dense.weight", True),
    "bo": ("encoder.layer.{}.attention.output.dense.bias", False),
    "attn_ln_w": ("encoder.layer.{}.attention.output.LayerNorm.weight", False),
    "attn_ln_b": ("encoder.layer.{}.attention.output.LayerNorm.bias", False),
    "w_in": ("encoder.layer.{}.intermediate.dense.weight", True),
    "b_in": ("encoder.layer.{}.intermediate.dense.bias", False),
    "w_out": ("encoder.layer.{}.output.dense.weight", True),
    "b_out": ("encoder.layer.{}.output.dense.bias", False),
    "mlp_ln_w": ("encoder.layer.{}.output.LayerNorm.weight", False),
    "mlp_ln_b": ("encoder.layer.{}.output.LayerNorm.bias", False),
}
_TOP_MAP: dict[str, str] = {
    "word_embed": "embeddings.word_embeddings.weight",
    "pos_embed": "embeddings.position_embeddings.weight",
    "type_embed": "embeddings.token_type_embeddings.weight",
    "embed_ln_w": "embeddings.LayerNorm.weight",
    "embed_ln_b": "embeddings.LayerNorm.bias",
}
