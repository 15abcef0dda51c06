"""Gemma-2 family decoder (gemma2:2b/9b/27b) as an nn.Module.

The counterpart of the JAX package's ``models/gemma.py``. `Gemma2` is a
`Llama` subclass: the six entry points (forward, prefill, prefill_chunk,
decode_step, verify_step with chain and tree, mixed_step), the paged
bookkeeping and the deferred all-layer pool writes are the skeleton's,
and this module owns only what gemma2 computes differently:

- RMSNorm in float32 multiplying by (1 + w) (`gemma_norm`);
- four norms per layer: pre/post attention and pre/post feed-forward, the
  post-norms applied to the sublayer OUTPUT before the residual;
- GeGLU with tanh-approximated gelu;
- embeddings scaled by sqrt(hidden_size), the normalizer cast to the
  activation dtype first (HF's rounding);
- attention logits tanh-softcapped (`attn_logit_softcap`, which the
  skeleton passes to every attention call) and scaled by
  query_pre_attn_scalar ** -0.5: q is pre-scaled by sqrt(d / qpas) after
  rope, so the attention kernels keep their 1/sqrt(d);
- a sliding window on EVEN layers (HF: layer_idx % 2 == 0), a host int per
  layer's launch (`_window`);
- tied head, float32 logits, tanh-softcapped by final_logit_softcap;
- with int8 weights every projection goes through `qdot`; the tied head
  stays in the load dtype (embed is not a quant leaf);
- under a tensor-parallel mesh the row-parallel partial sums of wo and
  w_down are summed over tp BEFORE their post-norms (an RMSNorm is not
  linear), and the vocab-split tied head's logits are gathered (the
  final softcap is elementwise: it goes on after the gather).

Parameters keep the JAX pytree's names and layout (stacked [L] leaves,
projections [in, out]), so `params_from_jax` copies a JAX gemma2 pytree
leaf for leaf. Weight layout contract: HF Gemma2ForCausalLM (`HF_MAP`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gridllm_torch.models.configs import ModelConfig
from gridllm_torch.models.llama import Llama
from gridllm_torch.ops.layers import rotate
from gridllm_torch.ops.quant import qdot
from gridllm_torch.parallel import collectives


def gemma_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma RMSNorm: float32, times (1 + w), cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dtype)


class Gemma2(Llama):
    """Gemma-2 decoder on the Llama skeleton (see the module docstring)."""

    NORMS = ("attn_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm")
    NORM_INIT = 0.0   # the (1 + w) convention: zeros are the identity scale

    def _layer_shapes(self) -> dict[str, tuple[int, ...]]:
        cfg = self.cfg
        e, f = cfg.hidden_size, cfg.intermediate_size
        h, kvh, d, n = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
        return {
            "attn_norm": (n, e), "wq": (n, e, h * d), "wk": (n, e, kvh * d),
            "wv": (n, e, kvh * d), "wo": (n, h * d, e), "post_attn_norm": (n, e),
            "pre_ffn_norm": (n, e), "w_gate": (n, e, f), "w_up": (n, e, f),
            "w_down": (n, f, e), "post_ffn_norm": (n, e),
        }

    def name_map(self) -> dict[str, tuple[str, bool]]:
        return hf_map(self.cfg)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = super()._embed(tokens)
        # HF casts the sqrt(E) normalizer to the hidden dtype BEFORE the multiply
        return x * torch.tensor(math.sqrt(self.cfg.hidden_size), dtype=x.dtype)

    def _embed_in(self, tokens: torch.Tensor, embeds: torch.Tensor | None) -> torch.Tensor:
        if embeds is None:
            return self._embed(tokens)
        # given rows take the sqrt(E) normalizer too (the JAX `_embed_in`)
        x = embeds.to(self.dtype)
        return x * torch.tensor(math.sqrt(self.cfg.hidden_size), dtype=x.dtype)

    def _q_prescale(self, q: torch.Tensor) -> torch.Tensor:
        """Make the kernels' 1/sqrt(d) scale equal gemma's 1/sqrt(qpas)."""
        d = self.cfg.head_dim_
        qpas = self.cfg.query_pre_attn_scalar or d
        if qpas == d:
            return q
        return q * torch.tensor(math.sqrt(d / qpas), dtype=q.dtype)

    def _block(self, li: int, x: torch.Tensor, rope, attend) -> tuple:
        """One gemma2 layer: returns (x out, k, v)."""
        lp, eps = self.layers, self.cfg.rms_eps
        q, k, v = self._qkv(li, gemma_norm(x, lp["attn_norm"][li], eps))
        q, k = rotate(q, *rope), rotate(k, *rope)
        att = qdot(attend(self._q_prescale(q), k, v).reshape(*x.shape[:-1], -1),
                   self._w("wo", li))
        x = x + gemma_norm(self._row_sum("wo", att), lp["post_attn_norm"][li], eps)
        hx = gemma_norm(x, lp["pre_ffn_norm"][li], eps)
        hx = qdot(F.gelu(qdot(hx, self._w("w_gate", li)), approximate="tanh")
                  * qdot(hx, self._w("w_up", li)), self._w("w_down", li))
        return x + gemma_norm(self._row_sum("w_down", hx), lp["post_ffn_norm"][li], eps), k, v

    def _window(self, li: int) -> int:
        """The sliding window on even layers, full attention on odd ones."""
        return self.cfg.sliding_window if li % 2 == 0 else 0

    def _final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return gemma_norm(x, self.final_norm, self.cfg.rms_eps)

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = self._final_norm(x)
        # tied head: embed is no quant leaf, so it stays in the load dtype
        logits = (x @ self.embed.T).float()
        if self._leaf_split("embed"):   # a vocab-split head's columns
            logits = collectives.gather_last(logits, self.mesh)
        cap = self.cfg.final_logit_softcap
        return cap * torch.tanh(logits / cap) if cap else logits


# ---------------------------------------------------------------------------
# HF weight layout (the contract with transformers' Gemma2ForCausalLM)
# ---------------------------------------------------------------------------

HF_MAP: dict[str, tuple[str, bool]] = {
    "attn_norm": ("model.layers.{}.input_layernorm.weight", False),
    "wq": ("model.layers.{}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{}.self_attn.o_proj.weight", True),
    "post_attn_norm": ("model.layers.{}.post_attention_layernorm.weight", False),
    "pre_ffn_norm": ("model.layers.{}.pre_feedforward_layernorm.weight", False),
    "w_gate": ("model.layers.{}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{}.mlp.down_proj.weight", True),
    "post_ffn_norm": ("model.layers.{}.post_feedforward_layernorm.weight", False),
}


def hf_map(cfg: ModelConfig) -> dict[str, tuple[str, bool]]:
    return dict(HF_MAP)
