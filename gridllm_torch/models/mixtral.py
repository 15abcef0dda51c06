"""Mixtral sparse-MoE decoder (mixtral:8x7b) as an nn.Module.

The counterpart of the JAX package's ``models/mixtral.py``. `Mixtral` is a
`Llama` subclass: attention, norms, the paged entry points and the
deferred pool writes are the skeleton's, and the feed-forward is a top-k
routed mixture of experts (`_mlp`). Its stacked leaves: `router [L, E, X]`
and the experts `we_gate`/`we_up [L, X, E, F]`, `we_down [L, X, F, E]`, in
place of the dense FFN's. Neither the router nor the experts quantize (they
are not QUANT_LEAVES), so int8 weights cover the attention projections and
the head only, as in the JAX package.

Routing follows HF `MixtralSparseMoeBlock`: a float32 softmax over all the
expert logits, top-k, the selected weights renormalized (`_route`). Two
forms compute the same function (`moe_mlp` picks one per call):

- dense (`_moe_mlp_dense`): every expert computes every token and the
  unselected (token, expert) pairs are weighted 0; one batched product per
  projection over the stacked expert axis, no host read. Decode-sized
  calls (fewer than `_RAGGED_MIN_TOKENS` tokens) always take it: a decode
  step's expert products read all the weights either way.
- ragged (`_moe_mlp_ragged`): the T·k (token, expert) rows stably sorted
  by expert, one product per expert over its row group, the rows scaled by
  their routing weight and scatter-added back. T·k row products instead of
  T·X (4× fewer for mixtral:8x7b), exact (no capacity, no dropped token).
  The group sizes are read on the host once per call (one device sync per
  layer) to slice the groups: only calls of 16 or more tokens take this
  form (bucket prefill, chunk, mixed and verify steps), and only when
  GRIDLLM_MOE_RAGGED is 1, or auto on CUDA.
`MOE_FORMS` counts the calls of each form.

Weight layout contract: HF MixtralForCausalLM (`HF_MAP`: w1 = gate,
w2 = down, w3 = up).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gridllm_torch.models import llama
from gridllm_torch.models.configs import ModelConfig
from gridllm_torch.models.llama import Llama
from gridllm_torch.utils.config import env_str

# calls at or above this many tokens may take the ragged form; below it
# (decode steps, small batches) the dense form, with no host read
_RAGGED_MIN_TOKENS = 16
EXPERT_LEAVES = ("router", "we_gate", "we_up", "we_down")
# MoE calls by the form they took (read by chip_smoke.py's mixtral phase)
MOE_FORMS = {"dense": 0, "ragged": 0}


def _route(cfg: ModelConfig, lp: dict, x: torch.Tensor):
    """Router math: float32 softmax over ALL expert logits → top-k →
    renormalize. Returns (top_w [..., k] float32, top_i [..., k])."""
    probs = torch.softmax(x.float() @ lp["router"].float(), dim=-1)
    top_w, top_i = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return top_w / top_w.sum(dim=-1, keepdim=True), top_i


def _moe_mlp_dense(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Every expert computes every token, unselected pairs weighted 0:
    gate and up as one batched product over the X experts, down as one
    product contracting experts and F together (the JAX einsum's)."""
    lead, e = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, e)                                        # [N, E]
    top_w, top_i = _route(cfg, lp, xf)
    gates = torch.zeros(xf.shape[0], cfg.num_experts, dtype=torch.float32,
                        device=x.device).scatter_(1, top_i, top_w).to(x.dtype)
    g = torch.matmul(xf[None], lp["we_gate"])                   # [X, N, F]
    u = torch.matmul(xf[None], lp["we_up"])
    y = F.silu(g) * u * gates.T[:, :, None]
    x_, f = lp["we_down"].shape[:2]
    down = y.transpose(0, 1).reshape(xf.shape[0], x_ * f) @ lp["we_down"].reshape(x_ * f, e)
    return down.reshape(*lead, e)


def _moe_mlp_ragged(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Sorted dispatch: rows sorted by expert (stable, so token order holds
    within a group), one product per expert over its group, the routing
    weights applied and the rows scatter-added back to their tokens. Reads
    the group sizes on the host once."""
    k = cfg.experts_per_token
    lead, e = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, e)                                        # [T, E]
    t = xf.shape[0]
    top_w, top_i = _route(cfg, lp, xf)                           # [T, k]
    flat_expert = top_i.reshape(-1)                              # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    rows = torch.arange(t, device=x.device).repeat_interleave(k)[order]
    xs = xf[rows]                                                # [T*k, E] sorted
    sizes = torch.bincount(flat_expert, minlength=cfg.num_experts).tolist()
    down = torch.empty(t * k, e, dtype=x.dtype, device=x.device)
    lo = 0
    for ex, n in enumerate(sizes):
        if n:
            rs = xs[lo:lo + n]
            y = F.silu(rs @ lp["we_gate"][ex]) * (rs @ lp["we_up"][ex])
            down[lo:lo + n] = y @ lp["we_down"][ex]
            lo += n
    w = top_w.reshape(-1)[order].to(x.dtype)
    out = torch.zeros(t, e, dtype=x.dtype, device=x.device)
    out.index_add_(0, rows, down * w[:, None])
    return out.reshape(*lead, e)


def _ragged_enabled(device: torch.device) -> bool:
    raw = env_str("GRIDLLM_MOE_RAGGED").lower()
    if raw == "auto":
        # the per-expert loop pays off where the products are the cost: on
        # the card; on the CPU the dense form stays (the JAX package's auto
        # is its TPU only)
        return device.type == "cuda"
    return raw in ("1", "on", "true")


def moe_mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """The MoE feed-forward of one layer (`lp`: that layer's slices of
    EXPERT_LEAVES): x [..., E] → [..., E], in the form chosen per call
    (module docstring), counted in MOE_FORMS."""
    n_tokens = x.numel() // x.shape[-1]
    if n_tokens >= _RAGGED_MIN_TOKENS and _ragged_enabled(x.device):
        MOE_FORMS["ragged"] += 1
        return _moe_mlp_ragged(cfg, lp, x)
    MOE_FORMS["dense"] += 1
    return _moe_mlp_dense(cfg, lp, x)


class Mixtral(Llama):
    """Mixtral decoder on the Llama skeleton (see the module docstring)."""

    FIXED_INIT = {**Llama.FIXED_INIT, "router": 0.02}

    def _layer_shapes(self) -> dict[str, tuple[int, ...]]:
        cfg = self.cfg
        e, f, x, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.num_layers
        shapes = {k: s for k, s in super()._layer_shapes().items()
                  if k not in ("w_gate", "w_up", "w_down")}
        shapes.update(router=(n, e, x), we_gate=(n, x, e, f), we_up=(n, x, e, f),
                      we_down=(n, x, f, e))
        return shapes

    def name_map(self) -> dict[str, tuple[str, bool]]:
        return hf_map(self.cfg)

    def _mlp(self, li: int, x: torch.Tensor) -> torch.Tensor:
        lp = self.layers
        return moe_mlp(self.cfg, {k: lp[k][li] for k in EXPERT_LEAVES}, x)


# ---------------------------------------------------------------------------
# HF weight layout (the contract with transformers' MixtralForCausalLM)
# ---------------------------------------------------------------------------

# llama's map without the dense FFN, plus the router and the experts (two
# {} slots: layer, expert); w1 = gate, w2 = down, w3 = up
HF_MAP: dict[str, tuple[str, bool]] = {
    **{k: v for k, v in llama.HF_MAP.items() if k not in ("w_gate", "w_up", "w_down")},
    "router": ("model.layers.{}.block_sparse_moe.gate.weight", True),
    "we_gate": ("model.layers.{}.block_sparse_moe.experts.{}.w1.weight", True),
    "we_down": ("model.layers.{}.block_sparse_moe.experts.{}.w2.weight", True),
    "we_up": ("model.layers.{}.block_sparse_moe.experts.{}.w3.weight", True),
}


def hf_map(cfg: ModelConfig) -> dict[str, tuple[str, bool]]:
    return dict(HF_MAP)
