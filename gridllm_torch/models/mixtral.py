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

Under a mesh (the JAX package's `_moe_mlp` with a mesh) the experts split
over ep on X and over tp on F (parallel/sharding.py), and the router and x
are replicated, so every rank routes every token alike. Each rank computes
its X/ep experts on its F/tp columns, and one all-reduce over the axes
that actually split the experts (`Mixtral._expert_axes`: summing over an
axis that kept them whole would multiply the output by its size) gives
every rank the whole output:

- meshed dense (`_moe_mlp_dense` on the rank's experts): every local
  expert on every token, weighted by the gates of the rank's expert range;
- ragged EP (`_moe_mlp_ragged` on the rank's experts, JAX
  `_moe_mlp_ragged_ep`): the rows routed to the rank's range sorted by
  expert, those outside it to the tail, which is never computed nor
  added; one product per local expert over its group, the sizes read on
  the host once a layer. Calls of 16 or
  more tokens take it where X divides by ep and F by tp and the ragged form
  is enabled (as JAX picks it); the rest take the meshed dense form.
`MOE_FORMS` counts the calls of each form ("dense", "ragged" unmeshed;
"dense_ep", "ragged_ep" meshed).

Weight layout contract: HF MixtralForCausalLM (`HF_MAP`: w1 = gate,
w2 = down, w3 = up).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gridllm_torch.models import llama
from gridllm_torch.models.configs import ModelConfig
from gridllm_torch.models.llama import Llama
from gridllm_torch.parallel import collectives
from gridllm_torch.parallel.mesh import GROUP_AXES
from gridllm_torch.utils.config import env_str

# calls at or above this many tokens may take the ragged form; below it
# (decode steps, small batches) the dense form, with no host read
_RAGGED_MIN_TOKENS = 16
EXPERT_LEAVES = ("router", "we_gate", "we_up", "we_down")
# MoE calls by the form they took (read by chip_smoke.py's mixtral and ep
# phases)
MOE_FORMS = {"dense": 0, "ragged": 0, "dense_ep": 0, "ragged_ep": 0}


def _route(cfg: ModelConfig, lp: dict, x: torch.Tensor):
    """Router math: float32 softmax over ALL expert logits → top-k →
    renormalize. Returns (top_w [..., k] float32, top_i [..., k])."""
    probs = torch.softmax(x.float() @ lp["router"].float(), dim=-1)
    top_w, top_i = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return top_w / top_w.sum(dim=-1, keepdim=True), top_i


def _moe_mlp_dense(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                   experts: tuple[int, int] | None = None) -> torch.Tensor:
    """Every expert computes every token, unselected pairs weighted 0:
    gate and up as one batched product over the X experts, down as one
    product contracting experts and F together (the JAX einsum's). With
    `experts` = [lo, hi), `lp` holds only those experts (a rank's, on its
    F slice) and the result is the rank's partial sum."""
    lead, e = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, e)                                        # [N, E]
    top_w, top_i = _route(cfg, lp, xf)
    gates = torch.zeros(xf.shape[0], cfg.num_experts, dtype=torch.float32,
                        device=x.device).scatter_(1, top_i, top_w).to(x.dtype)
    if experts is not None:
        gates = gates[:, experts[0]:experts[1]]
    g = torch.matmul(xf[None], lp["we_gate"])                   # [X, N, F]
    u = torch.matmul(xf[None], lp["we_up"])
    y = F.silu(g) * u * gates.T[:, :, None]
    x_, f = lp["we_down"].shape[:2]
    down = y.transpose(0, 1).reshape(xf.shape[0], x_ * f) @ lp["we_down"].reshape(x_ * f, e)
    return down.reshape(*lead, e)


def _moe_mlp_ragged(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                    experts: tuple[int, int] | None = None) -> torch.Tensor:
    """Sorted dispatch: rows sorted by expert (stable, so token order holds
    within a group), one product per expert over its group, the routing
    weights applied and the rows scatter-added back to their tokens. Reads
    the group sizes on the host once. With `experts` = [lo, hi) (JAX
    `_moe_mlp_ragged_ep`'s shard), `lp` holds only those experts (a rank's,
    on its F slice): the rows routed elsewhere sort to the tail, which is
    neither computed nor added (JAX computes it with group size 0 and
    zeroes it), and the result is the rank's partial sum."""
    k = cfg.experts_per_token
    lead, e = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, e)                                        # [T, E]
    t = xf.shape[0]
    top_w, top_i = _route(cfg, lp, xf)                           # [T, k], alike on every rank
    lo, hi = experts or (0, cfg.num_experts)
    local = top_i.reshape(-1) - lo                               # [T*k]
    key = torch.where((local >= 0) & (local < hi - lo), local,
                      torch.full_like(local, hi - lo))           # the other ranks' last
    sizes = torch.bincount(key, minlength=hi - lo + 1)[:hi - lo].tolist()
    order = torch.argsort(key, stable=True)[:sum(sizes)]
    rows = torch.arange(t, device=x.device).repeat_interleave(k)[order]
    xs = xf[rows]                                                # sorted
    down = torch.empty(xs.shape[0], e, dtype=x.dtype, device=x.device)
    pos = 0
    for ex, n in enumerate(sizes):
        if n:
            rs = xs[pos:pos + n]
            y = F.silu(rs @ lp["we_gate"][ex]) * (rs @ lp["we_up"][ex])
            down[pos:pos + n] = y @ lp["we_down"][ex]
            pos += n
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


def moe_mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor, mesh=None,
            experts: tuple[int, int] | None = None,
            axes: tuple[str, ...] = ()) -> torch.Tensor:
    """The MoE feed-forward of one layer (`lp`: that layer's slices of
    EXPERT_LEAVES, a rank's under a mesh): x [..., E] → [..., E], in the
    form chosen per call (module docstring), counted in MOE_FORMS. `axes`
    are the mesh axes that split the experts (none: every rank holds them
    whole and computes the unmeshed forms), `experts` the rank's [lo, hi)
    on X."""
    n_tokens = x.numel() // x.shape[-1]
    ragged = n_tokens >= _RAGGED_MIN_TOKENS and _ragged_enabled(x.device)
    if axes:
        # JAX's rule: ragged EP only where the whole layout divides
        ep, tp = mesh.shape.get("ep", 1), mesh.shape.get("tp", 1)
        divisible = cfg.num_experts % ep == 0 and cfg.intermediate_size % tp == 0
        experts = experts or (0, cfg.num_experts)
        if ragged and divisible:
            MOE_FORMS["ragged_ep"] += 1
            y = _moe_mlp_ragged(cfg, lp, x, experts)
        else:
            MOE_FORMS["dense_ep"] += 1
            y = _moe_mlp_dense(cfg, lp, x, experts)
        return collectives.all_reduce_sum(y, mesh, axes, kind="all_reduce.moe")
    if ragged:
        MOE_FORMS["ragged"] += 1
        return _moe_mlp_ragged(cfg, lp, x)
    MOE_FORMS["dense"] += 1
    return _moe_mlp_dense(cfg, lp, x)


class Mixtral(Llama):
    """Mixtral decoder on the Llama skeleton (see the module docstring)."""

    FIXED_INIT = {**Llama.FIXED_INIT, "router": 0.02}
    MESH_AXES = GROUP_AXES

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the axes that split the experts: the MoE sums over exactly these
        split = {ax for k in ("we_gate", "we_down") for ax in self._leaf_split(k).values()}
        self._expert_axes = tuple(ax for ax in GROUP_AXES if ax in split)

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

    def _expert_range(self) -> tuple[int, int] | None:
        return self._ranges("we_gate").get(1)

    def _mlp(self, li: int, x: torch.Tensor) -> torch.Tensor:
        lp = self.layers
        return moe_mlp(self.cfg, {k: lp[k][li] for k in EXPERT_LEAVES}, x, self.mesh,
                       self._expert_range(), self._expert_axes)


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
