"""HF checkpoint layout: the one place that places HF-named tensors into the
stacked-layer layout of this package's models, and flattens them back.

The counterpart of the JAX package's models/hf_layout.py. A family's name
map (`llama.hf_map(cfg)`: leaf name → (HF name template, transpose?))
owns the contract; this module owns the mechanics. HF stores projections
[out, in]; the models keep [in, out], hence `transpose` on matmul leaves.

Where the JAX package stacks each leaf's L layers into one host array and
places it, the `place` callback here takes one layer at a time —
`place(path, layer, tensor, transpose)`, `layer` None for the embedding,
final norm and head — so a loader can write each tensor straight into a
preallocated [L, ...] parameter on the device: no stacked leaf is ever
built on the host. A template with two `{}` slots (layer, expert: the
mixtral experts) is a [L, X, ...] leaf, placed one expert at a time with
`layer` the index pair (layer, expert).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from gridllm_torch.models.configs import ModelConfig

# get(hf_name) -> host tensor; place(path, layer, (layer, expert) or None,
# tensor, transpose)
Get = Callable[[str], torch.Tensor]
Place = Callable[[tuple[str, ...], "int | tuple[int, int] | None", torch.Tensor, bool], None]


def is_expert_leaf(tmpl: str) -> bool:
    """Templates with two {} slots (layer, expert) stack an extra X axis."""
    return tmpl.count("{}") == 2


def _slots(cfg: ModelConfig, tmpl: str):
    """The index of every tensor of a template: layers, or (layer, expert)."""
    if is_expert_leaf(tmpl):
        return [(i, x) for i in range(cfg.num_layers) for x in range(cfg.num_experts)]
    return list(range(cfg.num_layers))


def _name(tmpl: str, index) -> str:
    return tmpl.format(*index) if isinstance(index, tuple) else tmpl.format(index)


def stack_layer_leaves(cfg: ModelConfig, get: Get, name_map: dict[str, tuple[str, bool]],
                       place: Place) -> None:
    """Every per-layer (and per-expert) HF tensor of `name_map`, one at a
    time, to `place` with its leaf path, index and transpose flag."""
    for name, (tmpl, transpose) in name_map.items():
        for index in _slots(cfg, tmpl):
            place(("layers", name), index, get(_name(tmpl, index)), transpose)


def flatten_layer_leaves(layers: dict[str, torch.Tensor], cfg: ModelConfig,
                         name_map: dict[str, tuple[str, bool]]) -> dict[str, torch.Tensor]:
    """Inverse of stack_layer_leaves: HF name → one layer's (or expert's)
    tensor in HF orientation, a view of the stacked leaf (no copy; transposed views are
    not contiguous)."""
    out: dict[str, torch.Tensor] = {}
    for name, (tmpl, transpose) in name_map.items():
        stacked = layers[name]
        for index in _slots(cfg, tmpl):
            out[_name(tmpl, index)] = stacked[index].T if transpose else stacked[index]
    return out


def to_pytree(cfg: ModelConfig, get: Get, name_map: dict[str, tuple[str, bool]],
              place: Place) -> None:
    """Place a decoder-family checkpoint (embed, layers, final norm and,
    untied, the head) through `place`, tensor by tensor."""
    place(("embed",), None, get("model.embed_tokens.weight"), False)
    stack_layer_leaves(cfg, get, name_map, place)
    place(("final_norm",), None, get("model.norm.weight"), False)
    if not cfg.tie_embeddings:
        place(("lm_head",), None, get("lm_head.weight"), True)


def hf_names(cfg: ModelConfig, name_map: dict[str, tuple[str, bool]]):
    """(leaf, HF name, transpose?, stacked?) of every tensor to_pytree
    places, in its order."""
    yield "embed", "model.embed_tokens.weight", False, False
    for name, (tmpl, transpose) in name_map.items():
        for index in _slots(cfg, tmpl):
            yield name, _name(tmpl, index), transpose, True
    yield "final_norm", "model.norm.weight", False, False
    if not cfg.tie_embeddings:
        yield "lm_head", "lm_head.weight", True, False


def to_hf_tensors(params: dict[str, Any], cfg: ModelConfig,
                  name_map: dict[str, tuple[str, bool]]) -> dict[str, torch.Tensor]:
    """Inverse of to_pytree: HF name → tensor view of `params` (a pytree of
    tensors: embed, layers, final_norm, lm_head) in HF orientation. Views,
    so a writer materializes one tensor at a time."""
    out: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
    }
    out.update(flatten_layer_leaves(params["layers"], cfg, name_map))
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = params["lm_head"].T
    return out
