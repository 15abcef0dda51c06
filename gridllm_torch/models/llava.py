"""Llava-family vision-language model (llava-1.5: llava:7b, llava:13b) as
an nn.Module: a CLIP-ViT tower, an MLP projector and the llama decoder.

The counterpart of the JAX package's ``models/llava.py``. `Llava` is a
`Llama` subclass: the text stack, the paged entry points and the deferred
pool writes are the skeleton's (the text stack of llava-1.5 is a plain
llama/vicuna), and the image rows reach them through the `embeds` argument
of `prefill`, `prefill_chunk` and `mixed_step`. This module owns:

- `_patchify`: the patch "convolution" (stride = kernel size) as a reshape
  and one [N, 3·ps·ps] × [3·ps·ps, Dv] product;
- `vision_tower`: pre-LN encoder layers, bidirectional multi-head attention
  with biases, quick_gelu, run up to `feature_layer` (HF hidden_states
  indexing: -2 runs all but the last of the layers), the CLS row dropped.
  The JAX package computes this attention in plain jnp, outside any Pallas
  kernel, so here it is plain torch as well;
- `encode_images`: the projector (exact GELU) on the tower's features;
- `splice_embeds`: token embeddings with the image-token positions
  overlaid by projected patch rows; `offset` counts the image tokens before
  the span, so a chunked prefill splices chunk by chunk.

Under a tensor-parallel mesh the text stack is the skeleton's, and the
tower's attention splits as the JAX package's param_shardings splits it:
wq/wk/wv and bq/bk/bv by the tower's heads, wo by rows, the partial
products summed over tp before bo is added once; fc1/fc2, the norms, the
tower's top leaves and the projector stay whole (`_vdims`). Every rank
encodes the images itself.

Parameters: the text leaves are Llama's; the tower's are `vision` (cls,
patch_embed, pos_embed, pre_ln_w/b) and `vision_layers` (stacked [Lv]
leaves), the projector's `projector`, under the JAX pytree's names, so
`params_from_jax` copies a JAX llava pytree (its `vision` and `projector`
subtrees included) leaf for leaf. Weight layout contract: HF
`LlavaForConditionalGeneration` in both namings (`_resolving_get`): the
published llava-hf checkpoints' "language_model.model.* / vision_tower.* /
multi_modal_projector.*" and transformers ≥ 4.52's "model.language_model.*
/ model.vision_tower.* / lm_head.*".
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gridllm_torch.models.configs import ModelConfig, VisionConfig
from gridllm_torch.models.llama import Llama
from gridllm_torch.ops.layers import layer_norm
from gridllm_torch.parallel import collectives
from gridllm_torch.parallel.sharding import leaf_split, shard_leaf, vision_heads


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    # CLIP's activation (HF ACT2FN["quick_gelu"])
    return x * torch.sigmoid(1.702 * x)


class Llava(Llama):
    """Llava-1.5 on the Llama skeleton (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda", ragged_attention: bool = True,
                 quantize: str | None = None, mesh=None):
        super().__init__(cfg, dtype=dtype, device=device, ragged_attention=ragged_attention,
                         quantize=quantize, mesh=mesh)
        vc = self.vc = cfg.vision_cfg or VisionConfig()
        dv, fv, lv, e = vc.hidden_size, vc.intermediate_size, vc.num_layers, cfg.hidden_size
        pdim = 3 * vc.patch_size * vc.patch_size

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.vision = nn.ParameterDict({
            "cls": p(dv), "patch_embed": p(pdim, dv), "pos_embed": p(vc.num_patches + 1, dv),
            "pre_ln_w": p(dv), "pre_ln_b": p(dv)})
        full = {
            "ln1_w": (lv, dv), "ln1_b": (lv, dv), "wq": (lv, dv, dv), "bq": (lv, dv),
            "wk": (lv, dv, dv), "bk": (lv, dv), "wv": (lv, dv, dv), "bv": (lv, dv),
            "wo": (lv, dv, dv), "bo": (lv, dv), "ln2_w": (lv, dv), "ln2_b": (lv, dv),
            "fc1": (lv, dv, fv), "b1": (lv, fv), "fc2": (lv, fv, dv), "b2": (lv, dv)}
        # the whole shape and split ({dim: axis}) of each tower layer
        # leaf, and the tower's heads on this rank
        self._vfull = full
        self._vdims = {k: leaf_split(k, s, cfg, self.mesh, heads=vision_heads(cfg))
                       for k, s in full.items()}
        split = bool(self._vdims["wq"])
        self.v_heads = vc.num_heads // self.mesh.shape["tp"] if split else vc.num_heads
        self.vision_layers = nn.ParameterDict({
            k: p(*self._local_shape(s, self._vdims[k])) for k, s in full.items()})
        self.projector = nn.ParameterDict({
            "w1": p(dv, e), "b1": p(e), "w2": p(e, e), "b2": p(e)})

    # ------------------------------------------------------------ weights

    def _vision_leaves(self):
        """(path, tensor) of every tower and projector leaf."""
        yield from ((("vision", k), t) for k, t in self.vision.items())
        yield from ((("vision", "layers", k), t) for k, t in self.vision_layers.items())
        yield from ((("projector", k), t) for k, t in self.projector.items())

    def _vcut(self, path: tuple[str, ...], x, layer_slice: bool = False):
        """This rank's share of a full tensor of tower leaf `path` (or,
        with layer_slice, of one layer of it); other leaves whole."""
        split = self._vdims.get(path[-1]) if path[:2] == ("vision", "layers") else None
        return shard_leaf(x, split, self.mesh, lead=int(layer_slice))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Llava":
        """The text stack's random weights (Llama.init_params), then the
        tower's and the projector's with the JAX package's scheme: matrices
        and embeddings normal × 0.02, biases 0, LayerNorm weights 1; a
        split leaf's layers drawn whole and cut, as the text stack's."""
        super().init_params(generator)
        for path, t in self._vision_leaves():
            name = path[-1]
            if name.startswith(("ln", "pre_ln")) and name.endswith("_w"):
                t.fill_(1.0)
            elif name.startswith("b") or name.endswith("_b"):
                t.zero_()
            elif t.ndim == 3:
                shape = self._vfull[name][1:]
                for part in t:
                    part.copy_(self._vcut(path, torch.randn(
                        shape, generator=generator, device=t.device,
                        dtype=torch.float32) * 0.02, layer_slice=True))
            else:
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                                    dtype=torch.float32) * 0.02)
        return self

    def params_tree(self) -> dict[str, Any]:
        tree = super().params_tree()
        tree["vision"] = {**dict(self.vision.items()),
                          "layers": dict(self.vision_layers.items())}
        tree["projector"] = dict(self.projector.items())
        return tree

    @torch.no_grad()
    def params_from_jax(self, np_params: dict[str, Any]) -> "Llava":
        """Copy a JAX llava pytree (numpy leaves: the text leaves at the top
        level, the `vision` and `projector` subtrees) into the parameters."""
        super().params_from_jax(np_params)
        for path, t in self._vision_leaves():
            src = np_params
            for k in path:
                src = src[k]
            arr = np.array(self._vcut(path, np.asarray(src)), dtype=np.float32)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr))
        return self

    @torch.no_grad()
    def params_from_hf(self, get: Callable[[str], torch.Tensor]) -> "Llava":
        """Fill the parameters from HF-named tensors in either llava
        naming: the text stack through Llama.params_from_hf, the patch
        convolution [Dv, 3, ps, ps] as the matmul [3·ps·ps, Dv], every other
        projection transposed to [in, out]."""
        rget = _resolving_get(get)
        super().params_from_hf(rget)
        vc, dev = self.vc, self.device

        def put(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
            src = src.to(dev)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{what}: checkpoint shape {tuple(src.shape)} "
                                 f"!= {tuple(dst.shape)}")
            dst.copy_(src)

        for leaf, name in _VISION_TOP.items():
            put(self.vision[leaf], rget(name), name)
        patch = rget(_PATCH).to(dev)
        put(self.vision["patch_embed"], patch.reshape(patch.shape[0], -1).T, _PATCH)
        for leaf, (tmpl, tr) in _VISION_LAYER_MAP.items():
            for i in range(vc.num_layers):
                name = tmpl.format(i)
                w = rget(name).to(dev)
                put(self.vision_layers[leaf][i],
                    self._vcut(("vision", "layers", leaf), w.T if tr else w, layer_slice=True),
                    name)
        for leaf, (name, tr) in _PROJ_MAP.items():
            w = rget(name).to(dev)
            put(self.projector[leaf], w.T if tr else w, name)
        return self

    def hf_tensors(self) -> dict[str, torch.Tensor]:
        """Inverse of params_from_hf in the published llava-hf naming: HF
        name → tensor view in HF orientation (the patch weight as the
        convolution's [Dv, 3, ps, ps])."""
        vc = self.vc
        canon = super().hf_tensors()
        canon.update({name: self.vision[leaf] for leaf, name in _VISION_TOP.items()})
        ps = vc.patch_size
        canon[_PATCH] = self.vision["patch_embed"].T.reshape(vc.hidden_size, 3, ps, ps)
        for leaf, (tmpl, tr) in _VISION_LAYER_MAP.items():
            for i in range(vc.num_layers):
                w = self.vision_layers[leaf][i]
                canon[tmpl.format(i)] = w.T if tr else w
        for leaf, (name, tr) in _PROJ_MAP.items():
            w = self.projector[leaf]
            canon[name] = w.T if tr else w
        return {_rename(name, _PUBLISHED): t for name, t in canon.items()}

    # ------------------------------------------------------------ vision

    def _patchify(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 3, S, S] → [B, N, 3·ps·ps], each patch flattened in the HF
        convolution kernel's (channel, row, col) order."""
        b = pixel_values.shape[0]
        ps = self.vc.patch_size
        n = self.vc.image_size // ps
        x = pixel_values.reshape(b, 3, n, ps, n, ps).permute(0, 2, 4, 1, 3, 5)
        return x.reshape(b, n * n, 3 * ps * ps)

    @torch.no_grad()
    def vision_tower(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """CLIP vision encoder: pixel_values [B, 3, S, S] (CLIP-normalized)
        → the hidden states at `feature_layer` [B, N, Dv], CLS dropped
        (llava-1.5's "default" select strategy)."""
        vc, vp, lp = self.vc, self.vision, self.vision_layers
        b = pixel_values.shape[0]
        dv, heads, dh, eps = vc.hidden_size, self.v_heads, vc.head_dim, vc.layer_norm_eps
        x = self._patchify(pixel_values.to(self.device, vp["patch_embed"].dtype)) \
            @ vp["patch_embed"]                                           # [B, N, Dv]
        cls = vp["cls"].expand(b, 1, dv).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + vp["pos_embed"]
        x = layer_norm(x, vp["pre_ln_w"], vp["pre_ln_b"], eps)
        # HF hidden_states[i] is the input of layer i (0: the embeddings
        # after the pre-LN, -1: the last layer's output), so feature_layer
        # -2 runs every layer but the last
        fl = vc.feature_layer
        n_run = vc.num_layers + 1 + fl if fl < 0 else fl
        if not 0 <= n_run <= vc.num_layers:
            raise ValueError(f"vision feature_layer {fl} out of range")
        t = x.shape[1]
        for li in range(n_run):
            h = layer_norm(x, lp["ln1_w"][li], lp["ln1_b"][li], eps)
            q = (h @ lp["wq"][li] + lp["bq"][li]).reshape(b, t, heads, dh)
            k = (h @ lp["wk"][li] + lp["bk"][li]).reshape(b, t, heads, dh)
            v = (h @ lp["wv"][li] + lp["bv"][li]).reshape(b, t, heads, dh)
            logits = torch.einsum("bthd,bshd->bhts", q, k).float()
            probs = torch.softmax(logits / math.sqrt(dh), dim=-1).to(v.dtype)
            att = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, heads * dh)
            o = att @ lp["wo"][li]
            if self._vdims["wo"]:   # the rank's heads: a partial sum
                o = collectives.all_reduce_sum(o, self.mesh)
            x = x + (o + lp["bo"][li])
            h = layer_norm(x, lp["ln2_w"][li], lp["ln2_b"][li], eps)
            x = x + (_quick_gelu(h @ lp["fc1"][li] + lp["b1"][li]) @ lp["fc2"][li]
                     + lp["b2"][li])
        return x[:, 1:]

    @torch.no_grad()
    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 3, S, S] → projected image embeddings [B, N, E_text]."""
        pj = self.projector
        h = F.gelu(self.vision_tower(pixel_values) @ pj["w1"] + pj["b1"], approximate="none")
        return h @ pj["w2"] + pj["b2"]

    @torch.no_grad()
    def splice_embeds(self, tokens: torch.Tensor, img_embeds: torch.Tensor,
                      offset: int = 0) -> torch.Tensor:
        """Token embeddings [T, E] with the image positions overlaid.

        tokens: [T], each image already expanded to num_patches copies of
        `image_token` (the engine's job); img_embeds: [M, E] projected patch
        rows of all the images in prompt order. The j-th image-token position
        of the span takes row offset + j, `offset` being the image tokens
        before the span (HF's masked fill as a dense select)."""
        base = self._embed(tokens)
        is_img = (tokens.to(base.device).long() == self.vc.image_token)
        j = offset + torch.cumsum(is_img.long(), dim=0) - 1
        j = j.clamp(0, img_embeds.shape[0] - 1)
        return torch.where(is_img[:, None], img_embeds[j].to(base.dtype), base)


# ---------------------------------------------------------------------------
# HF weight layout (the contract with transformers' LlavaForConditionalGeneration)
# ---------------------------------------------------------------------------

# canonical names: the text stack's as Llama's ("model.", "lm_head."), the
# tower's under "VIS.", the projector's under "PROJ."; each prefix maps to
# its name in the two HF namings, (transformers >= 4.52's, the published)
_PUBLISHED = 1
_ALTS = {
    "model.": ("model.language_model.", "language_model.model."),
    "lm_head.": ("lm_head.", "language_model.lm_head."),
    "VIS.": ("model.vision_tower.vision_model.", "vision_tower.vision_model."),
    "PROJ.": ("model.multi_modal_projector.", "multi_modal_projector."),
}
_PATCH = "VIS.embeddings.patch_embedding.weight"
_VISION_TOP = {
    "cls": "VIS.embeddings.class_embedding",
    "pos_embed": "VIS.embeddings.position_embedding.weight",
    # (sic) "pre_layrnorm" is HF's own spelling
    "pre_ln_w": "VIS.pre_layrnorm.weight",
    "pre_ln_b": "VIS.pre_layrnorm.bias",
}
# tower layer leaf → (HF name template, transpose?)
_VISION_LAYER_MAP: dict[str, tuple[str, bool]] = {
    "ln1_w": ("VIS.encoder.layers.{}.layer_norm1.weight", False),
    "ln1_b": ("VIS.encoder.layers.{}.layer_norm1.bias", False),
    "wq": ("VIS.encoder.layers.{}.self_attn.q_proj.weight", True),
    "bq": ("VIS.encoder.layers.{}.self_attn.q_proj.bias", False),
    "wk": ("VIS.encoder.layers.{}.self_attn.k_proj.weight", True),
    "bk": ("VIS.encoder.layers.{}.self_attn.k_proj.bias", False),
    "wv": ("VIS.encoder.layers.{}.self_attn.v_proj.weight", True),
    "bv": ("VIS.encoder.layers.{}.self_attn.v_proj.bias", False),
    "wo": ("VIS.encoder.layers.{}.self_attn.out_proj.weight", True),
    "bo": ("VIS.encoder.layers.{}.self_attn.out_proj.bias", False),
    "ln2_w": ("VIS.encoder.layers.{}.layer_norm2.weight", False),
    "ln2_b": ("VIS.encoder.layers.{}.layer_norm2.bias", False),
    "fc1": ("VIS.encoder.layers.{}.mlp.fc1.weight", True),
    "b1": ("VIS.encoder.layers.{}.mlp.fc1.bias", False),
    "fc2": ("VIS.encoder.layers.{}.mlp.fc2.weight", True),
    "b2": ("VIS.encoder.layers.{}.mlp.fc2.bias", False),
}
_PROJ_MAP: dict[str, tuple[str, bool]] = {
    "w1": ("PROJ.linear_1.weight", True),
    "b1": ("PROJ.linear_1.bias", False),
    "w2": ("PROJ.linear_2.weight", True),
    "b2": ("PROJ.linear_2.bias", False),
}


def _rename(name: str, pick: int) -> str:
    for pfx, subs in _ALTS.items():
        if name.startswith(pfx):
            return subs[pick] + name[len(pfx):]
    return name


def _resolving_get(get: Callable[[str], Any]) -> Callable[[str], Any]:
    """A getter of canonical names over a checkpoint in either HF llava
    naming: each name is tried under both, the missing one's KeyError
    raised when neither holds it."""
    def resolve(name: str):
        last: KeyError | None = None
        for pick in range(2):
            try:
                return get(_rename(name, pick))
            except KeyError as e:
                last = e
        raise last if last is not None else KeyError(name)

    return resolve
