"""Model architecture configs and the name registry.

A copy of the JAX package's ``models/configs.py`` data for the families
this package serves (llama, qwen2/qwen3, the llama-skeleton mistral
entries, gemma2, mixtral and the tiny test configs):
Ollama-style model names map to the public HF architecture dimensions.
The port keeps its own copy so that it imports nothing of the JAX
package. `config_from_hf_dir` builds a config from a local HF
checkpoint's config.json (an unregistered name served from a checkpoint
directory), and `ModelConfig.hf_config` is its inverse, the config.json
that `engine.loader.save_checkpoint` writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from gridllm_torch.ops.layers import RopeScaling


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "llama"            # llama | qwen2 | qwen3 | gemma2 | mixtral
    vocab_size: int = 128_256
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int | None = None      # None → hidden_size // num_heads
    rope_theta: float = 500_000.0
    rope_scaling: RopeScaling | None = None
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    # MoE (mixtral family)
    num_experts: int = 0
    experts_per_token: int = 2
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0          # 0 → full attention
    attn_bias: bool = False          # qwen2: bias on q/k/v projections
    qk_norm: bool = False            # qwen3: per-head RMSNorm on q/k pre-rope
    # gemma2: logits scale by qpas**-0.5 (None → head_dim), lm-head
    # logits tanh-capped
    query_pre_attn_scalar: float | None = None
    final_logit_softcap: float = 0.0

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def hf_config(self, torch_dtype: str = "bfloat16") -> dict[str, Any]:
        """The HF config.json of this config (the inverse of
        `config_from_hf_dir`, and the JAX package's `hf_config` as a plain
        dict: transformers is not needed to write or read it)."""
        out: dict[str, Any] = dict(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_layers,
            num_attention_heads=self.num_heads,
            num_key_value_heads=self.num_kv_heads,
            head_dim=self.head_dim_,
            rope_theta=self.rope_theta,
            rms_norm_eps=self.rms_eps,
            tie_word_embeddings=self.tie_embeddings,
            max_position_embeddings=self.max_seq_len,
            hidden_act="silu",
            torch_dtype=torch_dtype,
        )
        if self.family == "gemma2":
            # the transformers Gemma2Config the JAX package builds for its
            # golden tests (attention_bias False, hidden_activation
            # gelu_pytorch_tanh; the window on alternate layers)
            return dict(out, model_type="gemma2", architectures=["Gemma2ForCausalLM"],
                        hidden_act="gelu_pytorch_tanh",
                        hidden_activation="gelu_pytorch_tanh", attention_bias=False,
                        sliding_window=self.sliding_window,
                        attn_logit_softcapping=self.attn_logit_softcap,
                        final_logit_softcapping=self.final_logit_softcap,
                        query_pre_attn_scalar=self.query_pre_attn_scalar or self.head_dim_)
        if self.family == "mixtral":
            # the transformers MixtralConfig the JAX package builds
            return dict(out, model_type="mixtral", architectures=["MixtralForCausalLM"],
                        num_local_experts=self.num_experts,
                        num_experts_per_tok=self.experts_per_token,
                        sliding_window=self.sliding_window or None, attention_bias=False)
        if self.family == "qwen2":
            # qwen2 hardcodes its q/k/v bias; its window is off
            return dict(out, model_type="qwen2", architectures=["Qwen2ForCausalLM"],
                        use_sliding_window=False, sliding_window=None)
        if self.family == "qwen3":
            return dict(out, model_type="qwen3", architectures=["Qwen3ForCausalLM"],
                        attention_bias=False)
        if self.sliding_window:  # the windowed llama skeleton is mistral v0.1
            return dict(out, model_type="mistral", architectures=["MistralForCausalLM"],
                        sliding_window=self.sliding_window)
        if self.rope_scaling is not None:
            out["rope_scaling"] = {
                "rope_type": "llama3",
                "factor": self.rope_scaling.factor,
                "low_freq_factor": self.rope_scaling.low_freq_factor,
                "high_freq_factor": self.rope_scaling.high_freq_factor,
                "original_max_position_embeddings":
                    self.rope_scaling.original_max_position_embeddings,
            }
        return dict(out, model_type="llama", architectures=["LlamaForCausalLM"],
                    attention_bias=self.attn_bias)


_LLAMA3_SCALING = RopeScaling(
    factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
    original_max_position_embeddings=8192,
)

REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


register(ModelConfig(
    name="llama3.2:1b", vocab_size=128_256, hidden_size=2048,
    intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
    head_dim=64, rope_theta=500_000.0, rope_scaling=_LLAMA3_SCALING,
    tie_embeddings=True, max_seq_len=131_072,
))
register(ModelConfig(
    name="llama3.2:3b", vocab_size=128_256, hidden_size=3072,
    intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
    head_dim=128, rope_theta=500_000.0, rope_scaling=_LLAMA3_SCALING,
    tie_embeddings=True, max_seq_len=131_072,
))
register(ModelConfig(
    name="llama3:8b", vocab_size=128_256, hidden_size=4096,
    intermediate_size=14_336, num_layers=32, num_heads=32, num_kv_heads=8,
    rope_theta=500_000.0, max_seq_len=8192,
))
register(ModelConfig(
    name="llama3.1:8b", vocab_size=128_256, hidden_size=4096,
    intermediate_size=14_336, num_layers=32, num_heads=32, num_kv_heads=8,
    rope_theta=500_000.0, rope_scaling=_LLAMA3_SCALING, max_seq_len=131_072,
))
register(ModelConfig(
    name="llama3:70b", vocab_size=128_256, hidden_size=8192,
    intermediate_size=28_672, num_layers=80, num_heads=64, num_kv_heads=8,
    rope_theta=500_000.0, max_seq_len=8192,
))
register(ModelConfig(
    name="qwen2.5:0.5b", family="qwen2", vocab_size=151_936, hidden_size=896,
    intermediate_size=4864, num_layers=24, num_heads=14, num_kv_heads=2,
    head_dim=64, rope_theta=1_000_000.0, rms_eps=1e-6, tie_embeddings=True,
    max_seq_len=32_768, attn_bias=True,
))
register(ModelConfig(
    name="qwen2.5:7b", family="qwen2", vocab_size=152_064, hidden_size=3584,
    intermediate_size=18_944, num_layers=28, num_heads=28, num_kv_heads=4,
    head_dim=128, rope_theta=1_000_000.0, rms_eps=1e-6,
    max_seq_len=32_768, attn_bias=True,
))
register(ModelConfig(
    name="qwen3:0.6b", family="qwen3", vocab_size=151_936, hidden_size=1024,
    intermediate_size=3072, num_layers=28, num_heads=16, num_kv_heads=8,
    head_dim=128, rope_theta=1_000_000.0, rms_eps=1e-6, tie_embeddings=True,
    max_seq_len=40_960, qk_norm=True,
))
register(ModelConfig(
    name="qwen3:8b", family="qwen3", vocab_size=151_936, hidden_size=4096,
    intermediate_size=12_288, num_layers=36, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=1_000_000.0, rms_eps=1e-6,
    max_seq_len=40_960, qk_norm=True,
))

# mistral (llama skeleton; v0.3 dropped the sliding window). Long-context
# configs: mistral-nemo's explicit head_dim 128 differs from hidden/heads.
register(ModelConfig(
    name="mistral:7b", vocab_size=32_768, hidden_size=4096,
    intermediate_size=14_336, num_layers=32, num_heads=32, num_kv_heads=8,
    rope_theta=1_000_000.0, max_seq_len=32_768, rms_eps=1e-5,
))
register(ModelConfig(
    name="mistral-nemo:12b", vocab_size=131_072, hidden_size=5120,
    intermediate_size=14_336, num_layers=40, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=1_000_000.0, max_seq_len=131_072, rms_eps=1e-5,
))

# gemma2 (public HF configs; Ollama's gemma2 tags)
register(ModelConfig(
    name="gemma2:2b", family="gemma2", vocab_size=256_000, hidden_size=2304,
    intermediate_size=9216, num_layers=26, num_heads=8, num_kv_heads=4,
    head_dim=256, rope_theta=10_000.0, rms_eps=1e-6, tie_embeddings=True,
    max_seq_len=8192, sliding_window=4096, attn_logit_softcap=50.0,
    final_logit_softcap=30.0, query_pre_attn_scalar=256,
))
register(ModelConfig(
    name="gemma2:9b", family="gemma2", vocab_size=256_000, hidden_size=3584,
    intermediate_size=14_336, num_layers=42, num_heads=16, num_kv_heads=8,
    head_dim=256, rope_theta=10_000.0, rms_eps=1e-6, tie_embeddings=True,
    max_seq_len=8192, sliding_window=4096, attn_logit_softcap=50.0,
    final_logit_softcap=30.0, query_pre_attn_scalar=256,
))
register(ModelConfig(
    name="gemma2:27b", family="gemma2", vocab_size=256_000, hidden_size=4608,
    intermediate_size=36_864, num_layers=46, num_heads=32, num_kv_heads=16,
    head_dim=128, rope_theta=10_000.0, rms_eps=1e-6, tie_embeddings=True,
    max_seq_len=8192, sliding_window=4096, attn_logit_softcap=50.0,
    final_logit_softcap=30.0, query_pre_attn_scalar=144,
))

register(ModelConfig(
    name="mixtral:8x7b", family="mixtral", vocab_size=32_000,
    hidden_size=4096, intermediate_size=14_336, num_layers=32,
    num_heads=32, num_kv_heads=8, rope_theta=1_000_000.0,
    num_experts=8, experts_per_token=2, max_seq_len=32_768, rms_eps=1e-5,
))

# Tiny configs: architecture-faithful, test-sized.
register(ModelConfig(
    name="tiny-llama", vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    rope_theta=10_000.0, max_seq_len=256, tie_embeddings=False,
))
register(ModelConfig(
    name="tiny-mixtral", family="mixtral", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=10_000.0, max_seq_len=256,
    num_experts=4, experts_per_token=2,
))
register(ModelConfig(
    name="tiny-qwen2", family="qwen2", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=10_000.0, rms_eps=1e-6, max_seq_len=256,
    attn_bias=True,
))
register(ModelConfig(
    name="tiny-qwen3", family="qwen3", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=10_000.0, rms_eps=1e-6, max_seq_len=256,
    qk_norm=True,
))
register(ModelConfig(
    name="tiny-mistral", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=10_000.0, max_seq_len=256, sliding_window=8,
))
register(ModelConfig(
    name="tiny-gemma2", family="gemma2", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=10_000.0, rms_eps=1e-6, tie_embeddings=True,
    max_seq_len=256, sliding_window=8, attn_logit_softcap=50.0,
    final_logit_softcap=30.0, query_pre_attn_scalar=24,
))


def get_config(name: str) -> ModelConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    # Ollama-style tag normalization: suffixes live in the TAG, after the
    # colon — "llama3.2:3b-instruct-fp16" → "llama3.2:3b"
    if ":" in name:
        model, tag = name.split(":", 1)
        base = f"{model}:{tag.split('-')[0]}"
        if base in REGISTRY:
            return REGISTRY[base]
    raise KeyError(f"unknown model: {name!r} (known: {sorted(REGISTRY)})")


# HF model_type → the family this package serves (mistral is the llama
# skeleton with an optional sliding window)
_HF_FAMILY = {
    "llama": "llama",
    "mistral": "llama",
    "qwen2": "qwen2",
    "qwen3": "qwen3",
    "gemma2": "gemma2",
    "mixtral": "mixtral",
}
# HF model_types the JAX package serves and this one does not yet: the
# ROADMAP item that ports each
_HF_UNPORTED = {
    "bert": "ROADMAP A 8",
    "llava": "ROADMAP A 8",
}


def config_from_hf_dir(name: str, path: str) -> ModelConfig:
    """A ModelConfig from a local HF checkpoint's config.json, so any
    HF-layout directory of a served family can be served without a
    registry entry (the engine does so when `model` is not a registered
    name but a checkpoint_path is set)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    return _config_from_hf_dict(name, hf, path)


def _config_from_hf_dict(name: str, hf: dict, path: str) -> ModelConfig:
    mt = hf.get("model_type", "llama")
    if mt in _HF_UNPORTED:
        raise ValueError(
            f"HF model_type {mt!r} in {path}: its family is not ported to the torch "
            f"package yet ({_HF_UNPORTED[mt]})")
    if mt not in _HF_FAMILY:
        raise ValueError(f"unsupported HF model_type {mt!r} in {path} "
                         f"(supported: {sorted(_HF_FAMILY)})")
    family = _HF_FAMILY[mt]
    scaling = None
    rs = hf.get("rope_scaling") or None
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        scaling = RopeScaling(
            factor=rs["factor"],
            low_freq_factor=rs["low_freq_factor"],
            high_freq_factor=rs["high_freq_factor"],
            original_max_position_embeddings=rs["original_max_position_embeddings"],
        )
    return ModelConfig(
        name=name, family=family,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        rope_theta=hf.get("rope_theta", 10_000.0),
        rope_scaling=scaling,
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        # gemma2 checkpoints tie embeddings without always saying so
        tie_embeddings=hf.get("tie_word_embeddings", family == "gemma2"),
        max_seq_len=hf.get("max_position_embeddings", 8192),
        num_experts=hf.get("num_local_experts", 0),
        experts_per_token=hf.get("num_experts_per_tok", 2),
        # qwen2 configs carry sliding_window with use_sliding_window=false:
        # the family attends to the full context then
        sliding_window=((hf.get("sliding_window") or 0)
                        if hf.get("use_sliding_window", True) else 0),
        attn_bias=family == "qwen2" or bool(hf.get("attention_bias")),
        qk_norm=family == "qwen3",
        attn_logit_softcap=hf.get("attn_logit_softcapping") or 0.0,
        final_logit_softcap=hf.get("final_logit_softcapping") or 0.0,
        query_pre_attn_scalar=hf.get("query_pre_attn_scalar"),
    )
