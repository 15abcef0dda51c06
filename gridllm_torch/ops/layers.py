"""Core transformer primitives: RMSNorm, LayerNorm and rotary embeddings.

Same conventions as the JAX package's ``ops/layers.py`` (HF Llama: split-
half rotation, norms computed in float32 and cast back), so both packages
compute the same numbers from the same weights.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3-style NTK rope rescaling (HF `rope_scaling` dict)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


def precompute_rope(
    head_dim: int,
    theta: float = 10000.0,
    scaling: RopeScaling | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Inverse frequencies [head_dim//2], float32, with optional llama3
    scaling."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if scaling is not None:
        orig = scaling.original_max_position_embeddings
        low_wavelen = orig / scaling.low_freq_factor
        high_wavelen = orig / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        # smooth interpolation between scaled and unscaled bands
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        smooth = smooth.clamp(0.0, 1.0)
        scaled = inv_freq / scaling.factor
        inv_freq = torch.where(
            wavelen > low_wavelen,
            scaled,
            torch.where(wavelen < high_wavelen, inv_freq,
                        (1.0 - smooth) * scaled + smooth * inv_freq),
        )
    return inv_freq


def rope_tables(positions: torch.Tensor, inv_freq: torch.Tensor):
    """(cos, sin) [..., T, 1, D/2] for integer positions [..., T] — computed
    once per step and shared by every layer's rotation."""
    angles = positions[..., :, None].float() * inv_freq  # [..., T, D/2]
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate `x` [..., T, H, D] by precomputed tables, in float32 (HF
    split-half convention: the first D/2 lanes pair with the last D/2)."""
    dtype = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
) -> torch.Tensor:
    """Rotate `x` [..., T, H, D] by position-dependent angles.
    `positions`: [..., T] integer absolute positions."""
    return rotate(x, *rope_tables(positions, inv_freq))


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """Classic LayerNorm (mean-centered, affine with bias) in float32."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)
