"""ops.layers of the PyTorch port against the JAX package at float32:
RMSNorm, LayerNorm, rotary tables (with llama3 scaling) and rotation.
Same inputs from a numpy seed; tolerance 1e-6 (both compute in float32,
differing only in the last bits of rsqrt/pow/cos)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.ops import layers as TL
from gridllm_tpu.ops import layers as JL

TOL = dict(rtol=1e-6, atol=1e-6)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    w, b = rng.normal(size=(2, 32)).astype(np.float32)
    want = np.asarray(JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("head_dim,theta,scaled", [
    (16, 10_000.0, False),
    (128, 500_000.0, False),
    (128, 500_000.0, True),   # llama3.1 rope scaling
    (64, 500_000.0, True),    # llama3.2:1b
])
def test_rope_matches_jax(head_dim, theta, scaled):
    j_scale = JL.RopeScaling() if scaled else None
    t_scale = TL.RopeScaling() if scaled else None
    want_f = np.array(JL.precompute_rope(head_dim, theta, j_scale))
    got_f = TL.precompute_rope(head_dim, theta, t_scale)
    np.testing.assert_allclose(got_f.numpy(), want_f, **TOL)

    rng = np.random.default_rng(head_dim)
    x = rng.normal(size=(2, 7, 4, head_dim)).astype(np.float32)
    pos = rng.integers(0, 8192, size=(2, 7)).astype(np.int32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(want_f)))
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(want_f))
    # angles reach ~8e3 rad: the float32 cos/sin of the two libraries agree
    # to a few ulp of the angle, ~1e-5 absolute on unit-scale inputs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2e-5)
