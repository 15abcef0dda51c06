"""models.llama of the PyTorch port against the JAX package at float32.

The JAX parameters are carried across with `params_from_jax`; then
`forward`, `prefill` + `decode_step`, `prefill_chunk` and `mixed_step` must
give the JAX logits to rtol/atol 2e-4 (the tests/test_models.py
tolerance), on tiny-llama and on a 2-layer config with llama3:8b's head
layout (H=32, KVH=8, D=128) and narrow hidden/MLP/vocab widths. The
paged pools both packages end with must agree too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.models import configs as TCFG
from gridllm_torch.models import llama as TL
from gridllm_torch.ops.kvcache import PagedKVCache as TCache
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import llama as JL
from gridllm_tpu.ops.kvcache import PagedKVCache as JCache

TOL = dict(rtol=2e-4, atol=2e-4)
# llama3:8b attention head layout at narrow widths
LLAMA3_HEADS = dict(name="llama3-heads-2l", vocab_size=512, hidden_size=256,
                    intermediate_size=512, num_layers=2, num_heads=32, num_kv_heads=8,
                    head_dim=128, rope_theta=500_000.0, max_seq_len=8192)


def _configs(name):
    if name == "tiny-llama":
        return JCFG.get_config(name), TCFG.get_config(name)
    return JCFG.ModelConfig(**LLAMA3_HEADS), TCFG.ModelConfig(**LLAMA3_HEADS)


@pytest.fixture(scope="module", params=["tiny-llama", "llama3-heads-2l"])
def models(request):
    jcfg, tcfg = _configs(request.param)
    params = JL.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = TL.Llama(tcfg, dtype=torch.float32, device="cpu").params_from_jax(np_params)
    return jcfg, params, model


def test_forward_matches_jax(models):
    jcfg, params, model = models
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = np.asarray(JL.forward(params, jcfg, jnp.asarray(tokens)))
    got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_entry_points_match_jax(models):
    """One scenario through every paged entry point: slot 0 prefills a
    bucket, slot 2 prefills in two page-aligned chunks, three decode steps
    for both, then a mixed step admits slot 1's chunk while 0 and 2
    decode."""
    jcfg, params, model = models
    L, P, ps, S, maxp = jcfg.num_layers, 16, 8, 3, 6
    kvh, d = jcfg.num_kv_heads, jcfg.head_dim_
    jc = JCache.create(L, P, ps, kvh, d, S, maxp, dtype=jnp.float32)
    tc = TCache.create(L, P, ps, kvh, d, S, maxp, dtype=torch.float32, device="cpu")
    rows = np.full((S, maxp), -1, np.int32)
    rows[0, :3], rows[1, :2], rows[2, :3] = [4, 9, 1], [12, 0], [7, 3, 15]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=40).astype(np.int32)

    def close(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    # slot 0: bucket prefill, 11 tokens padded to 16
    padded = np.concatenate([toks[:11], np.zeros(5, np.int32)])
    jl, jc = JL.prefill(params, jcfg, jnp.asarray(padded), jnp.int32(11), jc, jnp.int32(0),
                        jnp.asarray(rows[0]))
    tl, tc = model.prefill(torch.from_numpy(padded), 11, tc, 0, torch.from_numpy(rows[0]))
    close(jl, tl)
    # slot 2: two chunks of 8 (the second ragged: 5 valid)
    for start, n in ((0, 8), (8, 5)):
        chunk = np.zeros(8, np.int32)
        chunk[:n] = toks[11 + start:11 + start + n]
        jl, jc = JL.prefill_chunk(params, jcfg, jnp.asarray(chunk), jnp.int32(start),
                                  jnp.int32(n), jc, jnp.int32(2), jnp.asarray(rows[2]))
        tl, tc = model.prefill_chunk(torch.from_numpy(chunk), start, n, tc, 2,
                                     torch.from_numpy(rows[2]))
        close(jl, tl)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))

    active = np.asarray([True, False, True])
    cur = np.zeros(S, np.int32)
    for _ in range(3):
        jl, jc = JL.decode_step(params, jcfg, jnp.asarray(cur), jc, jnp.asarray(active))
        tl, tc = model.decode_step(torch.from_numpy(cur), tc, torch.from_numpy(active))
        close(jl, tl)
        cur = np.array(jnp.argmax(jl, axis=-1), np.int32)

    chunk = np.zeros(8, np.int32)
    chunk[:6] = toks[30:36]
    jcl, jdl, jc = JL.mixed_step(params, jcfg, jnp.asarray(chunk), jnp.int32(0), jnp.int32(6),
                                 jnp.int32(1), jnp.asarray(rows[1]), jnp.asarray(cur), jc,
                                 jnp.asarray(active))
    tcl, tdl, tc = model.mixed_step(torch.from_numpy(chunk), 0, 6, 1,
                                    torch.from_numpy(rows[1]), torch.from_numpy(cur), tc,
                                    torch.from_numpy(active))
    close(jcl, tcl)
    close(jdl[active], tdl[torch.from_numpy(active)])
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
    # every written pool row agrees (both packages drop the same rows)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_configs_match_jax():
    for name, t in TCFG.REGISTRY.items():
        j = JCFG.get_config(name)
        got = dataclasses.asdict(t)
        got["rope_scaling"] = got["rope_scaling"] and tuple(got["rope_scaling"].values())
        for field, value in got.items():
            want = getattr(j, field)
            if field == "rope_scaling":
                want = want and dataclasses.astuple(want)
            assert value == want, (name, field)
        assert t.head_dim_ == j.head_dim_
    assert TCFG.get_config("llama3:8b-instruct-q4") is TCFG.REGISTRY["llama3:8b"]


def test_init_params_scales():
    """Random init draws on the module's device with the JAX scales."""
    cfg = TCFG.get_config("tiny-llama")
    gen = torch.Generator().manual_seed(0)
    m = TL.Llama(cfg, dtype=torch.float32, device="cpu").init_params(gen)
    assert torch.all(m.layers["attn_norm"] == 1) and torch.all(m.final_norm == 1)
    assert abs(float(m.embed.std()) - 0.02) < 2e-3
    assert abs(float(m.layers["wq"].std()) - cfg.hidden_size ** -0.5) < 0.02


# ---------------------------------------------------------------------------
# the model branches the ragged chunk path must keep right
# ---------------------------------------------------------------------------

BRANCH_MODELS = ("tiny-qwen2", "tiny-qwen3", "tiny-mistral")


def moved_params(name: str, seed: int = 3):
    """(JAX config, JAX params, numpy params) of `name` at float32, with
    every norm weight, q/k/v bias and q/k-norm weight moved off its init
    value, so a branch that ignores one of them shows in the logits."""
    jcfg = JCFG.get_config(name)
    np_params = jax.tree_util.tree_map(
        np.array, JL.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    layers = np_params["layers"]
    for key in ("attn_norm", "mlp_norm", "q_norm", "k_norm", "bq", "bk", "bv"):
        if key in layers:
            layers[key] = (layers[key] + rng.normal(scale=0.3, size=layers[key].shape)
                           ).astype(np.float32)
    np_params["final_norm"] = (np_params["final_norm"] + rng.normal(
        scale=0.3, size=np_params["final_norm"].shape)).astype(np.float32)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, np_params), np_params


@pytest.mark.parametrize("name", BRANCH_MODELS)
def test_model_branches_forward_and_decode_match_jax(name):
    """tiny-qwen2 (q/k/v bias), tiny-qwen3 (q/k norm) and tiny-mistral
    (sliding window of 8): the cache-free forward, then a 20-token bucket
    prefill and 12 greedy decode steps through the ragged group region,
    logits against the JAX package's at every step."""
    jcfg, params, np_params = moved_params(name)
    tcfg = TCFG.get_config(name)
    assert (tcfg.attn_bias, tcfg.qk_norm, tcfg.sliding_window) == (
        jcfg.attn_bias, jcfg.qk_norm, jcfg.sliding_window)
    model = TL.Llama(tcfg, dtype=torch.float32, device="cpu").params_from_jax(np_params)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 20)).astype(np.int32)
    want = np.asarray(JL.forward(params, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(model(torch.from_numpy(tokens)).numpy(), want, **TOL)

    L, P, ps, S, maxp = jcfg.num_layers, 16, 8, 2, 6
    kvh, d = jcfg.num_kv_heads, jcfg.head_dim_
    jc = JCache.create(L, P, ps, kvh, d, S, maxp, dtype=jnp.float32)
    tc = TCache.create(L, P, ps, kvh, d, S, maxp, dtype=torch.float32, device="cpu")
    row = np.full(maxp, -1, np.int32)
    row[:5] = [6, 2, 11, 0, 9]
    padded = np.concatenate([tokens[0], np.zeros(12, np.int32)])   # the 32 bucket
    jl, jc = JL.prefill(params, jcfg, jnp.asarray(padded), jnp.int32(20), jc, jnp.int32(0),
                        jnp.asarray(row))
    tl, tc = model.prefill(torch.from_numpy(padded), 20, tc, 0, torch.from_numpy(row))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    active = np.asarray([True, False])
    cur = np.zeros(S, np.int32)
    cur[0] = int(np.argmax(np.asarray(jl)))
    for _ in range(12):
        jl, jc = JL.decode_step(params, jcfg, jnp.asarray(cur), jc, jnp.asarray(active))
        tl, tc = model.decode_step(torch.from_numpy(cur), tc, torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **TOL)
        cur = np.array(jnp.argmax(jl, axis=-1), np.int32)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
