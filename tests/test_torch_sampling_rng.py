"""The port's sampler noise against the JAX package's threefry stream (JAX
0.9.0, `jax_threefry_partitionable=True`), on the CPU.

- `prng_key`, `fold_in`, `random_bits` and the bits-to-float uniform equal
  `jax.random`'s bit for bit over a grid of (seed, step) with negative,
  zero and extreme int32 seeds; the sampler's key chains (`step_key`,
  `_spec_keys`, `_spec_tree_keys`) equal the JAX package's;
- `gumbel` within 2 ulp of `jax.random.gumbel` (-log(-log(u)): each
  `log` may round its last bit differently; the ulp counts both logs'
  roundings, `_gumbel_ulps`);
- seeded sampled tiny-llama streams equal across the two packages with
  speculation off, with n-gram speculation and with a draft-model tree;
- a seeded sampled job (speculation off) killed mid-decode on a JAX
  worker resumes on a torch worker, and the other way, byte-identically
  with the undisturbed run.

Near-ties: a token can differ only where two perturbed logits (scaled
logit + Gumbel noise) of one draw lie within the packages' float32
differences (about 1e-6 here), or where a top-p cumulative sum lies that
close to top_p. The streams below are fixed by their seeds and meet no
such tie; another seed could.
"""

import asyncio
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.ops import sampling as TS
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.ops import sampling as JS
from gridllm_tpu.utils.types import InferenceRequest
from tests.test_torch_worker import LONG, MODEL, TINY, KillFleet

SEEDS = np.array([0, 1, 2, 7, -1, -2, -7, 12345, -54321, 2**31 - 1, -2**31, 987654321,
                  0x7FFFFFFF & 0xDEADBEEF], np.int32)
STEPS = np.array([0, 1, 2, 3, 15, 64, 255, 1000, 2**20, 2**31 - 1], np.int32)
TOPK = 128
SAMPLED = {"temperature": 0.9, "top_k": 40, "top_p": 0.95, "seed": 1234,
           "num_predict": 24}


def _grid():
    s, t = np.meshgrid(SEEDS, STEPS, indexing="ij")
    return s.ravel(), t.ravel()


def _jax_draws(seeds, steps):
    def one(sd, st):
        key = jax.random.fold_in(jax.random.PRNGKey(sd), st)
        return (jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                else key,
                jax.random.bits(key, (TOPK,), jnp.uint32),
                jax.random.uniform(key, (TOPK,), jnp.float32),
                jax.random.uniform(key, (), jnp.float32),
                jax.random.gumbel(key, (TOPK,), jnp.float32))
    return [np.asarray(a) for a in jax.vmap(one)(jnp.asarray(seeds), jnp.asarray(steps))]


def _gumbel_ulps(got, want):
    """|got - want| of two float32 Gumbel draws -log(x), x = -log(u), in
    units of the rounding the two logs allow: 1 ulp of the result plus 1
    ulp of x carried through the outer log (ulp(x) / x). The outer log
    amplifies the inner one's last bit where x is near 1 (g near 0), so
    the plain ulp of g would count one rounding as thousands of ulps."""
    want = want.astype(np.float64)
    x = np.exp(-want)
    unit = (np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
            + np.spacing(x.astype(np.float32)).astype(np.float64) / x)
    return np.abs(got.astype(np.float64) - want) / unit


def test_installed_jax_draws_the_partitionable_stream():
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_high_dynamic_range_gumbel


def test_threefry_bits_and_uniforms_equal_jax():
    seeds, steps = _grid()
    keys, bits, unif, unif0, gum = _jax_draws(seeds, steps)
    key = TS.step_key(torch.from_numpy(seeds), torch.from_numpy(steps))
    got_keys = np.stack([key[0].numpy(), key[1].numpy()], axis=1).astype(np.uint32)
    np.testing.assert_array_equal(got_keys, keys)
    np.testing.assert_array_equal(TS.random_bits(key, TOPK).numpy().astype(np.uint32), bits)
    np.testing.assert_array_equal(TS.uniform(key, TOPK).numpy(), unif)
    np.testing.assert_array_equal(TS.uniform(key).numpy(), unif0)
    g = TS.gumbel(key, TOPK).numpy()
    assert g.dtype == np.float32
    assert _gumbel_ulps(g, gum).max() <= 2.0
    np.testing.assert_array_equal(TS.slot_gumbel(torch.from_numpy(seeds),
                                                 torch.from_numpy(steps), TOPK).numpy(), g)


def test_prng_key_of_negative_and_extreme_seeds():
    for sd in (-1, -2**31, 2**31 - 1, 0, 5):
        want = np.asarray(jax.random.key_data(jax.random.PRNGKey(np.int32(sd)))
                          if jnp.issubdtype(jax.random.PRNGKey(0).dtype, jax.dtypes.prng_key)
                          else jax.random.PRNGKey(np.int32(sd)))
        k0, k1 = TS.prng_key(torch.tensor([sd], dtype=torch.int32))
        assert [int(k0), int(k1)] == [int(w) for w in want]


def test_bits_to_uniform_edges_equal_jax():
    """The float conversion at the edges of the 32-bit range, in both of
    the sampler's uniforms (on [0, 1) and gumbel's on [tiny, 1))."""
    edge = np.array([0, 1, 511, 512, 2**31, 2**32 - 512, 2**32 - 1], np.uint32)
    tiny = np.finfo(np.float32).tiny
    for lo in (0.0, tiny):
        want = np.asarray(jax.jit(lambda b, lo=lo: jnp.maximum(
            jnp.float32(lo),
            (jax.lax.bitcast_convert_type((b >> 9) | jnp.uint32(0x3F800000), jnp.float32)
             - 1.0) * (jnp.float32(1.0) - jnp.float32(lo)) + jnp.float32(lo)))(edge))
        got = TS.bits_to_uniform(torch.from_numpy(edge.astype(np.int64)), lo, 1.0).numpy()
        np.testing.assert_array_equal(got, want)


def test_spec_key_chains_equal_jax():
    """The spec path's draws: the accept uniform under fold_in(key, 1) and
    the fallback Gumbel under fold_in(key, 2); the tree walk's uniforms
    under fold_in(key, 3 + round)."""
    seeds, steps = _grid()
    ju, jg = jax.vmap(lambda a, b: JS._spec_keys(a, b, TOPK))(jnp.asarray(seeds),
                                                              jnp.asarray(steps))
    tu, tg = TS._spec_keys(torch.from_numpy(seeds), torch.from_numpy(steps), TOPK)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert _gumbel_ulps(tg.numpy(), np.asarray(jg)).max() <= 2.0
    ju, jg = jax.vmap(lambda a, b: JS._spec_tree_keys(a, b, TOPK, 6))(jnp.asarray(seeds),
                                                                      jnp.asarray(steps))
    tu, tg = TS._spec_tree_keys(torch.from_numpy(seeds), torch.from_numpy(steps), TOPK, 6)
    assert tu.shape == (len(seeds), 6)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert _gumbel_ulps(tg.numpy(), np.asarray(jg)).max() <= 2.0


def test_greedy_sampler_skips_noise_with_the_same_tokens():
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((4, 300), generator=gen)
    sp = TS.SamplingParams.defaults(4, "cpu")
    sp.temperature.zero_()
    np.testing.assert_array_equal(TS.sample_tokens(logits, sp).numpy(),
                                  TS.sample_tokens(logits, sp, noise=False).numpy())


def _run(engine, req_cls, prompts, opts):
    res = {}

    def cb(i):
        def f(_d, done, r):
            if done:
                res[i] = r
        return f

    for i, p in enumerate(prompts):
        engine.submit(req_cls(id=f"r{i}", prompt=p, options=dict(opts), on_chunk=cb(i)))
    for _ in range(10_000):
        if len(res) == len(prompts):
            break
        engine.step()
    return [res[i] for i in range(len(prompts))]


PROMPTS = ["once upon a time", "ab ab ab ab ab ab", "the quick brown fox jumps over it all"]


@pytest.mark.parametrize("spec", ["off", "ngram", "tree"])
def test_seeded_sampled_streams_equal_across_packages(spec, monkeypatch):
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", "1")
    cfg = dict(TINY, spec_decode=spec != "off", spec_k=4)
    if spec == "tree":
        cfg["draft_model"] = MODEL
    je = JEngine(JConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    dparams = (jax.tree_util.tree_map(np.asarray, je._drafter.params)
               if spec == "tree" else None)
    te = TEngine(TConfig(**cfg), device="cpu", params=params, draft_params=dparams)
    for opts in (SAMPLED, dict(SAMPLED, seed=-77, temperature=1.3, repeat_penalty=1.3)):
        want = _run(je, JRequest, PROMPTS, opts)
        got = _run(te, TRequest, PROMPTS, opts)
        for w, g in zip(want, got):
            assert g.token_ids == w.token_ids
            assert g.text == w.text
            assert (g.spec_proposed, g.spec_accepted) == (w.spec_proposed, w.spec_accepted)
        # sampled, not greedy: the seeds give streams of their own
        assert len({tuple(g.token_ids) for g in got}) == len(PROMPTS)
    if spec != "off":
        assert te.spec_stats["proposed"] > 0


async def _sampled_run(fleet, chaos=None):
    chunks = []

    async def on_chunk(c):
        chunks.append(c.response)

    req = InferenceRequest(
        id=f"seeded-{uuid.uuid4().hex[:8]}", model=MODEL, prompt=LONG, stream=True,
        options=dict(SAMPLED, top_k=20, num_predict=48), metadata={"requestType": "inference"})
    task = asyncio.create_task(fleet.scheduler.submit_streaming_job(
        req, on_chunk, timeout_ms=120_000))
    if chaos is not None:
        for _ in range(9000):
            snap = fleet.scheduler._resume_snap.get(req.id)
            if snap is not None and len(snap["tokens"]) >= 4:
                break
            await asyncio.sleep(0.01)
        else:
            raise AssertionError("decode never reached the chaos point")
        await chaos()
    result = await task
    text = "".join(chunks)
    assert result.success, result.error
    assert text == result.response.response
    return text, int(result.response.eval_count), result.workerId


@pytest.fixture(scope="module")
def fleet_engines():
    """A JAX and a torch engine on the same weights, their lm_head columns
    past the ASCII bytes zeroed: a sampled byte stream of invalid UTF-8
    decodes differently as it grows (a split sequence's U+FFFD), so the
    streamed text of a resumed job could not equal its final text, in
    either package. With top_k = 20 every kept token is then one of the
    ~64 ASCII ids with a positive logit. Speculation is off: its
    rejection-sampling draws are not replayed by a resume's direct draws,
    in either package (tests/test_fault_tolerance.py's seeded sampled
    kill turns it off too)."""
    cfg = dict(TINY, spec_decode=False)
    je = JEngine(JConfig(**cfg))
    params = jax.tree_util.tree_map(np.array, je.params)
    params["lm_head"][:, 128:] = 0.0
    je.params = jax.tree_util.tree_map(jnp.asarray, params)
    return je, TEngine(TConfig(**cfg), device="cpu", params=params)


@pytest.mark.parametrize("victim,survivor", [("jax", "torch"), ("torch", "jax")])
async def test_seeded_sampled_kill_resumes_byte_identical(fleet_engines, victim, survivor):
    """A seeded sampled job killed mid-decode on one package's worker
    resumes on the other's: the client's stream equals the undisturbed
    run's byte for byte, with the same eval_count."""
    engines = dict(zip(("jax", "torch"), fleet_engines))
    async with KillFleet() as f:
        await f.add("jax", engines["jax"], "ref-w")
        ref_text, ref_evals, _ = await _sampled_run(f)
    assert ref_evals > 8 and ref_text   # the slot's capacity ends it before 48
    async with KillFleet() as f:
        dead = await f.add(victim, engines[victim], "victim")

        async def kill():
            # silenced before the survivor joins: the victim decodes on
            # while the survivor registers and could finish the job first
            dead.bus.dead = True
            await f.add(survivor, engines[survivor], "survivor")

        text, evals, served_by = await _sampled_run(f, chaos=kill)
        assert served_by == "survivor"
        assert (text, evals) == (ref_text, ref_evals)
        assert int(f.scheduler._resume_total.value(event="stamped")) >= 1
