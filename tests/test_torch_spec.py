"""Speculative decoding in the PyTorch port against the JAX package on CPU.

- NgramDrafter: the cases of tests/test_spec_decode.py, and random
  histories drafted identically by both packages;
- write_multi_all and rollback_to_length: pools and lengths equal to the
  JAX package's exactly (flattened rows, inactive slot, past-capacity
  drops, a rollback across a page boundary, refcount-shared pages never
  touched);
- spec_accept in greedy mode: emitted tokens, counts, repeat-penalty
  window and noise counter equal to the JAX function's;
- tiny-llama `verify_step` logits and pools against the JAX model's, with
  ragged attention on and off (GRIDLLM_RAGGED_ATTN on the JAX side);
- the engine with spec decode on (the default, K = 4) against the JAX
  engine built with its resolved defaults, in both attention modes: the
  scenarios of tests/test_spec_decode.py (repetitive prompt with real
  acceptance, repeat penalty, concurrent batch, a stop sequence inside an
  accepted span, exact num_predict), plus a prompt longer than one chunk
  and its warm prefix-cache repeat. Greedy streams and speculation counts
  must be identical. Seeded sampled streams are checked for determinism
  here; their equality with the JAX package's is in
  tests/test_torch_sampling_rng.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.models import configs as TCFG
from gridllm_torch.models import llama as TL
from gridllm_torch.ops import kvcache as TC
from gridllm_torch.ops import sampling as TS
from gridllm_torch.ops.spec import NgramDrafter, make_drafter
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.models import configs as JCFG
from gridllm_tpu.models import llama as JL
from gridllm_tpu.ops import kvcache as JC
from gridllm_tpu.ops import sampling as JS
from gridllm_tpu.ops.spec import NgramDrafter as JNgramDrafter

TINY = dict(model="tiny-llama", max_slots=4, page_size=8, num_pages=64,
            max_pages_per_slot=8, prefill_buckets=(16, 32), prefill_chunk=16,
            dtype="float32")
# repetitive prompt + penalty off: greedy output settles into a cycle the
# n-gram drafter can extend, so the parity tests exercise real acceptance
REP_PROMPT = "ab ab ab ab ab ab"
REP_OPTS = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 24}
LONG = "ab ab ab ab ab ab ab ab ab ab"   # 30 tokens > prefill_chunk
MODES = ["ragged", "per_phase"]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# drafter
# ---------------------------------------------------------------------------


def test_drafter_matches_most_recent_occurrence():
    assert NgramDrafter(max_n=3, min_n=1).draft([1, 2, 3, 9, 1, 2, 3, 5, 1, 2, 3], 4) == \
        [5, 1, 2, 3]


def test_drafter_prefers_longest_suffix():
    assert NgramDrafter(max_n=3, min_n=1).draft([7, 8, 9, 8, 1, 7, 8], 2) == [9, 8]


def test_drafter_no_match_and_bounds():
    d = NgramDrafter(max_n=3, min_n=1)
    assert d.draft([1, 2, 3, 4], 4) == []
    assert d.draft([5], 4) == []
    assert d.draft([1, 2, 1, 2], 0) == []
    assert d.draft([1, 2, 1], 2) == [2, 1]


def test_drafter_lookback_bounds_scan():
    far = [1, 2, 3] + [9] * 50 + [1, 2]
    assert NgramDrafter(max_n=2, min_n=2).draft(far, 1) == [3]
    assert NgramDrafter(max_n=2, min_n=2, lookback=10).draft(far, 1) == []


def test_drafter_factory():
    d = make_drafter()
    assert isinstance(d, NgramDrafter) and d.kind == "ngram"
    assert (d.max_n, d.min_n, d.lookback) == (4, 1, 0)   # the reference's defaults
    with pytest.raises(ValueError):
        make_drafter("nope")
    with pytest.raises(ValueError):
        NgramDrafter(max_n=1, min_n=2)


@pytest.mark.parametrize("seed", range(4))
def test_drafter_matches_jax_on_random_histories(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        ids = [int(x) for x in rng.integers(0, 4, size=int(rng.integers(1, 40)))]
        k, max_n = int(rng.integers(0, 6)), int(rng.integers(1, 5))
        lookback = int(rng.integers(0, 3)) * 8
        want = JNgramDrafter(max_n=max_n, lookback=lookback).draft(ids, k)
        assert NgramDrafter(max_n=max_n, lookback=lookback).draft(ids, k) == want


# ---------------------------------------------------------------------------
# multi-token KV write and rollback
# ---------------------------------------------------------------------------


def _caches(num_pages=8, ps=4, slots=2, max_pages=4, kvh=2, d=4):
    return (JC.PagedKVCache.create(1, num_pages, ps, kvh, d, slots, max_pages,
                                   dtype=jnp.float32),
            TC.PagedKVCache.create(1, num_pages, ps, kvh, d, slots, max_pages,
                                   dtype=torch.float32, device="cpu"))


def _rows(t, seed, s=2, kvh=2, d=4):
    return np.random.RandomState(seed).randn(1, s, t, kvh, d).astype(np.float32)


def _write_both(jc, tc, k_new, v_new, table, positions, active):
    jk, jv = JC.write_multi_all(jc.k, jc.v, jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(table), jnp.asarray(positions),
                                jnp.asarray(active), jc.page_size)
    TC.write_multi_all(tc.k, tc.v, _t(k_new), _t(v_new), _t(table), _t(positions),
                       _t(active), tc.page_size)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jv))
    return JC.PagedKVCache(k=jk, v=jv, page_table=jc.page_table, lengths=jc.lengths,
                           page_size=jc.page_size)


@pytest.mark.parametrize("case", ["page_crossing", "inactive_and_past_capacity"])
def test_write_multi_matches_jax(case):
    jc, tc = _caches()
    if case == "page_crossing":
        table = np.asarray([[0, 1, 2, -1], [3, 4, -1, -1]], np.int32)
        positions = np.asarray([2, 5], np.int32)[:, None] + np.arange(3, dtype=np.int32)
        active = np.asarray([True, True])
    else:  # slot 0 inactive; slot 1 owns two pages, positions 8 and 9 drop
        table = np.asarray([[0, 1, 2, 3], [4, 5, -1, -1]], np.int32)
        positions = np.asarray([[0, 1, 2, 3], [6, 7, 8, 9]], np.int32)
        active = np.asarray([False, True])
    t = positions.shape[1]
    _write_both(jc, tc, _rows(t, 1), _rows(t, 2), table, positions, active)
    if case != "page_crossing":
        assert not tc.k[0, :4].any()          # the inactive slot's pages untouched
        assert tc.k[0, 5, 2:].any()           # positions 6, 7 written


def test_rollback_across_page_boundary_matches_jax():
    """Optimistic K+1 write across a page boundary, rollback to the
    accepted length, then the true continuation overwrites the junk rows:
    pools and lengths equal to the JAX package's at every step."""
    jc, tc = _caches()
    table = np.asarray([[0, 1, 2, -1], [-1, -1, -1, -1]], np.int32)
    active = np.asarray([True, False])
    base = np.asarray([2, 0], np.int32)
    jc = JC.PagedKVCache(k=jc.k, v=jc.v, page_table=jnp.asarray(table),
                         lengths=jnp.asarray(base), page_size=jc.page_size)
    tc.page_table.copy_(_t(table))
    tc.lengths.copy_(_t(base))
    positions = base[:, None] + np.arange(5, dtype=np.int32)
    jc = _write_both(jc, tc, _rows(5, 10), _rows(5, 10), table, positions, active)
    accepted = np.asarray([base[0] + 2, 0], np.int32)
    jc = JC.rollback_to_length(jc, jnp.asarray(accepted))
    assert TC.rollback_to_length(tc, _t(accepted)) is tc
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    cont = accepted[:, None] + np.arange(3, dtype=np.int32)
    _write_both(jc, tc, _rows(3, 20), _rows(3, 20), table, cont, active)


def test_rollback_never_touches_refcount_shared_pages():
    """A warm slot sharing prefix-cache pages: the verify write and the
    rollback live past the prompt, so the shared pages' bytes stay as they
    were."""
    ps = 4
    alloc = TC.PageAllocator(8, ps, 4, cache_pages=-1)
    prompt = list(range(10))            # 2 full pages (8 tokens) registrable
    alloc.alloc(0, len(prompt) + 2)
    alloc.free(0, prompt)
    assert alloc.match_prefix(1, prompt) == 8
    row = alloc.table_row(1)
    shared = row[:2]
    alloc.alloc(1, len(prompt) + 2)
    _, tc = _caches()
    tc.k[:, shared[0]] = 7.5
    tc.k[:, shared[1]] = 15.0
    tc.page_table.copy_(torch.tensor([row, [-1] * 4], dtype=torch.int32))
    tc.lengths.copy_(torch.tensor([len(prompt), 0], dtype=torch.int32))
    before = tc.k[:, shared].clone()
    positions = tc.lengths[:, None] + torch.arange(3, dtype=torch.int32)
    TC.write_multi_all(tc.k, tc.v, _t(_rows(3, 30)), _t(_rows(3, 31)), tc.page_table,
                       positions, torch.tensor([True, False]), ps)
    TC.rollback_to_length(tc, torch.tensor([len(prompt) + 1, 0], dtype=torch.int32))
    assert torch.equal(tc.k[:, shared], before)
    assert tc.lengths.tolist() == [len(prompt) + 1, 0]


# ---------------------------------------------------------------------------
# accept / reject
# ---------------------------------------------------------------------------


def _sampler_state(rng, s, vocab, w=8):
    window = rng.integers(0, vocab, size=(s, w)).astype(np.int32)
    wlen = np.asarray([w, 3, 0, 5][:s], np.int32)
    counts = np.zeros((s, vocab), np.int32)
    for i in range(s):
        for tok in window[i, w - wlen[i]:]:
            counts[i, tok] += 1
    return window, wlen, counts


def test_spec_accept_greedy_matches_jax():
    rng = np.random.default_rng(0)
    s, k1, vocab = 4, 5, 64
    logits = rng.normal(size=(s, k1, vocab)).astype(np.float32) * 3
    # drafts that follow the raw argmax for a while, then diverge, so the
    # slots accept 0..4 of them
    cand = rng.integers(0, vocab, size=(s, k1)).astype(np.int32)
    greedy = logits.argmax(-1)
    for i, n_ok in enumerate((4, 2, 0, 3)):
        cand[i, 1:1 + n_ok] = greedy[i, :n_ok]
    dlen = np.asarray([4, 3, 0, 4], np.int32)
    active = np.asarray([True, True, True, False])
    window, wlen, counts = _sampler_state(rng, s, vocab)
    penalty = np.asarray([1.0, 1.1, 1.3, 1.0], np.float32)
    common = dict(temperature=np.zeros(s, np.float32), top_k=np.full(s, 40, np.int32),
                  top_p=np.full(s, 0.9, np.float32), min_p=np.zeros(s, np.float32),
                  repeat_penalty=penalty, repeat_last_n=np.asarray([8, 8, 4, 8], np.int32),
                  seed=np.arange(s, dtype=np.int32), step=np.asarray([0, 3, 7, 1], np.int32))
    jsp = JS.SamplingParams(**{k: jnp.asarray(v) for k, v in common.items()})
    out, n_emit, last, jcounts, jwin, jwlen, jsp = JS.spec_accept(
        jnp.asarray(logits), jnp.asarray(cand), jnp.asarray(dlen), jsp, jnp.asarray(counts),
        jnp.asarray(window), jnp.asarray(wlen), jnp.asarray(active), vocab)
    tsp = TS.SamplingParams(**{k: _t(v) for k, v in common.items()})
    tcounts, twin, twlen = _t(counts), _t(window), _t(wlen)
    t_out, t_n, t_last = TS.spec_accept(_t(logits), _t(cand), _t(dlen), tsp, tcounts, twin,
                                        twlen, _t(active), vocab)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(out))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(n_emit))
    np.testing.assert_array_equal(t_last.numpy(), np.asarray(last))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(twlen.numpy(), np.asarray(jwlen))
    np.testing.assert_array_equal(tsp.step.numpy(), np.asarray(jsp.step))
    assert t_n.tolist()[3] == 0 and max(t_n.tolist()) > 1   # real acceptance


def test_spec_accept_sampled_is_seeded():
    rng = np.random.default_rng(1)
    s, k1, vocab = 3, 5, 64
    logits = _t(rng.normal(size=(s, k1, vocab)).astype(np.float32))
    cand = _t(rng.integers(0, vocab, size=(s, k1)).astype(np.int32))
    runs = []
    for _ in range(2):
        sp = TS.SamplingParams.defaults(s, "cpu")
        sp.seed.copy_(torch.tensor([5, 6, 7], dtype=torch.int32))
        window, wlen, counts = (_t(a) for a in _sampler_state(np.random.default_rng(2), s,
                                                                vocab))
        out, n, _ = TS.spec_accept(logits, cand, torch.full((s,), 4, dtype=torch.int32), sp,
                                   counts, window, wlen, torch.ones(s, dtype=torch.bool), vocab)
        runs.append((out.tolist(), n.tolist(), sp.step.tolist()))
    assert runs[0] == runs[1]
    assert runs[0][2] == runs[0][1]          # the noise counter advanced by n_emit


# ---------------------------------------------------------------------------
# the model's verify step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_verify_step_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("GRIDLLM_RAGGED_ATTN", "1" if mode == "ragged" else "0")
    jcfg, tcfg = JCFG.get_config("tiny-llama"), TCFG.get_config("tiny-llama")
    params = JL.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = TL.Llama(tcfg, dtype=torch.float32, device="cpu",
                     ragged_attention=mode == "ragged").params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    L, P, ps, S, maxp = jcfg.num_layers, 16, 8, 3, 6
    kvh, d = jcfg.num_kv_heads, jcfg.head_dim_
    jc = JC.PagedKVCache.create(L, P, ps, kvh, d, S, maxp, dtype=jnp.float32)
    tc = TC.PagedKVCache.create(L, P, ps, kvh, d, S, maxp, dtype=torch.float32, device="cpu")
    rows = np.full((S, maxp), -1, np.int32)
    rows[0, :3], rows[2, :4] = [4, 9, 1], [7, 3, 15, 0]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=32).astype(np.int32)
    for slot, n in ((0, 11), (2, 14)):           # prompts straddling a page
        padded = np.concatenate([toks[:n], np.zeros(16 - n, np.int32)])
        _, jc = JL.prefill(params, jcfg, jnp.asarray(padded), jnp.int32(n), jc,
                           jnp.int32(slot), jnp.asarray(rows[slot]))
        model.prefill(_t(padded), n, tc, slot, _t(rows[slot]))
    active = np.asarray([True, False, True])
    for step in range(2):
        cand = rng.integers(0, jcfg.vocab_size, size=(S, 5)).astype(np.int32)
        jl, jc = JL.verify_step(params, jcfg, jnp.asarray(cand), jc, jnp.asarray(active))
        tl, tc = model.verify_step(_t(cand), tc, _t(active))
        assert tl.shape == (S, 5, jcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=2e-4, atol=2e-4)
        accepted = np.asarray([2 + step, 0, 5]) * active   # commit part of the span
        jc = JC.rollback_to_length(jc, jc.lengths + jnp.asarray(accepted, jnp.int32))
        TC.rollback_to_length(tc, tc.lengths + _t(accepted.astype(np.int32)))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class _Pair:
    """A JAX engine (with GRIDLLM_RAGGED_ATTN set for its mode whenever it
    runs: the JAX package reads it when it builds and traces) and a port
    engine with the same weights and the matching `ragged_attention`."""

    def __init__(self, mode: str):
        self.env = "1" if mode == "ragged" else "0"
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRIDLLM_RAGGED_ATTN", self.env)
            self.je = JEngine(JConfig(**TINY))
        params = jax.tree_util.tree_map(np.asarray, self.je.params)
        self.te = TEngine(TConfig(ragged_attention=mode == "ragged", **TINY), device="cpu",
                          params=params)

    def run(self, prompts, opts):
        """The same requests through both engines (all submitted, then
        step() until done); results in order, (jax, port) per prompt."""
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRIDLLM_RAGGED_ATTN", self.env)
            want = _batch(self.je, JRequest, prompts, opts)
        return list(zip(want, _batch(self.te, TRequest, prompts, opts)))

    def same(self, prompts, opts):
        pairs = self.run(prompts, opts)
        for w, g in pairs:
            assert g.token_ids == w.token_ids
            assert g.text == w.text
            assert g.done_reason == w.done_reason
            assert g.cached_tokens == w.cached_tokens
            assert (g.spec_proposed, g.spec_accepted) == (w.spec_proposed, w.spec_accepted)
        return [g for _, g in pairs]


def _batch(engine, request_cls, prompts, opts):
    res = {}

    def cb(i):
        def f(_delta, done, r):
            if done:
                res[i] = r
        return f

    for i, p in enumerate(prompts):
        engine.submit(request_cls(id=f"r{i}", prompt=p, options=dict(opts), on_chunk=cb(i)))
    for _ in range(10_000):
        if len(res) == len(prompts):
            break
        engine.step()
    return [res[i] for i in range(len(prompts))]


@pytest.fixture(scope="module", params=MODES)
def pair(request):
    return _Pair(request.param)


def test_engine_defaults_match_jax_resolution(pair):
    cfg = TConfig(model="tiny-llama")
    # left None, the knobs resolve from the environment as the JAX engine's
    assert (cfg.spec_decode, cfg.spec_k, cfg.ragged_attention) == (None, None, None)
    r = cfg.resolved()
    assert (r.spec_decode, r.spec_k, r.ragged_attention) == (True, 4, True)
    assert pair.te._spec_k == pair.je._spec_k == 4
    assert TEngine(TConfig(spec_decode=False, **TINY), device="cpu")._spec_k == 0
    assert TEngine(TConfig(spec_k=2, **TINY), device="cpu")._spec_k == 2


def test_greedy_repetitive_with_real_acceptance_matches_jax(pair):
    before = dict(pair.te.spec_stats), dict(pair.je.spec_stats)
    (r,) = pair.same([REP_PROMPT], REP_OPTS)
    assert r.spec_proposed > 0 and r.spec_accepted > 0
    for key in ("steps", "proposed", "accepted", "emitted"):
        assert (pair.te.spec_stats[key] - before[0][key]
                == pair.je.spec_stats[key] - before[1][key]), key
    state = pair.te.batch_state()["specDecode"]
    assert state["k"] == 4 and state["drafter"] == "ngram"
    assert state["emitted"] >= state["accepted"]


@pytest.mark.parametrize("prompt", ["hello world hello world", "xyzzy", REP_PROMPT])
def test_greedy_with_repeat_penalty_matches_jax(pair, prompt):
    pair.same([prompt], {"temperature": 0.0, "num_predict": 16})


def test_greedy_concurrent_batch_matches_jax(pair):
    pair.same(["aa aa aa aa", "bc bc bc bc", "hello"],
              {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 10})


def test_stop_sequence_mid_span_matches_jax(pair):
    (base,) = pair.same([REP_PROMPT], REP_OPTS)
    stop = base.text[5:8]
    assert len(base.text) >= 8 and stop, base.text
    chunks = []
    pair.te.submit(TRequest(id="s", prompt=REP_PROMPT, options={**REP_OPTS, "stop": [stop]},
                            on_chunk=lambda d, done, r: chunks.append(d)))
    while pair.te._pending or pair.te._slots:
        pair.te.step()
    (r,) = pair.same([REP_PROMPT], {**REP_OPTS, "stop": [stop]})
    assert r.done_reason == "stop" and stop not in r.text
    assert "".join(chunks) == r.text      # nothing past the stop was ever emitted


def test_num_predict_exact_matches_jax(pair):
    (r,) = pair.same([REP_PROMPT], {**REP_OPTS, "num_predict": 7})
    assert r.eval_count == 7 and r.done_reason == "length"


def test_long_prompt_and_warm_repeat_match_jax(pair):
    """A prompt longer than one chunk (mixed steps, or prefill_chunk with
    ragged attention off), then again from the prefix cache, beside a short
    request."""
    cold, _ = pair.same([LONG + " spec", "yo"], REP_OPTS)
    (warm,) = pair.same([LONG + " spec"], REP_OPTS)
    assert warm.cached_tokens > 0 and warm.token_ids == cold.token_ids


def test_sampled_seeded_is_deterministic(pair):
    opts = {"temperature": 0.9, "seed": 7, "num_predict": 12}
    r1 = _batch(pair.te, TRequest, [REP_PROMPT], opts)[0]
    r2 = _batch(pair.te, TRequest, [REP_PROMPT], opts)[0]
    assert r1.token_ids == r2.token_ids and r1.eval_count == 12


def test_attention_mode_is_the_models(pair):
    """The mode is fixed when the model is built, the engine admits long
    prompts by it, and mixed_step exists only with ragged attention."""
    model = pair.te.model
    assert model.ragged_attention == pair.te.config.ragged_attention
    with pytest.raises(AttributeError):
        model.ragged_attention = not model.ragged_attention
    if model.ragged_attention:
        return
    cache = pair.te.cache
    with pytest.raises(ValueError, match="ragged_attention"):
        model.mixed_step(torch.zeros(8, dtype=torch.int32), 0, 8, 0,
                         cache.page_table[0], torch.zeros(4, dtype=torch.int32), cache,
                         torch.zeros(4, dtype=torch.bool))
    calls = []
    te = pair.te
    te._dispatch_mixed_chunk = lambda *a: calls.append("mixed")
    try:
        (r,) = _batch(te, TRequest, [LONG], {"temperature": 0.0, "num_predict": 2})
    finally:
        del te._dispatch_mixed_chunk
    assert not calls and r.eval_count == 2
