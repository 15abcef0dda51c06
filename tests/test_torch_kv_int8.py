"""The int8 KV pool (`QuantPages`) of the PyTorch port against the JAX package.

- `quantize_kv_rows`: int8 values and scales exactly equal (tolerance 0),
  with an all-zero row and values at .5 rounding boundaries;
- the three all-layer writes (decode, multi-row verify, prefill) into an
  int8 pool, with an inactive slot, a past-capacity position and an
  unmapped page: values and scales exactly equal after every write; the
  single-layer writes refuse an int8 pool;
- `gather_kv` dequantizes exactly as the JAX package does;
- `ragged_paged_attention` on an int8 pool against the JAX package's
  ragged Pallas kernel run in interpret mode (its `quant` leg) and its jnp
  dispatcher: chunk only, groups only (Td = 1 and 5), both, window with
  softcap, D = 64 and 128. Held to the `KERNELS` attention tolerance
  (3e-2); the largest float32 difference from the Pallas kernel observed
  over these cases is 1.2e-4 (the pool's values reach tens). The per-row
  scales span two decades, so a reader that ignores the scale, or uses
  one scale per page, misses by more than the tolerance (checked here on
  the plain version);
- the per-phase dispatchers on an int8 pool (the plain versions, as in
  the JAX package);
- tiny-llama float32 engines, JAX `kv_int8=True` against the port's, spec
  decode on, ragged attention on and off, with a warm prefix-cache repeat:
  greedy streams identical;
- `memory_arrays()["alloc"]`: `kvInt8`, and bytes per page equal to the
  JAX engine's, the int8 pool at half the float pool's plus its scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.ops import attention as TA
from gridllm_torch.ops import cuda_kernels as TK
from gridllm_torch.ops import kvcache as TC
from gridllm_torch.ops.kernels import by_name
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.ops import attention as JA
from gridllm_tpu.ops import kvcache as JC
from gridllm_tpu.ops import pallas_kernels as PK

_SPEC = by_name("ragged_attention")
TOL = dict(rtol=_SPEC.rtol, atol=_SPEC.atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_pool(tp, jp):
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))


def _rows_spanning_decades(rng, shape):
    """Normal rows [..., KVH, D], each scaled by 10 ** U(-1, 1)."""
    x = rng.normal(size=shape)
    return (x * 10.0 ** rng.uniform(-1, 1, size=shape[:-2] + (1, 1))).astype(np.float32)


# ---------------------------------------------------------------------------
# quantization and writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_quantize_kv_rows_bit_identical(seed):
    rng = np.random.default_rng(seed)
    x = _rows_spanning_decades(rng, (2, 9, 2, 16))
    x[0, 3] = 0.0                                   # an all-zero row keeps scale 1.0
    # amax 127 gives scale 1.0: every value sits on a .5 rounding boundary
    x[1, 4] = rng.integers(-126, 126, size=(2, 16)) + 0.5
    x[1, 4, 0, 0] = 127.0
    # the same at scale 0.5 (amax 63.5): x / scale lands on k + .5
    x[1, 5] = (rng.integers(-126, 126, size=(2, 16)) + 0.5) / 2
    x[1, 5, 1, 3] = 63.5
    jq, js = JC.quantize_kv_rows(jnp.asarray(x))
    tq, ts = TC.quantize_kv_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 3] == 1.0 and not tq[0, 3].any()
    assert ts[1, 4] == 1.0 and ts[1, 5] == 0.5
    # half to even at the boundaries, as jnp.round
    np.testing.assert_array_equal(tq[1, 4].numpy(), np.round(x[1, 4]).astype(np.int8))
    assert (np.abs(x[1, 4] - np.round(x[1, 4])) == 0.5).sum() > 16


def _pools(L=2, P=12, ps=4, kvh=2, d=16):
    shape = (L, P, ps, kvh, d)
    jp = [JC.QuantPages(jnp.zeros(shape, jnp.int8), jnp.ones(shape[:3], jnp.float32))
          for _ in range(2)]
    tp = [TC.QuantPages.zeros(shape, "cpu") for _ in range(2)]
    return jp, tp


def test_all_layer_writes_into_int8_pool_match_jax():
    """Prefill (a ragged length, a page past the table's end unmapped),
    then decode and a verify step's rows with an inactive slot, a
    past-capacity position and an unmapped page, then a decode step with
    no slot active: values and scales equal after every write."""
    rng = np.random.default_rng(0)
    (jk, jv), (tk, tv) = _pools()
    L, ps, kvh, d, maxp = 2, 4, 2, 16, 3
    table = np.asarray([[0, 1, 2], [3, 4, -1], [5, 6, 7]], np.int32)

    def check():
        _same_pool(tk, jk)
        _same_pool(tv, jv)

    # prefill of 10 valid rows of a 12-row bucket into slot 1 (page 2 unmapped)
    kn, vn = (_rows_spanning_decades(rng, (L, 12, kvh, d)) for _ in range(2))
    jk, jv = JC.write_prefill_all(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(table[1]), jnp.int32(0), jnp.int32(10), ps)
    out = TC.write_prefill_all(tk, tv, _t(kn), _t(vn), _t(table[1]), 0, 10, ps)
    assert out[0] is tk and out[1] is tv            # in place
    check()
    assert tk.scale[:, 3:5].ne(1.0).sum() == L * 8   # rows 8, 9 had no page
    # decode: slot 0 at 5, slot 1 inactive, slot 2 past capacity (12)
    positions = np.asarray([5, 9, 12], np.int32)
    active = np.asarray([True, False, True])
    kn, vn = (_rows_spanning_decades(rng, (L, 3, kvh, d)) for _ in range(2))
    jk, jv = JC.write_decode_all(jk, jv, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(table),
                                 jnp.asarray(positions), jnp.asarray(active), ps)
    TC.write_decode_all(tk, tv, _t(kn), _t(vn), _t(table), _t(positions), _t(active), ps)
    check()
    # verify: K+1 = 4 rows per slot; slot 1's rows cross into its unmapped
    # page, slot 2 runs past capacity
    positions = np.asarray([6, 6, 10], np.int32)[:, None] + np.arange(4, dtype=np.int32)
    active = np.asarray([True, True, True])
    kn, vn = (_rows_spanning_decades(rng, (L, 3, 4, kvh, d)) for _ in range(2))
    jk, jv = JC.write_multi_all(jk, jv, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(table),
                                jnp.asarray(positions), jnp.asarray(active), ps)
    TC.write_multi_all(tk, tv, _t(kn), _t(vn), _t(table), _t(positions), _t(active), ps)
    check()
    # decode with every slot inactive: nothing is written
    before = tk.data.clone(), tk.scale.clone()
    positions, active = np.asarray([1, 2, 3], np.int32), np.zeros(3, bool)
    kn, vn = (_rows_spanning_decades(rng, (L, 3, kvh, d)) for _ in range(2))
    jk, jv = JC.write_decode_all(jk, jv, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(table),
                                 jnp.asarray(positions), jnp.asarray(active), ps)
    TC.write_decode_all(tk, tv, _t(kn), _t(vn), _t(table), _t(positions), _t(active), ps)
    check()
    assert torch.equal(tk.data, before[0]) and torch.equal(tk.scale, before[1])
    assert not tk.data[:, 8:].any() and tk.scale[:, 8:].eq(1.0).all()   # never mapped


def test_single_layer_writes_refuse_int8_pool():
    _, (tk, tv) = _pools()
    k1, v1 = tk.layer(0), tv.layer(0)
    rows = torch.zeros(4, 2, 16)
    with pytest.raises(TypeError, match="int8"):
        TC.write_prefill(k1, v1, rows, rows, torch.zeros(3, dtype=torch.int32), 0, 4, 4)
    with pytest.raises(TypeError, match="int8"):
        TC.write_decode(k1, v1, rows[:1], rows[:1], torch.zeros((1, 3), dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool), 4)


def _quant_pool(rng, L, P, ps, kvh, d):
    """A pool holding the quantization of rows whose scales span two
    decades, as (JAX QuantPages, port QuantPages)."""
    x = _rows_spanning_decades(rng, (L, P * ps, kvh, d))
    q, s = JC.quantize_kv_rows(jnp.asarray(x))
    q = np.asarray(q).reshape(L, P, ps, kvh, d)
    s = np.asarray(s).reshape(L, P, ps)
    return JC.QuantPages(jnp.asarray(q), jnp.asarray(s)), TC.QuantPages(_t(q), _t(s))


def test_gather_kv_dequantizes():
    rng = np.random.default_rng(1)
    jk, tk = _quant_pool(rng, 2, 6, 4, 2, 8)
    jv, tv = _quant_pool(rng, 2, 6, 4, 2, 8)
    row = np.asarray([4, -1, 0], np.int32)
    gk, gv = JC.gather_kv(jk.layer(1), jv.layer(1), jnp.asarray(row), 4)
    tgk, tgv = TC.gather_kv(tk.layer(1), tv.layer(1), _t(row), 4)
    assert tgk.dtype == torch.float32 and tgk.shape == (12, 2, 8)
    np.testing.assert_array_equal(tgk.numpy(), np.asarray(gk))
    np.testing.assert_array_equal(tgv.numpy(), np.asarray(gv))
    want = tk.data[1, 4].float() * tk.scale[1, 4][:, None, None]
    assert torch.equal(tgk[:4], want)
    assert tk.nbytes == tk.data.nbytes + tk.scale.nbytes
    assert (tk.shape, tk.dim(), tk.device) == (tk.data.shape, 5, tk.data.device)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _int8_ragged_inputs(rng, d, td):
    ps, kvh, h, S, maxp, C, P = 8, 2, 4, 3, 6, 16, 32
    jk, tk = _quant_pool(rng, 2, P, ps, kvh, d)
    jv, tv = _quant_pool(rng, 2, P, ps, kvh, d)
    table = rng.choice(26, size=S * maxp, replace=False).reshape(S, maxp).astype(np.int32)
    table[1, 1:] = -1
    return dict(
        pools=(jk, jv, tk, tv), ps=ps,
        chunk=dict(q_chunk=rng.normal(size=(1, C, h, d)).astype(np.float32),
                   chunk_row=np.asarray([26, 27, 28, 29, 30, 31], np.int32),
                   chunk_start=16, chunk_total=16 + 11,
                   k_chunk=rng.normal(size=(C, kvh, d)).astype(np.float32),
                   v_chunk=rng.normal(size=(C, kvh, d)).astype(np.float32)),
        group=dict(q_group=rng.normal(size=(S, td, h, d)).astype(np.float32),
                   page_table=table,
                   group_lengths=np.asarray([13, 0, 37], np.int32),
                   k_group=rng.normal(size=(S, td, kvh, d)).astype(np.float32),
                   v_group=rng.normal(size=(S, td, kvh, d)).astype(np.float32)),
    )


def _region_kwargs(inp, regions):
    kw = {}
    if regions in ("chunk", "both"):
        kw.update(inp["chunk"])
    if regions in ("group", "both"):
        kw.update(inp["group"])
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else jnp.int32(v))
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return kw, jkw, tkw


@pytest.mark.parametrize("regions,td,d,softcap,window", [
    ("chunk", 1, 128, 0.0, 0),
    ("group", 1, 128, 0.0, 0),      # decode
    ("group", 5, 128, 0.0, 0),      # spec-verify width
    ("both", 1, 128, 0.0, 0),       # a mixed step
    ("both", 5, 128, 30.0, 6),      # window + softcap
    ("group", 1, 64, 30.0, 4),      # D = 64
    ("both", 5, 64, 0.0, 0),
])
def test_ragged_on_int8_pool_matches_jax(regions, td, d, softcap, window):
    rng = np.random.default_rng(td * 10 + window + d)
    inp = _int8_ragged_inputs(rng, d, td)
    jk, jv, tk, tv = inp["pools"]
    kw, jkw, tkw = _region_kwargs(inp, regions)
    kc, kg = PK.ragged_attention(jk.data, jv.data, inp["ps"], layer=jnp.int32(1),
                                 interpret=True, softcap=softcap, window=window,
                                 k_scale=jk.scale, v_scale=jv.scale, **jkw)
    rc, rg = JA.ragged_paged_attention(jk, jv, inp["ps"], layer=jnp.int32(1),
                                       logit_softcap=softcap, window=window, **jkw)
    tc, tg = TA.ragged_paged_attention(tk, tv, inp["ps"], layer=1, logit_softcap=softcap,
                                       window=window, **tkw)
    # the wrapper's CPU path: values and scales as separate tensors
    wc, wg = TK.ragged_attention(tk.data, tv.data, inp["ps"], layer=1, softcap=softcap,
                                 window=window, k_scale=tk.scale, v_scale=tv.scale, **tkw)
    if "q_chunk" in kw:
        valid = kw["chunk_total"] - kw["chunk_start"]
        np.testing.assert_array_equal(wc.numpy(), tc.numpy())
        np.testing.assert_allclose(tc.numpy()[:, :valid], np.asarray(kc)[:, :valid], **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(rc), **TOL)
    if "q_group" in kw:
        np.testing.assert_array_equal(wg.numpy(), tg.numpy())
        np.testing.assert_allclose(tg.numpy(), np.asarray(kg), **TOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(rg), **TOL)


@pytest.mark.parametrize("mutant", ["scale_ignored", "one_scale_per_page", "other_layer"])
def test_int8_cases_catch_a_wrong_scale(mutant):
    """The scales of these cases span two decades: reading the pool with
    the scale ignored, with each page's first row scale for all its rows,
    or with the other layer's scales, moves the output by more than the
    tolerance."""
    rng = np.random.default_rng(3)
    inp = _int8_ragged_inputs(rng, 128, 5)
    _, _, tk, tv = inp["pools"]
    _, _, tkw = _region_kwargs(inp, "both")

    def wrong(pool):
        if mutant == "scale_ignored":
            return TC.QuantPages(pool.data, torch.ones_like(pool.scale))
        if mutant == "other_layer":
            return TC.QuantPages(pool.data, pool.scale.flip(0))
        return TC.QuantPages(pool.data, pool.scale[..., :1].expand_as(pool.scale).contiguous())

    good = TA.ragged_paged_attention(tk, tv, inp["ps"], layer=1, **tkw)
    bad = TA.ragged_paged_attention(wrong(tk), wrong(tv), inp["ps"], layer=1, **tkw)
    valid = tkw["chunk_total"] - tkw["chunk_start"]
    err = max(float((good[0] - bad[0])[:, :valid].abs().max()),
              float((good[1] - bad[1])[[0, 2]].abs().max()))   # slot 1 is empty
    assert err > 10 * _SPEC.atol, err


def test_per_phase_dispatchers_on_int8_pool_match_jax():
    """Decode, chunk and verify through the per-phase dispatchers: an int8
    pool runs the plain versions in both packages."""
    rng = np.random.default_rng(4)
    inp = _int8_ragged_inputs(rng, 16, 5)
    jk, jv, tk, tv = inp["pools"]
    g, c, ps = inp["group"], inp["chunk"], inp["ps"]
    tol = dict(rtol=1e-5, atol=1e-5)
    li = 1
    jd = JA.paged_attention_decode(
        jnp.asarray(g["q_group"][:, 0]), jk, jv, jnp.asarray(g["page_table"]),
        jnp.asarray(g["group_lengths"]), ps, k_cur=jnp.asarray(g["k_group"][:, 0]),
        v_cur=jnp.asarray(g["v_group"][:, 0]), layer=jnp.int32(li))
    td = TA.paged_attention_decode(
        _t(g["q_group"][:, 0]), tk, tv, _t(g["page_table"]), _t(g["group_lengths"]), ps,
        k_cur=_t(g["k_group"][:, 0]), v_cur=_t(g["v_group"][:, 0]), layer=li)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **tol)
    jcnk = JA.attention_prefix_chunk(
        jnp.asarray(c["q_chunk"]), jk, jv, jnp.asarray(c["chunk_row"]),
        jnp.int32(c["chunk_start"]), jnp.int32(c["chunk_total"]), ps,
        k_cur=jnp.asarray(c["k_chunk"]), v_cur=jnp.asarray(c["v_chunk"]), layer=jnp.int32(li))
    tcnk = TA.attention_prefix_chunk(
        _t(c["q_chunk"]), tk, tv, _t(c["chunk_row"]), c["chunk_start"], c["chunk_total"], ps,
        k_cur=_t(c["k_chunk"]), v_cur=_t(c["v_chunk"]), layer=li)
    valid = c["chunk_total"] - c["chunk_start"]
    np.testing.assert_allclose(tcnk.numpy()[:, :valid], np.asarray(jcnk)[:, :valid], **tol)
    jver = JA.paged_attention_verify(
        jnp.asarray(g["q_group"]), jk, jv, jnp.asarray(g["page_table"]),
        jnp.asarray(g["group_lengths"]), ps, jnp.asarray(g["k_group"]),
        jnp.asarray(g["v_group"]), layer=jnp.int32(li))
    tver = TA.paged_attention_verify(
        _t(g["q_group"]), tk, tv, _t(g["page_table"]), _t(g["group_lengths"]), ps,
        _t(g["k_group"]), _t(g["v_group"]), layer=li)
    np.testing.assert_allclose(tver.numpy(), np.asarray(jver), **tol)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

TINY = dict(model="tiny-llama", max_slots=4, page_size=8, num_pages=64,
            max_pages_per_slot=8, prefill_buckets=(16, 32), prefill_chunk=16,
            dtype="float32", kv_int8=True)
REP_PROMPT = "ab ab ab ab ab ab"
REP_OPTS = {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 24}
LONG = "ab ab ab ab ab ab ab ab ab ab"   # 30 tokens > prefill_chunk


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


class _Pair:
    """A JAX engine with kv_int8=True (GRIDLLM_RAGGED_ATTN set for its
    mode whenever it builds and runs) and the port's with the same weights."""

    def __init__(self, mode: str):
        self.env = "1" if mode == "ragged" else "0"
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRIDLLM_RAGGED_ATTN", self.env)
            self.je = JEngine(JConfig(**TINY))
        params = jax.tree_util.tree_map(np.asarray, self.je.params)
        self.te = TEngine(TConfig(ragged_attention=mode == "ragged", **TINY), device="cpu",
                          params=params)

    def same(self, prompts, opts):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GRIDLLM_RAGGED_ATTN", self.env)
            want = _batch(self.je, JRequest, prompts, opts)
        got = _batch(self.te, TRequest, prompts, opts)
        for w, g in zip(want, got):
            assert g.token_ids == w.token_ids
            assert g.done_reason == w.done_reason
            assert g.cached_tokens == w.cached_tokens
            assert (g.spec_proposed, g.spec_accepted) == (w.spec_proposed, w.spec_accepted)
        return got


@pytest.fixture(scope="module", params=["ragged", "per_phase"])
def pair(request):
    return _Pair(request.param)


def test_int8_engine_builds_quant_pool(pair):
    assert isinstance(pair.je.cache.k, JC.QuantPages)
    assert isinstance(pair.te.cache.k, TC.QuantPages)
    tk, jk = pair.te.cache.k, pair.je.cache.k
    assert tk.shape == tuple(jk.shape) and tk.data.dtype == torch.int8
    assert tk.scale.shape == tuple(jk.scale.shape) and tk.scale.dtype == torch.float32


def test_int8_greedy_streams_match_jax(pair):
    (r,) = pair.same([REP_PROMPT], REP_OPTS)
    assert r.spec_accepted > 0
    pair.same(["aa aa aa aa", "bc bc bc bc", "hello"],
              {"temperature": 0.0, "repeat_penalty": 1.0, "num_predict": 10})


def test_int8_long_prompt_and_warm_repeat_match_jax(pair):
    cold, _ = pair.same([LONG + " q8", "yo"], REP_OPTS)
    (warm,) = pair.same([LONG + " q8"], REP_OPTS)
    assert warm.cached_tokens > 0 and warm.token_ids == cold.token_ids


def test_int8_memory_accounting_matches_jax(pair):
    """bytesPerPage and the pool tensors as the JAX engine reports them; the
    int8 pool holds half the float32 pool's bytes at bf16 width, here a
    quarter of the float32 pool's, plus 4 bytes of scale per row."""
    t_arrays, j_arrays = pair.te.memory_arrays(), pair.je.memory_arrays()
    t, j = t_arrays["alloc"], j_arrays["alloc"]
    assert t["kvInt8"] is True and j["kvInt8"] is True
    for key in ("numPages", "pageSize", "pagesUsed", "pagesCached", "pagesFree",
                "bytesPerPage", "usedBytes", "freeBytes", "kvLayout"):
        assert t[key] == j[key], key
    cache = pair.te.cache
    assert [x.shape for x in t_arrays["kv"]] == [tuple(x.shape) for x in j_arrays["kv"]]
    assert any(x is cache.k.scale for x in t_arrays["kv"])
    fp = TEngine(TConfig(**{**TINY, "kv_int8": None}), device="cpu")
    fp_bpp = fp.memory_arrays()["alloc"]["bytesPerPage"]
    assert fp.memory_arrays()["alloc"]["kvInt8"] is False
    cfg = pair.te.cfg
    rows = 2 * cfg.num_layers * TINY["page_size"]              # K and V rows of a page
    assert t["bytesPerPage"] == fp_bpp // 4 + rows * 4
    assert t["bytesPerPage"] < fp_bpp / 2
