"""The port's migration wire and host KV tier against the JAX package's.

The same pages, made from a seed with numpy, go through both packages'
`transfer/wire.py` and `ops/kvtier.py`, in float32 and in bfloat16 (the
JAX package holds bfloat16 pages as ml_dtypes arrays, the port as their
16-bit words):

- headers, payloads, chunk frames and spill records are byte-equal;
- a JAX `Assembler` accepts the port's frames and the port's accepts the
  JAX package's, and both give back the same pages;
- a flipped byte, a wrong digest, a short payload and a foreign wire
  version are refused;
- the tier's quantizations are bit-equal to the JAX package's, and its LRU
  keeps the JAX tier's order, counts and bytes under the same puts and
  gets;
- the allocators' spill and restore hooks fire on the same pages.
"""

import json

import ml_dtypes
import numpy as np
import pytest

from gridllm_torch.ops import kvtier as TT
from gridllm_torch.ops.kvcache import PageAllocator as TAlloc
from gridllm_torch.transfer import wire as TW
from gridllm_tpu.ops import kvtier as JT
from gridllm_tpu.ops.kvcache import PageAllocator as JAlloc
from gridllm_tpu.transfer import wire as JW

L, N, PS, KVH, D = 2, 3, 4, 2, 8
DTYPES = ["float32", "bfloat16"]


def _pages(dtype, n=N, seed=0):
    """(jax-side k, v, port-side k, v): the same values, bfloat16 as an
    ml_dtypes array for the JAX package and as its words for the port."""
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=(L, n, PS, KVH, D)).astype(np.float32) for _ in range(2))
    if dtype == "float32":
        return k, v, k, v
    kb, vb = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    return kb, vb, kb.view(np.uint16), vb.view(np.uint16)


def _tokens(n=N):
    return list(range(7, 7 + n * PS))


@pytest.mark.parametrize("dtype", DTYPES)
def test_header_payload_and_frames_equal_jax(dtype):
    jk, jv, tk, tv = _pages(dtype)
    jh, jp = JW.build_header("r1", "tiny-llama", _tokens(), jk, jv, kv_layout="ragged",
                             chunk_bytes=1000)
    th, tp = TW.build_header("r1", "tiny-llama", _tokens(), tk, tv, dtype=dtype,
                             kv_layout="ragged", chunk_bytes=1000)
    assert th == jh and tp == jp and th["dtype"] == dtype
    assert json.dumps(th, sort_keys=True) == json.dumps(jh, sort_keys=True)
    assert list(TW.iter_chunks(th, tp)) == list(JW.iter_chunks(jh, jp))
    assert th["numChunks"] > 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_assemblers_accept_each_others_frames(dtype):
    jk, jv, tk, tv = _pages(dtype, seed=1)
    jh, jp = JW.build_header("r2", "m", _tokens(), jk, jv, chunk_bytes=333)
    th, tp = TW.build_header("r2", "m", _tokens(), tk, tv, dtype=dtype, chunk_bytes=333)
    j_asm, t_asm = JW.Assembler(dict(th)), TW.Assembler(dict(jh))
    frames_t, frames_j = list(TW.iter_chunks(th, tp)), list(JW.iter_chunks(jh, jp))
    # out of order and with a duplicate: both reassemble
    for _, f in frames_t[::-1] + frames_t[:1]:
        j_asm.feed(f)
    for _, f in frames_j[::-1] + frames_j[:1]:
        t_asm.feed(f)
    jt, jak, jav = j_asm.arrays()
    tt, tak, tav = t_asm.arrays()
    assert jt == tt == _tokens()
    assert np.array_equal(jak.view(np.uint8), tak.view(np.uint8))
    assert np.array_equal(jav.view(np.uint8), tav.view(np.uint8))
    assert tak.dtype == (np.uint16 if dtype == "bfloat16" else np.float32)
    np.testing.assert_array_equal(TW.as_float32(tak, dtype), np.asarray(jk, np.float32))
    # the HTTP path: the whole payload at once
    raw = TW.Assembler(dict(jh))
    raw.feed_raw(jp)
    assert raw.payload() == tp


def _corrupt(case, header, payload):
    frames = [f for _, f in TW.iter_chunks(header, payload)]
    h = dict(header)
    if case == "crc":
        rec = json.loads(frames[1])
        rec["crc"] ^= 1
        frames[1] = json.dumps(rec)
    elif case == "digest":
        h["digest"] = "0" * 32
    elif case == "size":
        h["totalBytes"] = int(h["totalBytes"]) + 1
    elif case == "version":
        h["v"] = TW.WIRE_VERSION + 1
    return h, frames


@pytest.mark.parametrize("case", ["crc", "digest", "size", "version"])
def test_corruption_is_refused(case):
    _, _, tk, tv = _pages("bfloat16", seed=2)
    header, payload = TW.build_header("r3", "m", _tokens(), tk, tv, dtype="bfloat16",
                                      chunk_bytes=500)
    h, frames = _corrupt(case, header, payload)
    for mod in (TW, JW):   # the JAX package refuses the same corruptions
        with pytest.raises(mod.WireError):
            asm = mod.Assembler(h)
            for f in frames:
                asm.feed(f)
            asm.arrays()


def test_builders_refuse_bad_shapes():
    _, _, tk, tv = _pages("float32")
    with pytest.raises(ValueError, match="cover"):
        TW.build_header("r", "m", _tokens()[:-1], tk, tv)
    with pytest.raises(ValueError, match="held as"):
        TW.build_header("r", "m", _tokens(), tk, tv, dtype="bfloat16")
    with pytest.raises(ValueError, match="travel together"):
        TW.build_spill_header("ab", "m", tk[:, :1], tv[:, :1], quant="int8-page")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [None, "int8-page", "int8-rows"])
def test_spill_records_equal_jax(dtype, quant):
    jk, jv, tk, tv = _pages(dtype, n=1, seed=3)
    kw_j, kw_t = {}, {"dtype": dtype}
    if quant == "int8-page":
        jk, ks = JT.quantize_page(jk)
        jv, vs = JT.quantize_page(jv)
        tk, tks = TT.quantize_page(tk, dtype)
        tv, tvs = TT.quantize_page(tv, dtype)
        assert np.array_equal(jk, tk) and np.array_equal(ks, tks) and np.array_equal(vs, tvs)
        kw_j = dict(k_scale=ks, v_scale=vs, quant=quant)
        kw_t = dict(k_scale=tks, v_scale=tvs, quant=quant)
    elif quant == "int8-rows":
        jk, ks = JT.quantize_rows_np(jk)
        jv, vs = JT.quantize_rows_np(jv)
        tk, tks = TT.quantize_rows_np(tk, dtype)
        tv, tvs = TT.quantize_rows_np(tv, dtype)
        assert np.array_equal(jk, tk) and np.array_equal(ks, tks)
        assert ks.shape == (L, 1, PS)
        kw_j = dict(k_scale=ks, v_scale=vs, quant=quant)
        kw_t = dict(k_scale=tks, v_scale=tvs, quant=quant)
    jh, jp = JW.build_spill_header("ab" * 16, "m", jk, jv, **kw_j)
    th, tp = TW.build_spill_header("ab" * 16, "m", tk, tv, **kw_t)
    assert th == jh and tp == jp
    asm = TW.Assembler(dict(jh))
    asm.feed_raw(jp)
    got = TW.spill_arrays(jh, asm.payload())
    want = JW.spill_arrays(jh, jp)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g.view(np.uint8), np.asarray(w).view(np.uint8))
    if quant == "int8-page":
        np.testing.assert_array_equal(TT.dequantize_page(got[0], got[2]),
                                      JT.dequantize_page(want[0], want[2]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantizations_bit_equal_jax(dtype):
    """quantize_rows_np is what an int8 importer stores: a JAX and a torch
    int8 pool hold the same bytes for the same wire pages (zeros included)."""
    jk, _, tk, _ = _pages(dtype, seed=4)
    jk = jk.copy()
    tk = tk.copy()
    jk[0, 0, 0] = 0
    tk[0, 0, 0] = 0
    jq, js = JT.quantize_rows_np(jk)
    tq, ts = TT.quantize_rows_np(tk, dtype)
    assert np.array_equal(jq, tq) and np.array_equal(js, ts) and js[0, 0, 0] == 1.0
    jq, js = JT.quantize_page(jk[:, :1])
    tq, ts = TT.quantize_page(tk[:, :1], dtype)
    assert np.array_equal(jq, tq) and np.array_equal(js, ts)


@pytest.mark.parametrize("spill_int8", [False, True])
def test_tier_keeps_jax_lru_order_counts_and_bytes(spill_int8):
    """The same puts and gets on a tier that holds about three pages: the
    same keys evicted in the same order, the same stats and records."""
    def run(mod, words):
        rec_bytes = 2 * L * PS * KVH * D * (1 if spill_int8 else 4) + (8 * L if spill_int8 else 0)
        tier = mod.HostKVTier(3 * rec_bytes + rec_bytes // 2, model="m", spill_int8=spill_int8)
        log = []
        for i in range(6):
            jk, jv, tk, tv = _pages("float32", n=1, seed=10 + i)
            key = bytes([i]) * 16
            if words:
                tier.put(key, tk, tv, dtype="float32")
            else:
                tier.put(key, jk, jv)
            if i == 2:   # promote key 0: the LRU then evicts key 1 first
                log.append(tier.get(bytes([0]) * 16) is not None)
                tier.mark_restored(bytes([0]) * 16)
            log.append(sorted(k[0] for k in tier._recs))
        log.append(tier.get(bytes([1]) * 16))   # evicted: a miss
        return tier.stats(), log, [(h, p) for h, p in tier._recs.values()]

    assert run(TT, True) == run(JT, False)
    stats, log, _ = run(TT, True)
    assert stats["evictions"] > 0 and stats["misses"] == 1 and stats["restores"] == 1
    assert [0, 2, 3] in log and log[-2] == [3, 4, 5]   # key 1 went before key 0


def test_allocator_hooks_fire_on_the_same_pages_as_jax():
    """Spill on eviction (from alloc and from the bounded LRU), restore on
    a chain miss: the port's allocator calls its hooks with the JAX
    allocator's pages and keys, and claim_page / register_claimed /
    peek_key keep its state."""
    def run(cls):
        log = []
        a = cls(4, 4, 4, cache_pages=-1)
        a.spill_sink = lambda page, key: log.append(("spill", page, key))
        ids = list(range(12))
        a.alloc(0, 12)
        a.free(0, ids)
        a.alloc(1, 16)
        a.free(1)
        b = cls(8, 4, 4, cache_pages=2)
        b.spill_sink = lambda page, key: log.append(("lru", page, key))

        def restore(key):
            page = b.claim_page()
            log.append(("restore", page, key, b.peek_key(key)))
            b.register_claimed(page, key)
            b.register_claimed(page, key)   # a second registration is a no-op
            b.unpin_pages([page])
            return b.peek_key(key)

        b.restore_source = restore
        log.append(("matched", b.match_prefix(0, ids)))
        b.alloc(0, 12)
        b.free(0, ids)
        log.append(("state", b.free_pages, b.cached_pages, b.evictions))
        return log

    assert run(TAlloc) == run(JAlloc)
    assert any(e[0] == "lru" for e in run(TAlloc))
