"""ops.kvcache of the PyTorch port against the JAX package.

- PageAllocator: random operation sequences give the same page tables,
  free lists, reuse LRUs, refcounts and chain keys as the JAX allocator.
- The plain writes (`write_prefill`, `write_decode`) and the all-layer
  dispatchers on CPU tensors match the JAX references and the JAX write
  kernels run in interpret mode, exactly (the chunk kernel on its valid
  region: it also writes the padded tail of its last page).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.ops import cuda_kernels as TK
from gridllm_torch.ops import kvcache as TC
from gridllm_tpu.ops import kvcache as JC
from gridllm_tpu.ops import pallas_kernels as PK


def _alloc_state(a):
    return {
        "free": list(a._free),
        "owned": {s: list(p) for s, p in a._owned.items() if p},
        "refs": dict(a._refs),
        "key_of": dict(a._key_of),
        "page_by_key": dict(a._page_by_key),
        "lru": list(a._lru),
        "stats": (a.hits, a.misses, a.evictions, a.cow_copies),
    }


@pytest.mark.parametrize("seed,cache_pages", [(0, -1), (1, 6), (2, 0), (3, -1)])
def test_page_allocator_random_ops_match_jax(seed, cache_pages):
    rng = np.random.default_rng(seed)
    num_pages, ps, maxp, slots = 24, 4, 6, 4
    j = JC.PageAllocator(num_pages, ps, maxp, cache_pages=cache_pages)
    t = TC.PageAllocator(num_pages, ps, maxp, cache_pages=cache_pages)
    # prompts drawn from a few shared stems, so prefixes repeat and match
    stems = [list(rng.integers(0, 50, size=12)) for _ in range(3)]
    ctx: dict[int, list[int]] = {}
    pins: list[tuple[list[int], list[int]]] = []
    for _ in range(300):
        op = rng.integers(0, 5)
        slot = int(rng.integers(0, slots))
        if op <= 1 and slot not in ctx:
            stem = stems[int(rng.integers(0, 3))]
            ids = [int(x) for x in stem[:int(rng.integers(1, 13))]]
            ids += [int(x) for x in rng.integers(0, 50, size=int(rng.integers(0, 8)))]
            want = len(ids) + int(rng.integers(0, 6))
            assert j.match_prefix(slot, ids) == t.match_prefix(slot, ids)
            pj, pt = j.alloc(slot, want), t.alloc(slot, want)
            assert pj == pt
            if pj is None:
                j.free(slot)
                t.free(slot)
            else:
                ctx[slot] = ids
        elif op == 2 and slot in ctx:
            ids = ctx.pop(slot)
            reg = ids if rng.random() < 0.8 else None
            j.free(slot, reg)
            t.free(slot, reg)
        elif op == 3:
            ids = stems[int(rng.integers(0, 3))]
            ids = [int(x) for x in ids[:int(rng.integers(1, 13))]]
            (pj, nj), (pt, nt) = j.pin_prefix(ids), t.pin_prefix(ids)
            assert (pj, nj) == (pt, nt)
            pins.append((pj, pt))
        elif op == 4:
            if pins and rng.random() < 0.7:
                pj, pt = pins.pop(int(rng.integers(0, len(pins))))
                j.unpin_pages(pj)
                t.unpin_pages(pt)
            else:
                pages = [int(p) for p in rng.integers(0, num_pages, size=3)]
                assert j.evict_cached(pages) == t.evict_cached(pages)
        for s in range(slots):
            assert j.table_row(s) == t.table_row(s)
        assert _alloc_state(j) == _alloc_state(t)


def test_chain_keys_byte_identical():
    ids = list(range(37))
    assert TC._page_chain_key(b"", ids[:8]) == JC._page_chain_key(b"", ids[:8])
    j, t = JC.PageAllocator(16, 8, 8, -1), TC.PageAllocator(16, 8, 8, -1)
    assert j.chain_keys(ids) == t.chain_keys(ids)
    assert j.chain_keys(ids, 2) == t.chain_keys(ids, 2)


def _pools(rng, L=2, P=16, ps=8, kvh=2, d=16):
    k = rng.normal(size=(L, P, ps, kvh, d)).astype(np.float32)
    return k, (k * 2.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


_TABLE = np.asarray([
    [3, 1, -1, -1],    # slot 0: 2 pages mapped
    [5, -1, -1, -1],   # slot 1: 1 page
    [7, 8, 9, 10],     # slot 2: full
    [-1, -1, -1, -1],  # slot 3: unmapped
], np.int32)
_POS = np.asarray([9, 3, 31, 0], np.int32)
_ACTIVE = np.asarray([True, True, True, False])


def test_write_decode_matches_jax():
    """write_decode (one layer and the full pool), write_decode_all and the
    paged_write_decode wrapper on CPU equal the JAX scatter references and
    the JAX kernel in interpret mode, bit for bit."""
    rng = np.random.default_rng(7)
    kp, vp = _pools(rng, L=3)
    s = _TABLE.shape[0]
    kn = rng.normal(size=(3, s, 2, 16)).astype(np.float32)
    vn = kn + 1.0
    args = (_TABLE, _POS, _ACTIVE)

    want_k, want_v = JC.write_decode_all(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        *map(jnp.asarray, args), 8, use_pallas=False)
    srange = jnp.arange(s, dtype=jnp.int32)
    page_idx = JC._safe_page_idx(lambda p: jnp.asarray(_TABLE)[srange, p],
                                 jnp.asarray(_POS), jnp.asarray(_ACTIVE), 8, 4, 16)
    kern_k, kern_v = PK.paged_write_decode(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        page_idx, jnp.asarray(_POS) % 8, interpret=True)
    np.testing.assert_array_equal(np.asarray(kern_k), np.asarray(want_k))

    for fn in (TC.write_decode, TC.write_decode_all, TK.paged_write_decode):
        got_k, got_v = fn(_t(kp), _t(vp), _t(kn), _t(vn), *map(_t, args), 8)
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(kern_v))

    # one layer's pool through the single-layer form
    jk, jv = JC.write_decode(jnp.asarray(kp[1]), jnp.asarray(vp[1]), jnp.asarray(kn[1]),
                             jnp.asarray(vn[1]), *map(jnp.asarray, args), 8)
    tk, tv = TC.write_decode(_t(kp[1]), _t(vp[1]), _t(kn[1]), _t(vn[1]), *map(_t, args), 8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("start,length", [
    (0, 32),    # fresh prefill, full pages
    (0, 19),    # ragged tail (the kernel's padding rows land in an owned page)
    (16, 32),   # continuation, page-aligned start
    (16, 5),    # continuation, ragged
])
def test_write_prefill_matches_jax(start, length):
    """write_prefill and write_prefill_all on CPU equal the JAX scatter
    exactly, and equal the JAX paged_write_chunk kernel (interpret mode) on
    every valid position and every page outside the chunk's span."""
    rng = np.random.default_rng(3)
    L, t, ps = 2, 32, 8
    kn = rng.normal(size=(L, t, 2, 16)).astype(np.float32)
    vn = kn * 3.0
    kp = np.zeros((L, 16, ps, 2, 16), np.float32)
    row = np.asarray([4, 9, 2, 11, 6, 1, 13, 3], np.int32)

    want_k, want_v = JC.write_prefill_all(
        jnp.asarray(kp), jnp.asarray(kp), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(row), jnp.int32(start), jnp.int32(length), ps, use_pallas=False)
    kern_k, kern_v = PK.paged_write_chunk(
        jnp.asarray(kp), jnp.asarray(kp), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(row), jnp.int32(start), jnp.int32(length), ps, interpret=True)

    for fn in (TC.write_prefill, TC.write_prefill_all, TK.paged_write_chunk):
        got_k, got_v = fn(_t(kp), _t(kp), _t(kn), _t(vn), _t(row), start, length, ps)
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))

    got_k = got_k.numpy()
    for i in range(length):
        pos = start + i
        page, off = row[pos // ps], pos % ps
        np.testing.assert_array_equal(got_k[:, page, off], np.asarray(kern_k)[:, page, off])
    touched = {int(row[(start + i) // ps]) for i in range(max(length, 1))}
    for page in set(range(16)) - touched:
        np.testing.assert_array_equal(got_k[:, page], np.asarray(kern_k)[:, page])

    # single-layer form
    jk, _ = JC.write_prefill(jnp.asarray(kp[0]), jnp.asarray(kp[0]), jnp.asarray(kn[0]),
                             jnp.asarray(vn[0]), jnp.asarray(row), jnp.int32(start),
                             jnp.int32(length), ps)
    tk, _ = TC.write_prefill(_t(kp[0]), _t(kp[0]), _t(kn[0]), _t(vn[0]), _t(row), start,
                             length, ps)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_gather_kv_matches_jax():
    rng = np.random.default_rng(5)
    kp, vp = _pools(rng, L=1)
    row = np.asarray([3, -1, 7, 0], np.int32)
    jk, jv = JC.gather_kv(jnp.asarray(kp[0]), jnp.asarray(vp[0]), jnp.asarray(row), 8)
    tk, tv = TC.gather_kv(_t(kp[0]), _t(vp[0]), _t(row), 8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_kv_cache_create_layout():
    c = TC.PagedKVCache.create(2, 16, 8, 2, 16, 4, 6, dtype=torch.float32, device="cpu")
    j = JC.PagedKVCache.create(2, 16, 8, 2, 16, 4, 6, dtype=jnp.float32)
    assert tuple(c.k.shape) == j.k.shape and tuple(c.page_table.shape) == j.page_table.shape
    np.testing.assert_array_equal(c.page_table.numpy(), np.asarray(j.page_table))
    assert c.max_context == j.max_context == 48
