"""The per-phase attention kernels' index math (csrc/per_phase_attention.cu,
which launches the bodies of csrc/attention_bodies.cuh), on the CPU, against
the JAX package's per-phase functions:

- `paged_decode` in both of its modes (the current token's K/V merged, or
  the current token already in the pool) and the batched verify
  (`cuda_kernels.prefix_chunk_slots`), each executed span by span as the
  group body cuts a slot's pages (`ragged_split_plan`) and merged as its
  last block merges them (`ragged_split_merge_ref`), at n_splits 1, 2 and
  5: against the JAX package's `paged_decode` in interpret mode and
  `paged_attention_decode_ref`, and its `paged_attention_verify`; window,
  softcap, an empty slot, -1 table entries past a slot's pages and the
  capacity edge (the fresh rows at or past it cut);
- `prefix_chunk`'s chunk plan (`ragged_chunk_tile_plan`) with the bounds
  the block reads from the device (start off the 128-key tile and off the
  page, total below start + C, total None meaning start + C, the capacity
  cut, the variant without k_cur that walks [0, total) in the pool),
  executed tile by tile against the JAX package's `prefix_chunk` in
  interpret mode and its `_prefix_chunk_ref`.

float32, rtol/atol 1e-4 (inside the kernels' 1e-3 float32 bound; the
executed plans sum in another order than the references).
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.ops import _build
from gridllm_torch.ops import attention as TA
from gridllm_torch.ops import cuda_kernels as TK
from gridllm_torch.ops.kernels import KERNELS
from gridllm_tpu.ops import attention as JA
from gridllm_tpu.ops import pallas_kernels as PK
from tests.test_torch_ragged_plan import _run_chunk_plan

TOL = dict(rtol=1e-4, atol=1e-4)
PS, KVH, H, L, D = 8, 2, 4, 2, 16
MAXP = 6                     # capacity 48 tokens per slot


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(rng, pages=64, ps=PS, kvh=KVH, d=D):
    shape = (L, pages, ps, kvh, d)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _table(rng, lengths, extra):
    """Shuffled pages per slot, -1 past the pages that lengths + extra
    tokens need (the empty slot keeps one page)."""
    table = rng.choice(60, size=len(lengths) * MAXP, replace=False).reshape(
        len(lengths), MAXP).astype(np.int32)
    for s, ln in enumerate(lengths):
        table[s, max(-(-(ln + extra) // PS), 1):] = -1
    return table


# ---------------------------------------------------------------------------
# paged_decode: the group body at Td = 1, split over pages
# ---------------------------------------------------------------------------

DECODE_LENS = np.asarray([13, 0, 37, MAXP * PS], np.int32)   # straddle, empty, capacity edge


@functools.lru_cache(maxsize=None)
def _decode_case(merge_cur, window, softcap):
    """(inputs, the JAX reference, the JAX kernel in interpret mode)."""
    rng = np.random.default_rng(11 + window + int(softcap) + 2 * merge_cur)
    kp, vp = _pools(rng)
    inp = dict(q=rng.normal(size=(4, H, D)).astype(np.float32), kp=kp, vp=vp,
               table=_table(rng, DECODE_LENS, 1), lens=DECODE_LENS)
    if merge_cur:
        inp.update(k_cur=rng.normal(size=(4, KVH, D)).astype(np.float32),
                   v_cur=rng.normal(size=(4, KVH, D)).astype(np.float32))
    jcur = {k: jnp.asarray(inp[k]) for k in ("k_cur", "v_cur") if k in inp}
    jq, jkp, jvp, jtab, jlen = (jnp.asarray(inp[k]) for k in ("q", "kp", "vp", "table", "lens"))
    ref = np.asarray(JA.paged_attention_decode_ref(
        jq, jkp[1], jvp[1], jtab, jlen, PS, logit_softcap=softcap, window=window, **jcur))
    kern = np.asarray(PK.paged_decode(jq, jkp, jvp, jtab, jlen, page_size=PS,
                                      layer=jnp.int32(1), interpret=True, softcap=softcap,
                                      window=window, **jcur))
    return inp, ref, kern


@pytest.mark.parametrize("n_splits", [1, 2, 5])
@pytest.mark.parametrize("merge_cur,window,softcap", [
    (True, 0, 0.0),
    (True, 6, 30.0),     # window + softcap
    (False, 0, 0.0),     # the current token already in the pool
    (False, 5, 30.0),
])
def test_decode_split_merge_matches_jax(merge_cur, window, softcap, n_splits):
    inp, ref, kern = _decode_case(merge_cur, window, softcap)
    cur = {k: _t(inp[k])[:, None] for k in ("k_cur", "v_cur") if k in inp}
    got = TK.ragged_split_merge_ref(
        _t(inp["kp"]), _t(inp["vp"]), PS, _t(inp["q"])[:, None], _t(inp["table"]),
        _t(inp["lens"]), cur.get("k_cur"), cur.get("v_cur"), n_splits, layer=1,
        softcap=softcap, window=window)[:, 0].numpy()
    plain = TA.paged_attention_decode_ref(
        _t(inp["q"]), _t(inp["kp"][1]), _t(inp["vp"][1]), _t(inp["table"]), _t(inp["lens"]),
        PS, logit_softcap=softcap, window=window,
        **{k: v[:, 0] for k, v in cur.items()}).numpy()
    # without the current token a length-0 slot has no key (unspecified);
    # the TPU kernel merges the current token even at the capacity edge,
    # where the references (and the port) drop it: the slot is finished
    lens = inp["lens"]
    rows = np.ones_like(lens, bool) if merge_cur else lens > 0
    np.testing.assert_allclose(got[rows], ref[rows], **TOL)
    np.testing.assert_allclose(got[rows], plain[rows], **TOL)
    in_cap = rows & (lens < MAXP * PS)
    np.testing.assert_allclose(got[in_cap], kern[in_cap], **TOL)
    if not merge_cur:   # the empty slot: no key, zeros (the merge's 0 / 1e-30)
        assert not got[lens == 0].any()


def test_decode_split_plan_walks_each_slot_once():
    """At every n_splits the spans of a slot cover [0, min(length,
    capacity)) once, and span 0 alone carries the fresh row: what the body
    reads in either mode (without fresh rows span 0 is a plain span)."""
    for n_splits in (1, 2, 5):
        plan = TK.ragged_split_plan(DECODE_LENS.tolist(), MAXP, PS, n_splits)
        for ln, spans in zip(DECODE_LENS, plan):
            walked = [r for p0, p1, _ in spans for r in range(p0, p1)]
            assert walked == list(range(min(int(ln), MAXP * PS)))
            assert [fresh for *_, fresh in spans] == [True] + [False] * (n_splits - 1)


# ---------------------------------------------------------------------------
# the per-phase verify: the group body at Td = T, every slot in one launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_splits", [1, 2, 5])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 30.0)])
def test_verify_split_merge_matches_jax(window, softcap, n_splits):
    """S = 4 slots x T = 5 candidates: a straddle, an empty slot, a slot
    whose last two candidates pass the capacity (cut), and a full slot."""
    rng = np.random.default_rng(40 + window + n_splits)
    t = 5
    lens = np.asarray([13, 0, MAXP * PS - 3, MAXP * PS], np.int32)
    kp, vp = _pools(rng)
    table = _table(rng, lens, t)
    q = (2 * rng.normal(size=(4, t, H, D))).astype(np.float32)
    kc = rng.normal(size=(4, t, KVH, D)).astype(np.float32)
    vc = rng.normal(size=(4, t, KVH, D)).astype(np.float32)
    want = np.asarray(JA.paged_attention_verify(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lens)), PS, jnp.asarray(kc),
        jnp.asarray(vc), layer=jnp.int32(1), use_pallas=False, logit_softcap=softcap,
        window=window))
    args = [_t(a) for a in (q, kp, vp, table, lens, kc, vc)]
    got = TK.ragged_split_merge_ref(args[1], args[2], PS, args[0], args[3], args[4], args[5],
                                    args[6], n_splits, layer=1, softcap=softcap, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper's CPU path (the plain version) and the dispatcher agree
    wrapper = TK.prefix_chunk_slots(args[0], args[1], args[2], args[3], args[4], PS, args[5],
                                    args[6], layer=1, softcap=softcap, window=window)
    disp = TA.paged_attention_verify(args[0], args[1], args[2], args[3], args[4], PS, args[5],
                                     args[6], layer=1, logit_softcap=softcap, window=window)
    np.testing.assert_array_equal(wrapper.numpy(), disp.numpy())
    np.testing.assert_allclose(wrapper.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# prefix_chunk: the chunk plan with the bounds the block reads
# ---------------------------------------------------------------------------


def _read_bounds(start, total, c):
    """ChunkBounds::read: start and total from the device scalars (here
    one-element tensors) or the host ints; total None is start + C."""
    cs = int(start[0]) if isinstance(start, torch.Tensor) else int(start)
    if total is None:
        return cs, cs + c
    return cs, int(total[0]) if isinstance(total, torch.Tensor) else int(total)


@pytest.mark.parametrize("h,kvh,ps,c,start,valid,window,softcap,fresh,cap_pages", [
    (8, 2, 64, 5, 1029, None, 0, 0.0, True, None),         # verify width, total = start + C
    (8, 2, 64, 256, 1029, 250, 100, 30.0, True, None),     # start off the tile and the page
    (8, 2, 16, 128, 48, 100, 0, 0.0, True, None),          # total < start + C, 16-row boxes
    (14, 2, 64, 256, 192, 256, 200, 30.0, True, None),     # G = 7: spare rows
    (8, 2, 64, 64, 300, None, 0, 0.0, True, 6),            # the capacity cut: 84 rows fit
    (8, 2, 8, 64, 640, 64, 0, 0.0, False, None),           # the chunk already in the pool
    (8, 2, 8, 130, 300, 100, 50, 30.0, False, None),       # in the pool, window, total < start + C
])
def test_chunk_plan_walk_matches_jax_prefix_chunk(h, kvh, ps, c, start, valid, window, softcap,
                                                  fresh, cap_pages):
    rng = np.random.default_rng(start + c + ps)
    n_table = cap_pages or -(-(start + c) // ps) + 2
    n_pool = n_table + 5
    d = D
    kp, vp = _pools(rng, pages=n_pool, ps=ps, kvh=kvh, d=d)
    row = rng.permutation(n_pool)[:n_table].astype(np.int32)
    n_mapped = -(-(start + (c if fresh else valid)) // ps)
    row[n_mapped:] = -1
    q = (2 * rng.normal(size=(1, c, h, d))).astype(np.float32)
    kc = rng.normal(size=(c, kvh, d)).astype(np.float32)
    vc = rng.normal(size=(c, kvh, d)).astype(np.float32)
    # the bounds as the model passes them: device scalars (total may be None)
    dev_start = torch.tensor([start], dtype=torch.int32)
    dev_total = None if valid is None else torch.tensor([start + valid], dtype=torch.int32)
    cs, ct = _read_bounds(dev_start, dev_total, c)
    n_valid = min(ct - cs, c)
    cur = dict(k_cur=kc, v_cur=vc) if fresh else {}
    want = np.asarray(JA._prefix_chunk_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(row), jnp.int32(cs),
        jnp.int32(ct), ps, layer=jnp.int32(1), logit_softcap=softcap, window=window,
        **{k: jnp.asarray(v) for k, v in cur.items()}))
    got = _run_chunk_plan(_t(kp), _t(vp), ps, _t(q), _t(kc) if fresh else None,
                          _t(vc) if fresh else None, _t(row), cs, ct, 1, window, softcap,
                          fresh=fresh)
    np.testing.assert_allclose(got.numpy()[:, :n_valid], want[:, :n_valid], **TOL)
    # the wrapper's CPU path (the plain version) with the same device scalars
    wrapper = TK.prefix_chunk(_t(q), _t(kp), _t(vp), _t(row), dev_start, dev_total, ps,
                              layer=1, softcap=softcap, window=window,
                              **{k: _t(v) for k, v in cur.items()})
    np.testing.assert_allclose(wrapper.numpy()[:, :n_valid], want[:, :n_valid], **TOL)
    if fresh and cs + c <= n_table * ps:   # the TPU kernel needs every fresh row
        kern = np.asarray(PK.prefix_chunk(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(row),
            jnp.int32(cs), jnp.int32(ct), ps, layer=jnp.int32(1), interpret=True,
            softcap=softcap, window=window, **{k: jnp.asarray(v) for k, v in cur.items()}))
        np.testing.assert_allclose(got.numpy()[:, :n_valid], kern[:, :n_valid], **TOL)


@pytest.mark.parametrize("fresh", [True, False])
def test_chunk_plan_capacity_and_pool_bounds(fresh):
    """The plan stops the pool walk at min(start, capacity) (with fresh
    rows) or at min(total, capacity) and each tile's last position (the
    chunk in the pool), and cuts fresh tiles at the capacity: no tile
    starts at or past what the block may read, every box past the pool
    keys reads zeros."""
    ps, n_table, g = 16, 20, 4                # capacity 320
    for c, start, total in ((64, 300, 364), (128, 100, 200), (200, 0, 150), (64, 320, 384)):
        plan = TK.ragged_chunk_tile_plan(c, start, total, n_table, ps, g, fresh=fresh,
                                         chunk_row=np.arange(n_table), num_pages=n_table)
        ctx = min(start if fresh else total, n_table * ps)
        for tile in plan:
            if tile.zero_write:
                assert start + tile.tok0 >= total
                continue
            q_last = start + tile.tok0 + tile.ntok - 1
            for kt0, _, boxes in tile.prefix_tiles:
                assert kt0 < min(ctx, q_last + 1)
                assert all((coord is None) == (pos >= ctx) for pos, coord in boxes)
            for j0, _ in tile.fresh_tiles:
                assert fresh and start + j0 < min(total, n_table * ps, q_last + 1)
            if not fresh:
                assert not tile.fresh_tiles


# ---------------------------------------------------------------------------
# wrappers and build
# ---------------------------------------------------------------------------


def test_chunk_bounds_stay_on_the_device():
    """Both chunk routes read start and total from device memory: a host
    int becomes one int32 on the kernel's device, and one int32 already
    there is passed through as it is, never read on the host."""
    dev = torch.device("cpu")
    y = TK._device_scalar("prefix_chunk", "start", 1029, dev)
    assert y.dtype == torch.int32 and y.shape == (1,) and y.device == dev and int(y) == 1029
    x = torch.tensor([1029], dtype=torch.int32)
    assert TK._device_scalar("prefix_chunk", "start", x, dev) is x
    for bad in (torch.tensor([1, 2], dtype=torch.int32), torch.tensor([3], dtype=torch.int64)):
        with pytest.raises(ValueError, match="one int32"):
            TK._device_scalar("prefix_chunk", "start", bad, dev)


def test_route_counters_and_sources_match_the_registry():
    """Every route of prefix_chunk has a leg counter that resets with the
    rest; every source a kernel names is built, and every source built is
    a kernel's (the per-phase kernels share csrc/per_phase_attention.cu)."""
    for leg in ("chunk", "chunk_cores", "slots"):
        TK.LEG_LAUNCHES[f"prefix_chunk.{leg}"] = 3
    TK.reset_launch_counts()
    assert all(v == 0 for v in TK.launch_counts().values())
    named = {Path(spec.source).name for spec in KERNELS}
    assert named == set(_build.SOURCES)
    assert {p.name for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    legs = {spec.name: [leg for leg, *_ in spec.legs] for spec in KERNELS}
    assert legs["prefix_chunk"] == ["chunk", "chunk_cores", "slots"]
    assert all(f"{k}.{leg}" in TK.LEG_LAUNCHES for k, ls in legs.items() for leg in ls)
