"""The index math of the port's ragged_attention kernels
(csrc/ragged_attention.cu), on CPU.

- `cuda_kernels.ragged_chunk_tile_plan`, the chunk kernel's plan (which
  query tokens and heads a block holds, which prefix tiles and TMA boxes
  and fresh tiles it loads, at which page coordinates, and which tiles
  take the per-element mask): held exactly against what
  `ragged_paged_attention_ref`'s mask lets each row see, and executed in
  torch, tile by tile with the mask only where the plan puts it and the
  prefix read through the plan's page coordinates, against the JAX
  package's `ragged_paged_attention_ref` (float32, 1e-5);
- `cuda_kernels.ragged_split_count` and `ragged_split_plan`, the group
  split over pages: exact, from host shapes only;
- `cuda_kernels.ragged_split_merge_ref`, the groups computed span by span
  and merged as the kernel's last block merges them: against the port's
  and the JAX package's `ragged_paged_attention_ref` (float32, 1e-5).

Cases, at small sizes: shuffled page tables with -1 entries, chunk starts
of 64 and 192 (not multiples of the 128-key tile), page sizes 8, 16 and 64,
windows, softcap, G = 1, 4 and 7, tree bits, int8 scales spanning two
decades, and slots from empty to the table's capacity. At head dim 256
(gemma2's) the chunk kernel takes tiles of 64 keys (`prefill_bk`): the
plans at D = 256 are held with that tile, the tile itself against the
kernel source's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridllm_torch.ops import attention as TA
from gridllm_torch.ops import cuda_kernels as TK
from gridllm_torch.ops import kvcache as TC
from gridllm_torch.ops import spec as TSP
from gridllm_tpu.ops import attention as JA
from gridllm_tpu.ops import kvcache as JC
from gridllm_tpu.ops import pallas_kernels as PK

TOL = dict(rtol=1e-5, atol=1e-5)   # float32: the merge and the executed plan
BK = TK.PREFILL_BK


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8_pool(rng, n_layers, n_pool, ps, kvh, d):
    """An int8 pool of quantized normal rows, each scaled by 10 ** U(-1, 1)
    (the row scales span two decades): the JAX package's QuantPages and
    the port's, the same values."""
    x = rng.normal(size=(n_layers, n_pool * ps, kvh, d)) * 10.0 ** rng.uniform(
        -1, 1, size=(n_layers, n_pool * ps, 1, 1))
    qv, sc = JC.quantize_kv_rows(jnp.asarray(x.astype(np.float32)))
    qv = np.asarray(qv).reshape(n_layers, n_pool, ps, kvh, d)
    sc = np.asarray(sc).reshape(n_layers, n_pool, ps)
    return JC.QuantPages(jnp.asarray(qv), jnp.asarray(sc)), TC.QuantPages(_t(qv), _t(sc))


def _table_row(rng, n_table, n_mapped, n_pool):
    """A shuffled table row: n_mapped distinct pages of the pool, -1 after."""
    row = rng.permutation(n_pool)[:n_table].astype(np.int32)
    row[n_mapped:] = -1
    return row


# ---------------------------------------------------------------------------
# the chunk kernel's tile plan
# ---------------------------------------------------------------------------

CHUNK_CASES = [  # (C, chunk_start, valid rows, page size, window)
    (300, 64, 290, 64, 0),
    (256, 192, 256, 64, 0),
    (256, 192, 200, 16, 100),
    (200, 48, 180, 16, 8),
    (130, 0, 130, 8, 0),
    (64, 384, 10, 64, 1),
    (129, 128, 129, 8, 300),
]


@functools.lru_cache(maxsize=None)
def _chunk_visible(c, start, valid, ps, window):
    """[C, start + C] bool: key position j visible to the row of chunk
    token i, read off ragged_paged_attention_ref itself: zero queries
    spread each row's softmax evenly over its visible keys, and one-hot
    values (through a shuffled table for the prefix, the fresh V for the
    chunk) show which. A row that sees no key spreads over every key,
    keys past the valid length included, which no row can see: such a row
    sees nothing."""
    n = start + c
    n_table = -(-n // ps) + 2
    rng = np.random.default_rng(n)
    row = _table_row(rng, n_table, -(-start // ps), n_table + 3)
    vp = np.zeros((n_table + 3, ps, 1, n_table * ps), np.float32)
    for pos in range(start):
        vp[row[pos // ps], pos % ps, 0, pos] = 1.0
    vc = np.zeros((c, 1, n_table * ps), np.float32)
    vc[np.arange(c), 0, start + np.arange(c)] = 1.0
    kp = np.zeros_like(vp)
    out, _ = TA.ragged_paged_attention_ref(
        _t(kp), _t(vp), ps, q_chunk=torch.zeros(1, c, 1, n_table * ps), chunk_row=_t(row),
        chunk_start=start, chunk_total=start + valid, k_chunk=torch.zeros(c, 1, n_table * ps),
        v_chunk=_t(vc), window=window)
    vis = out[0, :, 0, :n] > 0
    vis[vis[:, start + valid:].any(dim=1)] = False
    return vis


@pytest.mark.parametrize("g", [1, 4, 7])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_plan_loads_every_visible_key_and_masks_only_where_needed(case, g):
    _check_chunk_plan(case, g)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_plan_at_head_dim_256_takes_the_64_key_tile(case, g):
    """gemma2's head dim: every chunk case planned with the kernel's tile
    at D = 256, G = 1 and 2 (gemma2:9b's grouping)."""
    _check_chunk_plan(case, g, d=256)


def test_host_tiles_follow_the_kernel_source():
    """prefill_bk, which every host plan takes, is the kernels'
    tile_keys (csrc/hopper_common.cuh) at each compiled head dim."""
    import re
    from pathlib import Path

    src = (Path(TK.__file__).parents[1] / "csrc" / "hopper_common.cuh").read_text()
    m = re.search(r"constexpr int tile_keys\(int D\) \{ return D == 256 \? (\d+) : (\d+); \}",
                  src)
    assert m is not None
    for d in TK._HEAD_DIMS:
        assert TK.prefill_bk(d) == int(m[1] if d == 256 else m[2])
    assert (TK.prefill_bk(64), TK.prefill_bk(128), TK.prefill_bk(256)) == (BK, BK, 64)
    assert [TK.chunk_box_rows(ps, 256) for ps in (8, 16, 64, 128)] == [8, 16, 64, 64]


def _check_chunk_plan(case, g, d=128):
    c, start, valid, ps, window = case
    total = start + valid
    bk = TK.prefill_bk(d)
    vis = _chunk_visible(c, start, valid, ps, window)
    n_table = -(-(start + c) // ps) + 2
    row = _table_row(np.random.default_rng(g), n_table, -(-start // ps), 40)
    num_pages, layer = 40, 1
    box = TK.chunk_box_rows(ps, d)
    assert box % 8 == 0 and bk % box == 0 and ps % box == 0
    plan = TK.ragged_chunk_tile_plan(c, start, total, n_table, ps, g, window, chunk_row=row,
                                     layer=layer, num_pages=num_pages, d=d)
    for tile in plan:
        toks = range(tile.tok0, tile.tok0 + tile.ntok)
        what = f"C={c} start={start} total={total} ps={ps} window={window} tok0={tile.tok0}"
        if tile.zero_write:   # wholly past the valid length: nothing loaded
            assert start + tile.tok0 >= total and not tile.prefix_tiles and not tile.fresh_tiles
            continue
        assert start + tile.tok0 < total, what
        loaded = torch.zeros(start + c, dtype=torch.bool)
        for kt0, masked, boxes in tile.prefix_tiles:
            assert kt0 % bk == 0 and kt0 < start, what
            assert [pos for pos, _ in boxes] == list(range(kt0, kt0 + bk, box)), what
            for pos, coord in boxes:
                if pos >= start:   # past the prefix: TMA reads zeros
                    assert coord is None, what
                    continue
                # one box stays inside one page, at the table's page
                assert pos // ps == (pos + box - 1) // ps, what
                assert coord == layer * num_pages + row[pos // ps], what
                loaded[pos:pos + box] = True
            keys = slice(kt0, kt0 + bk)
            whole = kt0 + bk <= start and bool(vis[toks][:, keys].all())
            assert masked != whole, f"{what} prefix kt0={kt0} masked={masked}"
            assert vis[toks][:, keys].any(), f"{what} prefix kt0={kt0} is dead"
        for j0, masked in tile.fresh_tiles:
            assert j0 % bk == 0 and j0 < c, what
            keys = slice(start + j0, start + j0 + bk)
            loaded[keys] = True
            whole = j0 + bk <= c and bool(vis[toks][:, keys].all())
            assert masked != whole, f"{what} fresh j0={j0} masked={masked}"
            assert vis[toks][:, keys].any(), f"{what} fresh j0={j0} is dead"
        for tok in toks:
            assert not (vis[tok] & ~loaded).any(), f"{what}: token {tok} misses a key"


@pytest.mark.parametrize("g", [1, 4, 7])
def test_chunk_plan_rows_cover_each_token_and_head_once_heaviest_first(g):
    bq = TK.PREFILL_ROWS // g
    for c, start, valid, ps, window in CHUNK_CASES:
        plan = TK.ragged_chunk_tile_plan(c, start, start + valid, -(-(start + c) // ps), ps, g,
                                         window)
        assert [tile.qt for tile in plan] == list(range(len(plan) - 1, -1, -1))
        seen = []
        for tile in plan:
            assert tile.tok0 == tile.qt * bq and 1 <= tile.ntok <= bq
            assert len(tile.rows) == tile.ntok * g <= TK.PREFILL_ROWS
            assert tile.rows == tuple((tile.tok0 + r // g, r % g) for r in range(len(tile.rows)))
            seen += tile.rows
        assert sorted(seen) == [(tok, j) for tok in range(c) for j in range(g)]


def test_chunk_route_by_input_type():
    """The tensor-core chunk kernel takes a bf16 q on a bf16 or an int8
    pool whose pages hold whole 8-row TMA boxes; anything else is the
    CUDA-core route, chosen by type, never after a failure."""
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert TK.chunk_on_tensor_cores(bf16, bf16, 64)
    assert TK.chunk_on_tensor_cores(bf16, bf16, 16)
    assert TK.chunk_on_tensor_cores(bf16, bf16, 256)
    assert TK.chunk_on_tensor_cores(bf16, i8, 64)
    assert TK.chunk_on_tensor_cores(bf16, i8, 8)
    assert not TK.chunk_on_tensor_cores(f32, f32, 64)
    assert not TK.chunk_on_tensor_cores(f32, i8, 64)
    assert not TK.chunk_on_tensor_cores(bf16, bf16, 12)
    assert not TK.chunk_on_tensor_cores(bf16, i8, 12)
    assert [TK.chunk_box_rows(ps) for ps in (8, 16, 64, 128, 256, 48)] == [8, 16, 64, 128, 128, 16]


def _run_chunk_plan(kp, vp, ps, q, kc, vc, row, start, total, layer, window, softcap,
                    fresh=True, k_scale=None, v_scale=None, scale_row_shift=0):
    """The chunk kernel's walk in torch, for every kv head: per query tile of
    the plan, an online softmax over its prefix tiles (each the plan's TMA
    boxes, read from the pool viewed as [L * P, ps, KVH, D] at the boxes'
    page coordinates, zeros for a box past the pool keys) and its fresh
    tiles (zeros past C), the per-element mask only on the tiles the plan
    masks, against the limits the block derives from start and total (pool
    keys below ctx, fresh keys below min(total, capacity); with `fresh`
    False the chunk is in the pool and ctx = min(total, capacity)).

    With k_scale/v_scale [L, P, ps] the pool is int8 and this is the
    tensor-core kernel's dequant: each prefix tile's int8 values taken
    exactly (as the kernel converts them to bf16), the boxes' row scales
    staged beside them (0 for a box past the pool keys), S's column of key
    j multiplied by its K scale after Q K^T, and P's column by its V scale
    before P V, l summing P unscaled; fresh tiles unscaled.
    `scale_row_shift` reads each row's scales from the row that many rows
    on in its page (a mutant). Float32; → [1, C, H, D]."""
    n_layers, num_pages, _, kvh, d = kp.shape
    quant = k_scale is not None
    if quant:
        flat_ks, flat_vs = k_scale.reshape(-1, ps).float(), v_scale.reshape(-1, ps).float()
    c, h = q.shape[1], q.shape[2]
    g = h // kvh
    flat_k, flat_v = kp.reshape(-1, ps, kvh, d), vp.reshape(-1, ps, kvh, d)
    bk = TK.prefill_bk(d)   # the kernel's tile at this head dim
    box = TK.chunk_box_rows(ps, d)
    cap = row.shape[0] * ps
    ctx = min(max(start if fresh else total, 0), cap)
    f_limit = min(total, cap)
    plan = TK.ragged_chunk_tile_plan(c, start, total, row.shape[0], ps, g, window,
                                     chunk_row=row.numpy(), layer=layer, num_pages=num_pages,
                                     fresh=fresh, d=d)
    out = torch.zeros(1, c, h, d)
    for kh in range(kvh):
        for tile in plan:
            if tile.zero_write:
                continue
            toks = torch.tensor([tok for tok, _ in tile.rows])
            heads = torch.tensor([kh * g + j for _, j in tile.rows])
            qr = q[0, toks, heads].float()
            qp = start + toks
            m = torch.full((len(toks),), -1e30)
            l = torch.zeros(len(toks))
            acc = torch.zeros(len(toks), d)
            tiles = []
            for kt0, masked, boxes in tile.prefix_tiles:
                ks, vs, k_sc, v_sc = [], [], [], []
                for pos, coord in boxes:
                    if coord is None:
                        ks.append(torch.zeros(box, d))
                        vs.append(torch.zeros(box, d))
                        k_sc.append(torch.zeros(box))
                        v_sc.append(torch.zeros(box))
                    else:
                        off = pos % ps
                        ks.append(flat_k[coord, off:off + box, kh].float())
                        vs.append(flat_v[coord, off:off + box, kh].float())
                        if quant:
                            rows_ = (off + torch.arange(box) + scale_row_shift) % ps
                            k_sc.append(flat_ks[coord, rows_])
                            v_sc.append(flat_vs[coord, rows_])
                scales = (torch.cat(k_sc), torch.cat(v_sc)) if quant else None
                tiles.append((kt0, masked, ctx, torch.cat(ks), torch.cat(vs), scales))
            for j0, masked in tile.fresh_tiles:
                ks = torch.zeros(bk, d)
                vs = torch.zeros(bk, d)
                n = min(bk, c - j0)
                ks[:n], vs[:n] = kc[j0:j0 + n, kh].float(), vc[j0:j0 + n, kh].float()
                tiles.append((start + j0, masked, f_limit, ks, vs, None))
            for kt0, masked, limit, ks, vs, scales in tiles:
                x = qr @ ks.T
                if scales is not None:
                    x = x * scales[0][None]
                x = x * d ** -0.5
                if softcap > 0:
                    x = softcap * torch.tanh(x / softcap)
                if masked:
                    kpos = kt0 + torch.arange(bk)
                    ok = (kpos[None] <= qp[:, None]) & (kpos[None] < limit)
                    if window > 0:
                        ok &= (qp[:, None] - kpos[None]) < window
                    x = torch.where(ok, x, torch.full_like(x, -1e30))
                m_new = torch.maximum(m, x.amax(dim=1))
                alpha = torch.exp(m - m_new)
                p = torch.where(x > -5e29, torch.exp(x - m_new[:, None]), torch.zeros_like(x))
                l = l * alpha + p.sum(1)
                if scales is not None:
                    p = p * scales[1][None]
                acc = acc * alpha[:, None] + p @ vs
                m = m_new
            out[0, toks, heads] = acc / l.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("h,kvh,d,ps,c,start,valid,window,softcap", [
    (8, 2, 16, 64, 300, 64, 290, 0, 0.0),       # G = 4, start not a multiple of 128
    (14, 2, 16, 64, 256, 192, 256, 200, 30.0),  # G = 7: two spare rows per block
    (4, 4, 16, 16, 200, 48, 180, 8, 0.0),       # G = 1, eight 16-row boxes per tile
    (8, 2, 32, 8, 130, 320, 100, 0, 30.0),      # 8-row pages, a long prefix
    (8, 2, 16, 64, 64, 384, 10, 1, 0.0),        # window 1: the diagonal only
    (2, 1, 256, 64, 200, 128, 180, 100, 50.0),  # D = 256 (64-key tiles), gemma2's G = 2
    (4, 2, 256, 16, 130, 48, 120, 0, 0.0),      # D = 256, 16-row boxes
])
def test_chunk_plan_walk_matches_jax_ref(h, kvh, d, ps, c, start, valid, window, softcap):
    rng = np.random.default_rng(start + c)
    n_table = -(-(start + c) // ps) + 2
    n_pool = n_table + 5
    kp = rng.normal(size=(2, n_pool, ps, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(2, n_pool, ps, kvh, d)).astype(np.float32)
    row = _table_row(rng, n_table, -(-start // ps), n_pool)
    kw = dict(q_chunk=(2 * rng.normal(size=(1, c, h, d))).astype(np.float32), chunk_row=row,
              chunk_start=start, chunk_total=start + valid,
              k_chunk=rng.normal(size=(c, kvh, d)).astype(np.float32),
              v_chunk=rng.normal(size=(c, kvh, d)).astype(np.float32))
    want, _ = JA.ragged_paged_attention_ref(
        jnp.asarray(kp), jnp.asarray(vp), ps, layer=jnp.int32(1), logit_softcap=softcap,
        window=window, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else jnp.int32(v))
                          for k, v in kw.items()})
    got = _run_chunk_plan(_t(kp), _t(vp), ps, _t(kw["q_chunk"]), _t(kw["k_chunk"]),
                          _t(kw["v_chunk"]), _t(row), start, start + valid, 1, window, softcap)
    np.testing.assert_allclose(got.numpy()[:, :valid], np.asarray(want)[:, :valid], **TOL)


INT8_CHUNK_CASES = {  # h, kvh, d, ps, C, chunk_start, valid rows, window, softcap, table pages
    "start1029_g4_d64": (8, 2, 64, 64, 128, 1029, 128, 0, 0.0, None),
    "total_inside_chunk_ps16": (8, 2, 64, 16, 256, 1029, 200, 0, 0.0, None),
    "g7": (14, 2, 64, 64, 128, 320, 128, 0, 0.0, None),
    "window_softcap": (8, 2, 64, 64, 256, 700, 256, 300, 30.0, None),
    "past_capacity": (8, 2, 64, 64, 256, 192, 250, 0, 0.0, 5),   # 320 positions
    "d128": (8, 1, 128, 64, 128, 448, 100, 0, 0.0, None),
    "d256_window_softcap50": (2, 1, 256, 64, 128, 320, 120, 200, 50.0, None),
}


def _int8_chunk_inputs(h, kvh, d, ps, c, start, valid, table_pages):
    rng = np.random.default_rng(start + c + h + d)
    n_table = table_pages or -(-(start + c) // ps) + 2
    n_pool = n_table + 5
    (jk, tk), (jv, tv) = (_int8_pool(rng, 2, n_pool, ps, kvh, d) for _ in range(2))
    row = _table_row(rng, n_table, n_table if table_pages else -(-start // ps), n_pool)
    kw = dict(q_chunk=(2 * rng.normal(size=(1, c, h, d))).astype(np.float32), chunk_row=row,
              chunk_start=start, chunk_total=start + valid,
              k_chunk=rng.normal(size=(c, kvh, d)).astype(np.float32),
              v_chunk=rng.normal(size=(c, kvh, d)).astype(np.float32))
    return (jk, jv, tk, tv), kw


def _int8_chunk_walk(case, scale_row_shift=0):
    """(the int8 chunk kernel's walk, the JAX Pallas ragged_attention's
    quant leg in interpret mode, the JAX package's plain
    ragged_paged_attention_ref) on one case, float32 [1, valid, H, D]."""
    h, kvh, d, ps, c, start, valid, window, softcap, table_pages = case
    (jk, jv, tk, tv), kw = _int8_chunk_inputs(h, kvh, d, ps, c, start, valid, table_pages)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else jnp.int32(v))
           for k, v in kw.items()}
    pallas, _ = PK.ragged_attention(jk.data, jv.data, ps, layer=jnp.int32(1), interpret=True,
                                    softcap=softcap, window=window, k_scale=jk.scale,
                                    v_scale=jv.scale, **jkw)
    ref, _ = JA.ragged_paged_attention_ref(jk, jv, ps, layer=jnp.int32(1),
                                           logit_softcap=softcap, window=window, **jkw)
    got = _run_chunk_plan(tk.data, tv.data, ps, _t(kw["q_chunk"]), _t(kw["k_chunk"]),
                          _t(kw["v_chunk"]), _t(kw["chunk_row"]), start, start + valid, 1,
                          window, softcap, k_scale=tk.scale, v_scale=tv.scale,
                          scale_row_shift=scale_row_shift)
    return got.numpy()[:, :valid], np.asarray(pallas)[:, :valid], np.asarray(ref)[:, :valid]


def _int8_close(got, want):
    """float32 at the file's tolerance, atol relative to the output's
    largest magnitude: the pools' values reach ~30 (row scales spanning two
    decades), and the TPU kernel's quant leg differs from its own plain
    version by up to 1.3e-4 on these cases (float32 in another order)."""
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * np.abs(want).max())


@pytest.mark.parametrize("name", list(INT8_CHUNK_CASES))
def test_int8_chunk_plan_walk_matches_jax(name):
    """The tensor-core chunk kernel's int8 route, executed tile by tile on
    the plan (exact int8 values, the K scales on S's columns, the V scales
    on P's), against the TPU kernel's quant leg in interpret mode: start
    1,029 (neither page- nor tile-aligned), a total inside the chunk,
    G = 7, window with softcap, D = 64 and 128, and a 5-page table that
    ends inside the chunk (rows past the capacity cut). On the rows past
    the capacity the TPU kernel departs from its plain version (by up to
    5e-2 on 7 of those rows here, on an fp pool as on this one), so there
    the walk is held to the plain version, which the port follows."""
    case = INT8_CHUNK_CASES[name]
    got, pallas, ref = _int8_chunk_walk(case)
    h, kvh, d, ps, c, start, valid, window, softcap, table_pages = case
    inside = valid if table_pages is None else table_pages * ps - start
    _int8_close(got[:, :inside], pallas[:, :inside])
    _int8_close(got, ref)


def test_int8_chunk_plan_catches_a_scale_from_the_wrong_row():
    """The same walk reading every row's scales from the next row of its
    page misses the TPU kernel by far more than the tolerance: the cases
    hold the scale placement."""
    got, pallas, _ = _int8_chunk_walk(INT8_CHUNK_CASES["start1029_g4_d64"], scale_row_shift=1)
    err = np.abs(got - pallas).max()
    assert err > 100 * TOL["atol"] * np.abs(pallas).max(), err


def test_int8_to_bf16_conversion_is_exact():
    """csrc/attention_bodies.cuh's `int8x4_to_bf16x4` on every int8 value:
    each byte b in the low byte of the bf16 bits 0x43bb, v = 0x4300 |
    (b & 0x7F) and c = 0x4300 | (b & 0x80) as bf16, v - c in bf16 (here
    in float32, then rounded to bf16: v, c and the difference are exact);
    equal to bf16(x) bit for bit, and the bytes land low value first."""
    x = np.arange(-128, 128, dtype=np.int8)
    b = x.view(np.uint8).astype(np.uint32)
    v = ((0x4300 | (b & 0x7F)) << 16).astype(np.uint32).view(np.float32)
    c = ((0x4300 | (b & 0x80)) << 16).astype(np.uint32).view(np.float32)
    got = torch.from_numpy(v - c).to(torch.bfloat16)
    want = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # the byte permutes: selector 0x5140 takes bytes 0 and 1 of the word
    # beside 0x43, 0x7362 bytes 2 and 3
    word = np.uint32(0x04030201)

    def byte_perm(x, y, sel):
        pool = [(int(x) >> (8 * i)) & 0xFF for i in range(4)] + [(int(y) >> (8 * i)) & 0xFF
                                                                 for i in range(4)]
        return sum(pool[(sel >> (4 * n)) & 0x7] << (8 * n) for n in range(4))

    assert byte_perm(word, 0x43434343, 0x5140) == 0x43024301
    assert byte_perm(word, 0x43434343, 0x7362) == 0x43044303


# ---------------------------------------------------------------------------
# the group split over pages
# ---------------------------------------------------------------------------


def test_split_count_from_host_shapes():
    """Enough blocks for SPLIT_BLOCKS_PER_SM per SM and spans of at most
    SPLIT_MAX_SPAN_KEYS at the table's capacity, at most one span per
    table page, partials within SPLIT_SCRATCH_BYTES; lengths never enter."""
    assert TK.SPLIT_BLOCKS_PER_SM == 2 and TK.SPLIT_SCRATCH_BYTES == 64 << 20
    assert TK.SPLIT_MAX_SPAN_KEYS == 2048
    # the long configuration: 512 pages of 64 per slot, 8 slots: 16 spans
    assert TK.ragged_split_count(8, 8, 512, 4, 128, 132, page_size=64) == 16
    # llama3:8b decode, 8 slots on a 128-page table, 132 SMs: 5 spans
    assert TK.ragged_split_count(8, 8, 128, 4, 128, 132) == 5
    # one slot on a 512-page table: 33 spans
    assert TK.ragged_split_count(1, 8, 512, 4, 128, 132) == 33
    # a 2-page table caps the spans at 2; many slots need no split
    assert TK.ragged_split_count(1, 8, 2, 4, 128, 132) == 2
    assert TK.ragged_split_count(128, 8, 32, 4, 128, 132) == 1
    assert TK.ragged_split_count(0, 8, 512, 4, 128, 132) == 1
    # the draft's Td = 64 group (256 rows at D = 64) stays within the scratch cap
    n = TK.ragged_split_count(8, 8, 128, 256, 64, 132)
    assert n == 5 and 8 * 8 * n * 256 * 66 * 4 <= TK.SPLIT_SCRATCH_BYTES
    assert TK.ragged_split_count(8, 8, 128, 512, 128, 132) == 3   # the cap binds


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 9, 66])
def test_split_plan_cuts_each_slot_into_whole_page_spans(ps, n_splits):
    n_table = 20
    lengths = [0, 1, ps - 1, ps, ps + 1, 7 * ps + 3, n_table * ps, n_table * ps + 50]
    plan = TK.ragged_split_plan(lengths, n_table, ps, n_splits)
    for ln, spans in zip(lengths, plan):
        ctx = min(ln, n_table * ps)
        assert len(spans) == n_splits
        assert spans[0][2] and not any(fresh for _, _, fresh in spans[1:])
        walked = []
        span_pages = -(-(-(-ctx // ps)) // n_splits)
        for i, (p0, p1, _) in enumerate(spans):
            assert p0 <= p1 and (p0 % ps == 0 or p0 == ctx)
            assert p1 - p0 <= span_pages * ps
            if i and p0 < p1:
                assert p0 == spans[i - 1][1]
            walked += list(range(p0, p1))
        # every cached row once, in order; nothing past ctx
        assert walked == list(range(ctx)), (ln, spans)


def _group_inputs(rng, td, d=16, quant=False, window=0, softcap=0.0):
    ps, kvh, h, s, maxp, p = 8, 2, 8, 5, 6, 40
    table = rng.permutation(p)[:s * maxp].reshape(s, maxp).astype(np.int32)
    lengths = np.asarray([13, 0, 37, 48 - td, 1], np.int32)   # up to the capacity, 48
    for i, ln in enumerate(lengths):
        table[i, -(-(ln + td) // ps):] = -1
    if quant:
        (jk, tk), (jv, tv) = (_int8_pool(rng, 2, p, ps, kvh, d) for _ in range(2))
    else:
        kp = rng.normal(size=(2, p, ps, kvh, d)).astype(np.float32)
        vp = rng.normal(size=(2, p, ps, kvh, d)).astype(np.float32)
        jk, jv, tk, tv = jnp.asarray(kp), jnp.asarray(vp), _t(kp), _t(vp)
    group = dict(q_group=(2 * rng.normal(size=(s, td, h, d))).astype(np.float32),
                 page_table=table, group_lengths=lengths,
                 k_group=rng.normal(size=(s, td, kvh, d)).astype(np.float32),
                 v_group=rng.normal(size=(s, td, kvh, d)).astype(np.float32))
    return ps, (jk, jv, tk, tv), group


@pytest.mark.parametrize("td,tree,quant,window,softcap", [
    (1, None, False, 0, 0.0),      # decode
    (5, None, False, 0, 0.0),      # verify
    (1, None, False, 6, 30.0),     # window + softcap
    (5, None, True, 0, 0.0),       # int8 scales
    (6, (4, 2), False, 0, 0.0),    # tree: the engine's default topology
    (6, (4, 2), True, 9, 30.0),    # tree on an int8 pool, window, softcap
])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
def test_split_merge_ref_matches_jax_ref(td, tree, quant, window, softcap, n_splits):
    rng = np.random.default_rng(td * 100 + window + n_splits + 7 * quant)
    ps, (jk, jv, tk, tv), group = _group_inputs(rng, td, quant=quant)
    tree_kw, jtree = {}, {}
    if tree is not None:
        parents = TSP.tree_topology(*tree)
        assert len(parents) == td
        depth, mask = TSP.tree_depths(parents), TSP.tree_ancestor_mask(parents)
        tree_kw = dict(tree_pos=depth, tree_mask=mask)
        jtree = dict(tree_pos=jnp.asarray(depth), tree_mask=jnp.asarray(mask))
    _, want = JA.ragged_paged_attention_ref(
        jk, jv, ps, layer=jnp.int32(1), logit_softcap=softcap, window=window,
        **{k: jnp.asarray(v) for k, v in group.items()}, **jtree)
    tg = {k: _t(v) for k, v in group.items()}
    got = TK.ragged_split_merge_ref(tk, tv, ps, n_splits=n_splits, layer=1, softcap=softcap,
                                    window=window, **tg, **tree_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tref = {} if tree is None else dict(tree_pos=_t(tree_kw["tree_pos"]),
                                        tree_mask=_t(tree_kw["tree_mask"]))
    _, port = TA.ragged_paged_attention_ref(tk, tv, ps, layer=1, logit_softcap=softcap,
                                            window=window, **tg, **tref)
    np.testing.assert_allclose(got.numpy(), port.numpy(), **TOL)

