"""The tile plan of the port's prefill kernel (csrc/flash_prefill.cu), on CPU.

`cuda_kernels.prefill_tile_plan` is the kernel's index math in Python: for
each query tile, its tokens and rows, the K/V tiles it loads, which of them
need the per-element mask, whether it only writes zeros, and the order the
blocks are issued in. The kernel body runs only on the card; this holds its
plan against what `attention_prefill_ref`'s mask lets each row see, for
T up to 300, K/V tiles of 64 and 128 keys, windows 0, 1, 8 and 100,
several valid lengths and the head groupings G = 1, 2, 4, 7 and 8
(qwen2.5's G = 7 leaves two spare rows of 128); at head dim 256 (gemma2's)
with the kernel's 64-key tile.
"""

import functools

import pytest
import torch

from gridllm_torch.ops.attention import attention_prefill_ref
from gridllm_torch.ops.cuda_kernels import PREFILL_ROWS, prefill_bk, prefill_tile_plan

T_LENS = (1, 17, 64, 127, 128, 129, 200, 300)
WINDOWS = (0, 1, 8, 100)
GROUPS = (1, 2, 4, 7, 8)


def _seq_lens(t: int) -> list[int]:
    return sorted({1, t // 2 or 1, max(t - 1, 1), t} | ({64, 128} & set(range(1, t + 1))))


@functools.lru_cache(maxsize=None)
def _visible(t: int, seq_len: int, window: int) -> torch.Tensor:
    """[T, T] bool: key j visible to the row of token i, read off
    attention_prefill_ref itself: zero queries spread each row's softmax
    evenly over its visible keys, and one-hot values show which. A padding
    row that sees no key spreads evenly over all T, keys past seq_len
    included, which no row can see: such a row sees nothing."""
    q = torch.zeros(1, t, 1, t)
    k = torch.zeros(1, t, 1, t)
    v = torch.eye(t)[None, :, None, :]
    out = attention_prefill_ref(q, k, v, torch.tensor([seq_len]), window=window)
    vis = out[0, :, 0, :] > 0
    vis[vis[:, seq_len:].any(dim=1)] = False
    return vis


def _cases():
    for t in T_LENS:
        for seq_len in _seq_lens(t):
            for window in WINDOWS:
                yield t, seq_len, window


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("g", GROUPS)
def test_plan_loads_every_visible_key_and_masks_only_where_needed(g, bk):
    _check_plan(g, bk=bk)


@pytest.mark.parametrize("g", [1, 2])
def test_plan_at_head_dim_256_takes_the_kernel_tile(g):
    """At gemma2's head dim the bf16 kernel loads 64-key tiles
    (`prefill_bk`, the kernel's tile_keys): the default plan at D = 256 is
    that tile's, and holds the same checks."""
    assert prefill_bk(256) == 64 and prefill_bk(128) == prefill_bk(64) == 128
    for t, seq_len, window in _cases():
        assert (prefill_tile_plan(t, seq_len, g, window, d=256)
                == prefill_tile_plan(t, seq_len, g, window, bk=64))
    _check_plan(g, d=256)


def _check_plan(g, bk=None, d=128):
    bk = prefill_bk(d) if bk is None else bk
    for t, seq_len, window in _cases():
        vis = _visible(t, seq_len, window)
        for tile in prefill_tile_plan(t, seq_len, g, window, bk=bk):
            tokens = range(tile.tok0, tile.tok0 + tile.ntok)
            what = f"T={t} seq_len={seq_len} window={window} tok0={tile.tok0}"
            if tile.zero_write:
                # wholly past the length: padding rows only, nothing loaded
                assert tile.tok0 >= seq_len and not tile.kv_tiles, what
                continue
            assert tile.tok0 < seq_len, what
            loaded = torch.zeros(t, dtype=torch.bool)
            for kt0, masked in tile.kv_tiles:
                assert kt0 % bk == 0 and kt0 < min(tile.tok0 + tile.ntok, seq_len), what
                keys = slice(kt0, min(kt0 + bk, t))
                loaded[keys] = True
                wholly_visible = kt0 + bk <= t and bool(vis[tokens][:, keys].all())
                # mask-free exactly when every row sees every key of the tile
                assert masked != wholly_visible, f"{what} kt0={kt0} masked={masked}"
            for tok in tokens:
                assert not (vis[tok] & ~loaded).any(), f"{what}: token {tok} misses a key"
            # no tile is loaded that no row of the query tile sees
            for kt0, _ in tile.kv_tiles:
                assert vis[tokens][:, kt0:kt0 + bk].any(), f"{what} kt0={kt0} is dead"


@pytest.mark.parametrize("g", GROUPS)
def test_plan_rows_cover_each_token_and_head_once_heaviest_first(g):
    bq = PREFILL_ROWS // g
    for t in T_LENS:
        plan = prefill_tile_plan(t, t, g)
        # issue order: the last query tile (most keys) first
        assert [tile.qt for tile in plan] == list(range(len(plan) - 1, -1, -1))
        seen = []
        for tile in plan:
            assert tile.tok0 == tile.qt * bq and 1 <= tile.ntok <= bq
            assert len(tile.rows) == tile.ntok * g <= PREFILL_ROWS
            # row r is token tok0 + r // g, query head r % g of the group
            assert tile.rows == tuple((tile.tok0 + r // g, r % g) for r in range(len(tile.rows)))
            seen += tile.rows
        assert sorted(seen) == [(tok, j) for tok in range(t) for j in range(g)]
    # G = 7 (qwen2.5): 18 tokens, 126 rows, two spare rows per block
    assert (PREFILL_ROWS // 7, PREFILL_ROWS // 7 * 7) == (18, 126)


@pytest.mark.parametrize("g", GROUPS)
def test_plan_loads_only_the_causal_band(g):
    """The tiles a block loads hold exactly the keys its rows can see,
    rounded out to whole tiles: the kernel's work follows the causal
    triangle (and the window band), not T * T."""
    t, bk = 300, 64
    for window in WINDOWS:
        for tile in prefill_tile_plan(t, t, g, window, bk=bk):
            last = tile.tok0 + tile.ntok - 1
            lo = max(tile.tok0 - window + 1, 0) if window else 0
            assert [kt0 for kt0, _ in tile.kv_tiles] == list(range(lo // bk * bk, last + 1, bk))
