"""Paged KV cache: the device page pool, its plain writes, and the host-side
page allocator.

Layout, the same as the JAX package's so pools stay wire-compatible:
  k/v: [num_layers, num_pages, page_size, num_kv_heads, head_dim]
  page_table: [max_slots, max_pages_per_slot] int32 page ids (-1 = unmapped)
  lengths: [max_slots] int32 tokens stored per slot

Unlike the JAX package, writes update the pool tensors IN PLACE (torch has
no buffer donation; an in-place update is what donation bought there).
Every hazard — an inactive slot, a position past capacity, an unmapped
table entry — maps to the out-of-bounds sentinel page `num_pages`, and
sentinel rows are dropped.

An int8 pool (`QuantPages`, the engine's `kv_int8`) holds int8 values plus
one float32 scale per (layer, page, row). The all-layer writes quantize
each fresh row at the boundary and scatter values and scales with an
indexed assignment (no write kernel, as in the JAX package); reads
dequantize (`gather_kv`, and the ragged kernel's int8 leg).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable

import torch

from gridllm_torch.obs.metrics import default_registry
from gridllm_torch.utils.logging import get_logger

log = get_logger("kvcache")

# Which implementation each dispatch took (the JAX package's
# gridllm_kernel_dispatch_total, same name, help and labels): path "cuda"
# for a hand-written kernel of ops/cuda_kernels.py, "jnp" for the plain
# PyTorch version (a CPU tensor, an int8 pool's indexed writes, a tree past
# 32 nodes) — the label the JAX package gives its fallback, which the
# canary runbook's silent-fallback query reads. Counted once per distinct
# (op, path, shapes), as the JAX package counts once per trace, so a
# step pays a set lookup; cuda_kernels.launch_counts() stays the
# per-launch count.
_KERNEL_DISPATCH = default_registry().counter(
    "gridllm_kernel_dispatch_total",
    "Compiled programs by op and implementation path (pallas kernel vs "
    "jnp fallback). Counted per trace/compile, not per step.",
    ("op", "path"),
)
_dispatch_seen: set[tuple] = set()


def record_kernel_path(op: str, kernel: bool, shapes: tuple) -> None:
    """Count one dispatch of `op` by its path, once per distinct shapes."""
    key = (op, kernel, shapes)
    if key not in _dispatch_seen:
        _dispatch_seen.add(key)
        _KERNEL_DISPATCH.inc(op=op, path="cuda" if kernel else "jnp")


# Automatic prefix caching: page-granular reuse accounting (the JAX
# package's series): hits/misses in prompt pages at admission, evictions of
# cached pages for fresh allocations, copy-on-write rebuilds of a cached
# tail page.
_PREFIX_HITS = default_registry().counter(
    "gridllm_prefix_cache_hits_total",
    "Prompt pages served from the prefix cache (prefill skipped), by model.",
    ("model",),
)
_PREFIX_MISSES = default_registry().counter(
    "gridllm_prefix_cache_misses_total",
    "Prompt pages not found in the prefix cache (prefill paid), by model.",
    ("model",),
)
_PREFIX_EVICTIONS = default_registry().counter(
    "gridllm_prefix_cache_evictions_total",
    "Cached prefix pages evicted (LRU) to satisfy fresh allocations, "
    "by model.",
    ("model",),
)
_PREFIX_COW = default_registry().counter(
    "gridllm_prefix_cache_cow_copies_total",
    "Cached tail pages privately rebuilt because the request writes into "
    "them (copy-on-write of the partial tail page), by model.",
    ("model",),
)



def kernel_mesh_axis(mesh, kvh: int, h: int | None = None):
    """(mode, axis) for running the kernels under `mesh` (the JAX package's
    meshed dispatch). There a Pallas kernel sits inside a full-manual
    shard_map at its boundary; here each rank is a process with its own
    heads' pool, so a rank launches the same CUDA kernels on its shard and
    the wrappers read the head counts from the shapes they are given:

    - ("direct", None): no mesh;
    - ("wrap", "tp"): kv heads (and q heads) divide by tp — every rank
      holds KVH/tp kv heads and H/tp q heads (parallel/sharding.py splits
      attention the same way);
    - ("wrap", None): a mesh whose heads do not divide — every rank holds
      all the heads;
    - ("ref", None): pp > 1 (the pool's layer axis split), which this
      package refuses with pp itself (ROADMAP A 9).
    """
    if mesh is None:
        return "direct", None
    if mesh.shape.get("pp", 1) > 1:
        return "ref", None
    tp = mesh.shape.get("tp", 1)
    if tp > 1 and kvh % tp == 0 and (h is None or h % tp == 0):
        return "wrap", "tp"
    return "wrap", None


def local_kv_heads(kvh: int, mesh) -> int:
    """KV heads per rank: kvh/tp when tp splits the heads (the rule of
    kernel_mesh_axis), otherwise the full count (no mesh, or indivisible
    heads, which every rank keeps whole)."""
    if mesh is None:
        return kvh
    tp = mesh.shape.get("tp", 1)
    return kvh // tp if tp > 1 and kvh % tp == 0 else kvh

@dataclasses.dataclass
class QuantPages:
    """An int8 page pool with one float32 symmetric scale per (layer, page,
    row): a token row [KVH, D] is the quantization granule, so decode and
    verify writes quantize independently and never re-scale a page. It
    stands where `PagedKVCache.k`/`.v` would hold a tensor; the model passes
    it through, the write dispatchers quantize, the reads dequantize."""

    data: torch.Tensor   # int8 [L, P, ps, KVH, D] (or one layer: 4-dim)
    scale: torch.Tensor  # float32 [L, P, ps]     (or one layer: [P, ps])

    @staticmethod
    def zeros(shape: tuple[int, ...], device: torch.device | str) -> "QuantPages":
        """An empty pool: values 0 and scales 1.0, so unwritten rows
        dequantize to exact zeros."""
        return QuantPages(torch.zeros(shape, dtype=torch.int8, device=device),
                          torch.ones(shape[:-2], dtype=torch.float32, device=device))

    @property
    def shape(self) -> torch.Size:
        return self.data.shape

    def dim(self) -> int:
        return self.data.dim()

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        return self.data.nbytes + self.scale.nbytes

    def layer(self, li: int) -> "QuantPages":
        """One layer's pool (views, no copy)."""
        return QuantPages(self.data[li], self.scale[li])

    def take(self, rows: torch.Tensor) -> torch.Tensor:
        """Dequantized float32 pages gathered along the page axis of a
        single-layer (4-dim) pool: data[rows] * scale[rows] broadcast over
        each row's [KVH, D]."""
        rows = rows.long()
        return self.data[rows].float() * self.scale[rows][..., None, None]


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of fresh K/V: x [..., KVH, D] →
    (int8 values, float32 scales [...]). A row's scale is amax / 127 (an
    all-zero row keeps 1.0); values are x / scale rounded half to even and
    clamped to ±127, bit-identical to the JAX package's."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor | QuantPages  # [L, P, page_size, KVH, D]
    v: torch.Tensor | QuantPages  # [L, P, page_size, KVH, D]
    page_table: torch.Tensor  # [S, max_pages] int32
    lengths: torch.Tensor     # [S] int32
    page_size: int = 128

    @staticmethod
    def create(
        num_layers: int,
        num_pages: int,
        page_size: int,
        num_kv_heads: int,
        head_dim: int,
        max_slots: int,
        max_pages_per_slot: int,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cuda",
        kv_int8: bool = False,
    ) -> "PagedKVCache":
        """An empty pool of `dtype`, or with `kv_int8` an int8 `QuantPages`
        pool (the compute dtype then stays the model's)."""
        shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)

        def pool():
            if kv_int8:
                return QuantPages.zeros(shape, device)
            return torch.zeros(shape, dtype=dtype, device=device)

        return PagedKVCache(
            k=pool(),
            v=pool(),
            page_table=torch.full((max_slots, max_pages_per_slot), -1,
                                  dtype=torch.int32, device=device),
            lengths=torch.zeros((max_slots,), dtype=torch.int32, device=device),
            page_size=page_size,
        )

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def max_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_context(self) -> int:
        return self.page_table.shape[1] * self.page_size


def _safe_page_idx(
    lookup: Callable[[torch.Tensor], torch.Tensor],
    positions: torch.Tensor,
    valid: torch.Tensor,
    page_size: int,
    max_pages: int,
    num_pages: int,
) -> torch.Tensor:
    """Page index for each write position, with every hazard masked to the
    out-of-bounds sentinel `num_pages`: invalid positions (the caller's
    `valid` mask), positions past the table's capacity, and unmapped (-1)
    table entries. `lookup(page_no)` maps in-range page numbers to ids."""
    in_cap = positions < max_pages * page_size
    mapped = lookup(torch.clamp(positions // page_size, max=max_pages - 1))
    sentinel = torch.full_like(mapped, num_pages)
    return torch.where(valid & in_cap & (mapped >= 0), mapped, sentinel)


def _scatter_rows(pages: torch.Tensor, new: torch.Tensor,
                  page_idx: torch.Tensor, offset: torch.Tensor) -> None:
    """pages[..., page_idx[i], offset[i]] = new[..., i] in place, dropping
    rows whose page is the sentinel. `pages` is one layer's pool
    [P, ps, KVH, D] or the full stack [L, P, ps, KVH, D], with `new` shaped
    [N, KVH, D] or [L, N, KVH, D] to match."""
    keep = page_idx < pages.shape[-4]
    idx, off = page_idx[keep].long(), offset[keep].long()
    if pages.dim() == 5:
        pages[:, idx, off] = new[:, keep].to(pages.dtype)
    else:
        pages[idx, off] = new[keep].to(pages.dtype)


def _scatter_quant(pages: QuantPages, new: torch.Tensor, page_idx: torch.Tensor,
                   offset: torch.Tensor) -> None:
    """Quantize rows new [L, N, KVH, D] and write values and scales into
    the full int8 pool at (page_idx[i], offset[i]) in place, dropping rows
    whose page is the sentinel. No host sync (a masked select would need
    one): a dropped row repeats the first kept row's write, an identical
    duplicate, or, when no row is kept, rewrites pool row 0 with what it
    holds."""
    n_layers, num_pages, ps = pages.scale.shape
    data = pages.data.view(n_layers, num_pages * ps, *pages.data.shape[3:])
    scale = pages.scale.view(n_layers, num_pages * ps)
    q, sc = quantize_kv_rows(new)
    keep = page_idx < num_pages
    if not keep.numel():
        return
    any_keep = keep.any()
    rows = torch.arange(keep.shape[0], device=keep.device)
    src = torch.where(keep, rows, torch.argmax(keep.to(torch.uint8)))
    dst = torch.where(any_keep, page_idx.long()[src] * ps + offset.long()[src], 0)
    q = torch.where(any_keep, q[:, src], data[:, :1])
    sc = torch.where(any_keep, sc[:, src], scale[:, :1])
    data[:, dst] = q
    scale[:, dst] = sc


def _refuse_quant(pages, what: str) -> None:
    if isinstance(pages, QuantPages):
        raise TypeError(f"{what}: int8 KV pools are written through the all-layer "
                        "writes only")


def _prefill_dest(table_row: torch.Tensor, start: int, length: int, n_rows: int,
                  page_size: int, num_pages: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(page index, offset) of one slot's rows at start + [0, n_rows); rows
    at index >= length go to the sentinel."""
    t = torch.arange(n_rows, dtype=torch.int32, device=device)
    pos = start + t
    table_row = table_row.to(device)
    page_idx = _safe_page_idx(lambda p: table_row[p.long()], pos, t < length, page_size,
                              table_row.shape[0], num_pages)
    return page_idx, pos % page_size


def _decode_dest(page_table: torch.Tensor, positions: torch.Tensor, active: torch.Tensor,
                 page_size: int, num_pages: int,
                 rows_per_slot: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(page index, offset) of rows_per_slot rows per slot at `positions`
    [S * rows_per_slot]; an inactive slot's rows go to the sentinel."""
    slot_of = torch.arange(page_table.shape[0], device=page_table.device)
    if rows_per_slot > 1:
        slot_of = slot_of.repeat_interleave(rows_per_slot)
        active = active.repeat_interleave(rows_per_slot)
    page_idx = _safe_page_idx(lambda p: page_table[slot_of, p.long()], positions, active,
                              page_size, page_table.shape[1], num_pages)
    return page_idx, positions % page_size


def _write_rows(k_pages, v_pages, k_new: torch.Tensor, v_new: torch.Tensor,
                dest: tuple[torch.Tensor, torch.Tensor]):
    """Scatter K and V rows to `dest` (page index, offset) in place: an int8
    pool quantizes them. Returns the pools."""
    scatter = _scatter_quant if isinstance(k_pages, QuantPages) else _scatter_rows
    scatter(k_pages, k_new, *dest)
    scatter(v_pages, v_new, *dest)
    return k_pages, v_pages


def write_prefill(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    table_row: torch.Tensor,
    start: int,
    length: int,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a prefill chunk for ONE slot into the pool, in place.

    k_pages/v_pages: one layer's pool [P, ps, KVH, D] with k_new/v_new
    [T, KVH, D], or the full pool [L, P, ps, KVH, D] with [L, T, KVH, D].
    table_row: [max_pages] page ids for this slot. start: absolute position
    of row 0; rows at index >= length are dropped (bucket padding). This is
    the plain version of the `paged_write_chunk` kernel. Returns the pools.
    An int8 pool raises TypeError, as in the JAX package.
    """
    _refuse_quant(k_pages, "write_prefill")
    return _write_rows(k_pages, v_pages, k_new, v_new, _prefill_dest(
        table_row, start, length, k_new.shape[-3], page_size, k_pages.shape[-4], k_new.device))


def write_decode(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    active: torch.Tensor,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one new token per slot into the pool, in place.

    k_pages/v_pages: [P, ps, KVH, D] with k_new/v_new [S, KVH, D], or the
    full pool [L, P, ps, KVH, D] with [L, S, KVH, D]. positions: [S]
    absolute write position per slot; active: [S] bool — inactive slots
    are dropped. The plain version of the `paged_write_decode` kernel.
    Returns the pools. An int8 pool raises TypeError, as in the JAX
    package."""
    _refuse_quant(k_pages, "write_decode")
    return _write_rows(k_pages, v_pages, k_new, v_new, _decode_dest(
        page_table, positions, active, page_size, k_pages.shape[-4]))


def write_decode_all(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    active: torch.Tensor,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one token per slot across ALL layers at once (once per decode
    step): k_pages/v_pages [L, P, ps, KVH, D], k_new/v_new [L, S, KVH, D].
    Runs the `paged_write_decode` kernel on CUDA tensors; an int8 pool
    quantizes the rows and scatters values and scales instead."""
    from gridllm_torch.ops.cuda_kernels import paged_write_decode

    quant = isinstance(k_pages, QuantPages)
    record_kernel_path("write_decode", not quant and k_new.is_cuda, k_new.shape)
    if quant:
        return _write_rows(k_pages, v_pages, k_new, v_new, _decode_dest(
            page_table, positions, active, page_size, k_pages.shape[1]))
    return paged_write_decode(k_pages, v_pages, k_new, v_new, page_table,
                              positions, active, page_size)


def write_multi_all(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    active: torch.Tensor,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write T consecutive tokens per slot across ALL layers at once (the
    speculative-verify KV write): k_pages/v_pages [L, P, ps, KVH, D],
    k_new/v_new [L, S, T, KVH, D], positions [S, T], active [S] (inactive
    slots drop entirely; past-capacity positions and unmapped pages drop
    as in write_decode_all). The write is optimistic: rejected rows are
    dropped afterwards by rollback_to_length. The (slot, candidate) pairs
    flatten to S*T rows of the `paged_write_decode` kernel, T per slot; an
    int8 pool quantizes the flattened rows and scatters values and scales."""
    from gridllm_torch.ops.cuda_kernels import paged_write_decode

    n_layers, s, t = k_new.shape[:3]
    k_flat = k_new.reshape(n_layers, s * t, *k_new.shape[3:])
    v_flat = v_new.reshape(n_layers, s * t, *v_new.shape[3:])
    quant = isinstance(k_pages, QuantPages)
    record_kernel_path("write_multi", not quant and k_new.is_cuda, k_new.shape)
    if quant:
        return _write_rows(k_pages, v_pages, k_flat, v_flat, _decode_dest(
            page_table, positions.reshape(-1), active, page_size, k_pages.shape[1],
            rows_per_slot=t))
    return paged_write_decode(k_pages, v_pages, k_flat, v_flat, page_table,
                              positions.reshape(-1), active, page_size, rows_per_slot=t)


def rollback_to_length(cache: PagedKVCache, new_lengths: torch.Tensor) -> PagedKVCache:
    """Commit each slot's accepted length after a verify step's optimistic
    write, in place: rows past `new_lengths` become invisible (attention
    masks keys at >= length) and the next step overwrites them. Pure
    length bookkeeping: no pool byte moves, so a refcount-shared prefix
    page (always below the prompt length) is never touched."""
    cache.lengths.copy_(new_lengths)
    return cache


def commit_tree_path(cache: PagedKVCache, path: torch.Tensor,
                     active: torch.Tensor) -> PagedKVCache:
    """Compact the accepted root-to-leaf path of a tree-verify step into
    contiguous KV rows, in place.

    A tree verify writes node i's K/V optimistically at storage position
    lengths + i, but node i's logical position is lengths + depth[i], so a
    rejected sibling leaves a hole between accepted rows. `path[s, j]`
    ([S, N]) names the tree node whose row backs committed position
    lengths[s] + 1 + j (0 = no row: the final corrected or bonus token, or
    past n_emit; spec_accept_tree's contract). This copies row lengths +
    path[s, j] over row lengths + 1 + j for every path[s, j] > 0 that moves,
    on every layer, and leaves lengths alone (the caller rolls them forward
    with rollback_to_length, as after a chain verify). The JAX package's
    commit_tree_path, row for row.

    - Every source row is gathered (a copy) before any row is written, so
      overlapping rows are safe (topological order gives src >= dst).
    - Rows at or below lengths are never written: destinations start at
      lengths + 1, strictly past any prefix-cache page a slot shares.
    - An int8 pool (`QuantPages`) moves the int8 values and the float32
      scale of each row verbatim: requantizing would recompute the scale.
    - A row that must not move (inactive slot, no move, a destination past
      the table's capacity or on an unmapped page) repeats the first moving
      row's write, an identical duplicate, or, when no row moves, rewrites
      pool row 0 with what it holds: the JAX package drops such rows, and
      a masked select would cost a host sync."""
    s, n = path.shape
    ps = cache.page_size
    table = cache.page_table
    max_pages = table.shape[1]
    dev = path.device
    j = torch.arange(n, device=dev)[None, :]
    path = path.to(torch.int64)
    lengths = cache.lengths.to(torch.int64)[:, None]
    do = (active.to(dev)[:, None] & (path > 0) & (path != j + 1)).reshape(-1)
    src_pos = (lengths + path).reshape(-1)
    dst_pos = (lengths + 1 + j).reshape(-1)
    slot_of = torch.arange(s, device=dev).repeat_interleave(n)
    num_pages = cache.k.shape[1]
    # sources: clamped into the table and the pool (a hazardous read is
    # junk that no kept row writes)
    src_page = table[slot_of, torch.clamp(src_pos // ps, 0, max_pages - 1)].long()
    src = torch.clamp(src_page, 0, num_pages - 1) * ps + src_pos % ps
    dst_page = _safe_page_idx(lambda p: table[slot_of, p.long()], dst_pos, do, ps,
                              max_pages, num_pages).long()
    keep = dst_page < num_pages
    any_keep = keep.any()
    first = torch.argmax(keep.to(torch.uint8))
    rows = torch.where(keep, torch.arange(keep.shape[0], device=dev), first)
    dst = torch.where(any_keep, dst_page[rows] * ps + dst_pos[rows] % ps, 0)
    src = torch.where(any_keep, src[rows], 0)

    def move(pages):
        if isinstance(pages, QuantPages):
            for t in (pages.data, pages.scale):
                flat = t.view(t.shape[0], num_pages * ps, *t.shape[3:])
                flat[:, dst] = flat[:, src]
            return
        flat = pages.view(pages.shape[0], num_pages * ps, *pages.shape[3:])
        flat[:, dst] = flat[:, src]

    move(cache.k)
    move(cache.v)
    return cache


def write_prefill_all(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    table_row: torch.Tensor,
    start: int,
    length: int,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a prefill chunk for ONE slot across ALL layers at once:
    k_pages/v_pages [L, P, ps, KVH, D], k_new/v_new [L, T, KVH, D] with
    T % page_size == 0 and a page-aligned `start`. Runs the
    `paged_write_chunk` kernel on CUDA tensors, which also writes the
    padded tail of the last page (never read: attention masks by length).
    An int8 pool quantizes rows [0, length) and scatters values and scales.
    """
    from gridllm_torch.ops.cuda_kernels import paged_write_chunk

    quant = isinstance(k_pages, QuantPages)
    record_kernel_path("write_prefill", not quant and k_new.is_cuda, k_new.shape)
    if quant:
        return _write_rows(k_pages, v_pages, k_new, v_new, _prefill_dest(
            table_row, start, length, k_new.shape[1], page_size, k_pages.shape[1],
            k_new.device))
    return paged_write_chunk(k_pages, v_pages, k_new, v_new, table_row,
                             start, length, page_size)


def gather_kv(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    table_row: torch.Tensor,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize one slot's K/V [max_pages*page_size, KVH, D] from one
    layer's pool [P, ps, KVH, D] (plain version; the kernels read pages in
    place instead). Unmapped entries read page 0 — callers mask them. An
    int8 pool dequantizes here: float32 out."""
    rows = table_row.clamp(min=0).long()
    kvh, d = k_pages.shape[-2], k_pages.shape[-1]
    n = table_row.shape[0] * page_size
    if isinstance(k_pages, QuantPages):
        return k_pages.take(rows).reshape(n, kvh, d), v_pages.take(rows).reshape(n, kvh, d)
    return k_pages[rows].reshape(n, kvh, d), v_pages[rows].reshape(n, kvh, d)


def _page_chain_key(parent: bytes, tokens: list[int]) -> bytes:
    """Content address of one FULL page given its prefix: the hash chain
    hash(parent_hash, page_token_ids), byte-identical to the JAX package's
    so both serve the same cache keys."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(b" ".join(b"%d" % t for t in tokens))
    return h.digest()


class PageAllocator:
    """Host-side ref-counted page allocator (plain Python).

    Owns which pages back which slot; the device only sees the resulting
    int32 tables. Pages holding FULL pages of a completed request's context
    are content-addressed by a hash chain and, once their refcount drops to
    zero, parked in an LRU of reusable pages instead of the free list. A new
    request matches its longest cached prefix page by page and shares those
    pages; fresh allocations evict from the LRU only when the free list is
    empty. `cache_pages` bounds the LRU (0 disables caching; negative is
    unbounded). Same state machine as the JAX package's allocator, so both
    produce the same page tables from the same operations.
    """

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_slot: int, cache_pages: int = 0,
                 model: str | None = None):
        self.model = model or "unknown"   # the prefix-cache series' label
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.cache_pages = cache_pages
        # host KV tier hooks the engine installs: spill_sink(page, chain_key)
        # fires right before a REGISTERED page is evicted from the reuse LRU
        # (the engine copies it to host memory); restore_source(chain_key)
        # is consulted by match_prefix on a chain miss and returns a freshly
        # installed, registered, refcount-0 page id (or None). Both run
        # under the engine's _alloc_lock, which every allocator mutation
        # holds, so they may call back into claim_page / register_claimed /
        # unpin_pages (an RLock)
        self.spill_sink: Callable[[int, bytes], None] | None = None
        self.restore_source: Callable[[bytes], int | None] | None = None
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._owned: dict[int, list[int]] = {}
        self._refs: dict[int, int] = {}           # page → owners (≥ 1)
        self._key_of: dict[int, bytes] = {}       # page → registered chain key
        self._page_by_key: dict[bytes, int] = {}  # chain key → page
        self._lru: OrderedDict[int, None] = OrderedDict()  # ref-0 cached pages
        # match accounting staged by match_prefix, committed by alloc(): a
        # pool-exhausted admission retries and must not count twice
        self._staged_stats: dict[int, tuple[int, int, bool]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.cow_copies = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        return len(self._lru)

    @property
    def reclaimable_pages(self) -> int:
        return len(self._free) + len(self._lru)

    def pages_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def fits_slot_cap(self, num_tokens: int) -> bool:
        return self.pages_for(num_tokens) <= self.max_pages_per_slot

    def _take_page(self) -> int | None:
        if self._free:
            return self._free.pop()
        if self._lru:  # evict the least-recently-released cached page
            page, _ = self._lru.popitem(last=False)
            self._spill(page)
            self._drop_key(page)
            self.evictions += 1
            _PREFIX_EVICTIONS.inc(model=self.model)
            return page
        return None

    def _spill(self, page: int) -> None:
        """Offer an about-to-be-evicted registered page to the host tier
        (no-op without a sink). A sink failure loses the page from the tier
        (the later match is a miss), never the eviction."""
        sink = self.spill_sink
        key = self._key_of.get(page)
        if sink is None or key is None:
            return
        try:
            sink(page, key)
        except Exception as e:  # noqa: BLE001 — spill is best-effort
            log.warning("host-tier spill failed; page content lost from tier",
                        model=self.model, page=page, error=str(e))

    def _drop_key(self, page: int) -> None:
        key = self._key_of.pop(page, None)
        if key is not None and self._page_by_key.get(key) == page:
            del self._page_by_key[key]

    def match_prefix(self, slot: int, token_ids: list[int]) -> int:
        """Pin the longest cached prefix of `token_ids` to a FRESH slot and
        return the number of cached TOKENS (a multiple of page_size). The
        match stops at the last page boundary strictly below the prompt's
        end: the final token must run through the model for its logits."""
        if self.cache_pages == 0:
            return 0
        owned = self._owned.setdefault(slot, [])
        if owned:
            return 0
        ps = self.page_size
        max_full = min((len(token_ids) - 1) // ps, self.max_pages_per_slot)
        key = b""
        matched = 0
        cow = False
        for i in range(max_full):
            key = _page_chain_key(key, token_ids[i * ps:(i + 1) * ps])
            page = self._page_by_key.get(key)
            if page is None and self.restore_source is not None:
                # the chain misses on the device but the host tier may hold
                # the spilled page: the engine pages it back in (claim,
                # write, register) and the walk goes on
                try:
                    page = self.restore_source(key)
                except Exception as e:  # noqa: BLE001 — degrade to cold
                    log.warning("host-tier restore failed; cold prefill",
                                model=self.model, error=str(e))
                    page = None
            if page is None:
                break
            self._lru.pop(page, None)
            self._refs[page] = self._refs.get(page, 0) + 1
            owned.append(page)
            matched += 1
        else:
            # whole cap matched: if the next full page is cached too, the
            # request rebuilds that page privately (copy-on-write)
            if (max_full + 1) * ps <= len(token_ids):
                tail_key = _page_chain_key(
                    key, token_ids[max_full * ps:(max_full + 1) * ps])
                cow = tail_key in self._page_by_key
        self._staged_stats[slot] = (matched, self.pages_for(len(token_ids)), cow)
        return matched * ps

    def _commit_match_stats(self, slot: int) -> None:
        staged = self._staged_stats.pop(slot, None)
        if staged is None:
            return
        matched, prompt_pages, cow = staged
        self.hits += matched
        self.misses += prompt_pages - matched
        if matched:
            _PREFIX_HITS.inc(matched, model=self.model)
        if prompt_pages - matched:
            _PREFIX_MISSES.inc(prompt_pages - matched, model=self.model)
        if cow:
            self.cow_copies += 1
            _PREFIX_COW.inc(model=self.model)

    def alloc(self, slot: int, num_tokens: int) -> list[int] | None:
        """Ensure `slot` owns pages for `num_tokens` tokens. Returns the
        slot's page list, or None when the pool is exhausted."""
        owned = self._owned.setdefault(slot, [])
        need = self.pages_for(num_tokens) - len(owned)
        if need > self.reclaimable_pages:
            return None
        if need > self.max_pages_per_slot - len(owned):
            return None
        for _ in range(max(0, need)):
            page = self._take_page()
            if page is None:  # guarded by the reclaimable check above
                raise RuntimeError("page pool accounting out of sync")
            self._refs[page] = 1
            owned.append(page)
        self._commit_match_stats(slot)
        return owned

    def free(self, slot: int, token_ids: list[int] | None = None) -> None:
        """Release a slot's pages. With `token_ids` (the request's final
        context, KV fully written), full pages are first registered under
        their chain keys so later requests can match them."""
        self._staged_stats.pop(slot, None)
        owned = self._owned.pop(slot, [])
        if token_ids is not None and self.cache_pages != 0:
            n_full = min(len(token_ids) // self.page_size, len(owned))
            key = b""
            for i in range(n_full):
                key = _page_chain_key(
                    key, token_ids[i * self.page_size:(i + 1) * self.page_size])
                page = owned[i]
                if self._page_by_key.get(key) is None and page not in self._key_of:
                    # first holder of this content wins; duplicates stay
                    # unregistered and return to the free list
                    self._page_by_key[key] = page
                    self._key_of[page] = key
        for page in owned:
            self._release_page(page)

    def _release_page(self, page: int) -> None:
        refs = self._refs.get(page, 1) - 1
        if refs > 0:
            self._refs[page] = refs
            return
        self._refs.pop(page, None)
        if page in self._key_of:
            self._lru[page] = None  # most recently released
            cap = self.cache_pages
            while cap > 0 and len(self._lru) > cap:
                old, _ = self._lru.popitem(last=False)
                self._spill(old)
                self._drop_key(old)
                self.evictions += 1
                _PREFIX_EVICTIONS.inc(model=self.model)
                self._free.append(old)
        else:
            self._free.append(page)

    def evict_cached(self, pages: list[int]) -> int:
        """Force refcount-0 cached pages back to the free list WITHOUT the
        spill hook (the engine's park_to_host has copied them to the host
        tier already). Pages still pinned by a live request are left alone:
        a shared page is never freed mid-decode. Returns pages dropped."""
        n = 0
        for page in pages:
            if page in self._lru:
                self._lru.pop(page)
                self._drop_key(page)
                self._free.append(page)
                n += 1
        return n

    def chain_keys(self, token_ids: list[int],
                   n_pages: int | None = None) -> list[bytes]:
        """Chain keys for the first `n_pages` FULL pages of token_ids
        (default: one page below the prompt's end, as match_prefix caps)."""
        ps = self.page_size
        cap = (len(token_ids) - 1) // ps if n_pages is None else n_pages
        cap = min(cap, len(token_ids) // ps)
        keys: list[bytes] = []
        key = b""
        for i in range(cap):
            key = _page_chain_key(key, token_ids[i * ps:(i + 1) * ps])
            keys.append(key)
        return keys

    def pin_prefix(self, token_ids: list[int]) -> tuple[list[int], int]:
        """Bump refcounts on the cached pages covering token_ids' longest
        full-page prefix (no slot involved). Returns (pages, tokens
        covered); release with unpin_pages."""
        pages: list[int] = []
        if self.cache_pages == 0:
            return pages, 0
        for key in self.chain_keys(token_ids):
            page = self._page_by_key.get(key)
            if page is None:
                break
            self._lru.pop(page, None)
            self._refs[page] = self._refs.get(page, 0) + 1
            pages.append(page)
        return pages, len(pages) * self.page_size

    def unpin_pages(self, pages: list[int]) -> None:
        for page in pages:
            self._release_page(page)

    def peek_key(self, key: bytes) -> int | None:
        """The page cached under `key`, if any (no state change)."""
        return self._page_by_key.get(key)

    def claim_page(self) -> int | None:
        """Take a pool page for content written from outside (a migration
        import, a host-tier restore), PINNED at refcount 1 and deliberately
        UNREGISTERED: its chain key must not become matchable before its
        data is written (an admission matching an unwritten page would
        decode over garbage). Callers write the data, then
        register_claimed() and unpin_pages(). None when nothing is
        reclaimable or the prefix cache is off."""
        if self.cache_pages == 0:
            return None
        page = self._take_page()
        if page is None:
            return None
        self._refs[page] = 1
        return page

    def register_claimed(self, page: int, key: bytes) -> None:
        """Publish a claimed page under its chain key AFTER its data was
        written. If another page registered the same content first, that
        one wins and this page stays unregistered (it returns to the free
        list on unpin, the duplicate rule of free())."""
        if key in self._page_by_key or page in self._key_of:
            return
        self._page_by_key[key] = page
        self._key_of[page] = key

    def table_row(self, slot: int) -> list[int]:
        owned = self._owned.get(slot, [])
        return owned + [-1] * (self.max_pages_per_slot - len(owned))
