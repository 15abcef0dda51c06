"""Python wrappers of the hand-written CUDA kernels, with launch counters.

Each wrapper takes the same arguments as its kernel's plain PyTorch version
and dispatches on where the tensors lie:
- CPU tensors run the plain version (that is how the CPU tests reach the
  kernels' arithmetic);
- CUDA tensors launch the kernel on the current stream — after checking
  device, dtype (float32 or bfloat16), shapes, contiguity and 16-byte
  alignment — or raise. There is no fallback from CUDA to the plain path.

`LAUNCHES` counts successful launches per kernel (never the CPU path), so
a run can prove that its main path went through the kernels; `LEG_LAUNCHES`
counts, beside them, the launches of one leg of a kernel: for
ragged_attention the int8 pool leg and the tree-verify leg (one launch may
take both), and its regions: "chunk" (the chunk region on the tensor
cores, a launch of its own, for bf16 q on a bf16 or an int8 pool),
"chunk_cores" (the chunk region on the CUDA cores, for float32 q or a page
size that does not hold whole 8-row boxes) and
"group" (the group region, split over pages); for prefix_chunk its routes:
"chunk" (tensor cores), "chunk_cores" and "slots" (the per-phase verify,
all slots in one launch).

Kernels (gridllm_torch/csrc/), the TPU kernels they replace
(gridllm_tpu/ops/pallas_kernels.py) and their plain versions:
- flash_prefill       :129  → ops.attention.attention_prefill_ref
- flash_prefill_streamed :268 → ops.attention.attention_prefill_blocked_ref
  (both wrappers launch the one kernel of csrc/flash_prefill.cu, whose
  tile plan `prefill_tile_plan` gives in Python)
- paged_decode        :479  → ops.attention.paged_attention_decode_ref
- prefix_chunk        :739  → ops.attention._prefix_chunk_ref (one chunk),
  ops.attention.paged_attention_verify_ref (`prefix_chunk_slots`)
- ragged_attention    :1168 → ops.attention.ragged_paged_attention_ref
  (index math of its two kernel bodies in Python, which paged_decode and
  prefix_chunk launch too (csrc/attention_bodies.cuh):
  `ragged_chunk_tile_plan`, `ragged_split_count`, `ragged_split_plan`,
  `ragged_split_merge_ref`)
- paged_write_decode  :1404 → ops.kvcache.write_decode
- paged_write_chunk   :1497 → ops.kvcache.write_prefill
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from gridllm_torch.ops import _build
from gridllm_torch.ops.attention import (
    _layer_pool,
    _prefix_chunk_ref,
    attention_prefill_blocked_ref,
    attention_prefill_ref,
    paged_attention_decode_ref,
    paged_attention_verify_ref,
    ragged_paged_attention_ref,
)
from gridllm_torch.ops.kvcache import QuantPages, write_decode, write_prefill

LAUNCHES: dict[str, int] = {
    "flash_prefill": 0,
    "flash_prefill_streamed": 0,
    "paged_decode": 0,
    "prefix_chunk": 0,
    "ragged_attention": 0,
    "paged_write_decode": 0,
    "paged_write_chunk": 0,
}
# launches of one leg of a kernel, also counted in LAUNCHES[kernel]
LEG_LAUNCHES: dict[str, int] = {
    "ragged_attention.int8": 0,
    "ragged_attention.tree": 0,
    "ragged_attention.chunk": 0,
    "ragged_attention.chunk_cores": 0,
    "ragged_attention.group": 0,
    "prefix_chunk.chunk": 0,
    "prefix_chunk.chunk_cores": 0,
    "prefix_chunk.slots": 0,
}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LEG_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict[str, int]:
    return {**LAUNCHES, **LEG_LAUNCHES}


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_GROUPS_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P,       # q, pools, k/v_cur, out, table, lengths
                _I, _I, _I, _I, _I, _I,               # S, Td, n_table, P, ps, layer
                _I, _P, _P, _P,                       # n_splits, partials, counters
                _I, _I, _I, _I, _I, _F, _F, _I, _P]   # H, KVH, D, rpw, dtype, ..., stream
_SIGNATURES: dict[str, tuple[str, list]] = {
    "gridllm_paged_write_decode": (
        "paged_write.cu", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _P]),
    "gridllm_paged_write_chunk": (
        "paged_write.cu", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P]),
    "gridllm_flash_prefill": (
        "flash_prefill.cu",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]),
    "gridllm_paged_decode": ("per_phase_attention.cu", _GROUPS_ARGS),
    "gridllm_prefix_chunk_slots": ("per_phase_attention.cu", _GROUPS_ARGS),
    "gridllm_prefix_chunk": (
        "per_phase_attention.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P,      # q, pools, k/v_cur, out, row, start, total
         _I, _I, _I, _I, _I, _I,                  # n_table, P, ps, layer, C, bq
         _I, _I, _I, _I, _I,                      # H, KVH, D, rpw, dtype
         _F, _F, _I, _P]),                        # scale, softcap, window, stream
    "gridllm_prefix_chunk_wgmma": (
        "per_phase_attention.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P,      # pool maps, q, k/v_cur, out, row, start, total
         _I, _I, _I, _I, _I, _I,                  # n_table, P, L * P, ps, box_rows, layer
         _I, _I, _I, _I, _I,                      # C, bq, H, KVH, D
         _F, _F, _I, _P]),                        # scale, softcap, window, stream
    "gridllm_ragged_attention": (
        "ragged_attention.cu",
        [_P, _P, _P, _P, _I, _I, _I,              # pools, scales, P, ps, layer
         _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,  # chunk region
         _P, _P, _P, _P, _P, _P, _I, _I, _I,      # group region
         _I, _P, _P, _P,                          # n_splits, partials, counters
         _I, _I, _I, _I, _I, _F, _F, _I,          # H, KVH, D, rpw, dtype, ...
         _I, _P, _P, _P]),                        # tree_n, tree_pos, tree_bits, stream
    "gridllm_ragged_pool_map": ("ragged_attention.cu", [_P, _LL, _I, _I, _I, _I, _I, _P]),
    "gridllm_ragged_chunk": (
        "ragged_attention.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P,      # pool maps, q, k/v_chunk, out, row, scales
         _I, _I, _I, _I, _I, _I,                  # n_table, P, L * P, ps, box_rows, layer
         _I, _I, _I, _I, _I, _I, _I,              # C, bq, start, total, H, KVH, D
         _F, _F, _I, _P]),                        # scale, softcap, window, stream
    "gridllm_error_string": ("paged_write.cu", [_I]),
}
_fns: dict[str, Any] = {}
_fns_lock = threading.Lock()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_MAX_ROWS = 32  # query rows one block holds: kWarps (4) x RPW (<= 8)
MAX_TREE_NODES = 32  # the tree leg's int32 ancestor bitmask per node
PREFILL_ROWS = 128  # hopper_common.cuh: query rows per block, two m64 slabs
PREFILL_BK = 128    # hopper_common.cuh: keys per K/V tile (bf16) at D 64 and 128
# codes of the TMA kernels' entry points beside cudaError_t values
_PREFILL_ERRORS = {-1: "cuTensorMapEncodeTiled not found in libcuda.so.1",
                   -2: "the driver refused a TMA tensor map",
                   -3: "the chunk kernel's shared memory (its staged table row) passes "
                       "the card's per-block limit"}


def prefill_bk(d: int) -> int:
    """Keys per K/V tile of the tensor-core kernels at head dim `d`
    (hopper_common.cuh `tile_keys`): PREFILL_BK, and 64 at D = 256, where Q
    (64 KB) and two stages of 128 keys (256 KB) would pass a block's shared
    memory. Every host plan of those kernels takes its tile from here."""
    return 64 if d == 256 else PREFILL_BK


def _fn(name: str):
    with _fns_lock:
        fn = _fns.get(name)
        if fn is None:
            source, argtypes = _SIGNATURES[name]
            fn = getattr(_build.load(source), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "gridllm_error_string" else ctypes.c_int
            _fns[name] = fn
        return fn


def _launch(name: str, kernel: str, *args, legs: tuple[str, ...] = ()) -> None:
    err = _fn(name)(*args)
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
    for leg in legs:
        LEG_LAUNCHES[f"{kernel}.{leg}"] += 1


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = _PREFILL_ERRORS.get(err) or _fn("gridllm_error_string")(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({err})")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(kernel: str, name: str, t: torch.Tensor, device: torch.device,
           shape: tuple | None = None, dtype: torch.dtype | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def _float_dtype(kernel: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{kernel}: dtype {t.dtype} not supported (float32, bfloat16)")
    return _DTYPES[t.dtype]


def _rows_per_warp(rows: int, d: int = 128) -> int:
    """Smallest compiled rows-per-warp whose 4 warps hold `rows` (<= 32),
    at most 4 at D = 256: 8 rows a warp there need more than 255 registers
    (the compiler spilled 240 bytes a thread in bf16) and are not compiled
    (attention_bodies.cuh `kMaxRpw`); more rows take more passes."""
    cap = 4 if d == 256 else 8
    for rpw in (1, 2, 4, 8):
        if rpw == cap or 4 * rpw >= min(rows, _MAX_ROWS):
            return rpw
    return cap


def _kv_heads_and_dim(kernel: str, k_pages: torch.Tensor) -> tuple[int, int]:
    kvh, d = k_pages.shape[-2], k_pages.shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {d} not compiled (have {_HEAD_DIMS})")
    return kvh, d


def _full_pool(kernel: str, k_pages, v_pages, page_size: int, layer):
    """Pools as [L, P, ps, KVH, D] plus the layer to read, checked."""
    if k_pages.dim() == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
    n_layers, _, ps, _, _ = k_pages.shape
    layer = 0 if layer is None else int(layer)
    if ps != page_size or not 0 <= layer < n_layers:
        raise ValueError(f"{kernel}: page size {ps} vs {page_size}, layer {layer}")
    _check(kernel, "k_pages", k_pages, k_pages.device)
    _check(kernel, "v_pages", v_pages, k_pages.device, k_pages.shape, k_pages.dtype)
    return k_pages, v_pages, layer


def _gqa(kernel: str, h: int, kvh: int) -> int:
    if h % kvh or h // kvh > _MAX_ROWS:
        raise ValueError(f"{kernel}: {h} query heads over {kvh} kv heads")
    return h // kvh


# ---------------------------------------------------------------------------
# KV writes
# ---------------------------------------------------------------------------


def paged_write_decode(k_pages, v_pages, k_new, v_new, page_table, positions,
                       active, page_size: int, rows_per_slot: int = 1):
    """`write_decode` on the full pool: k_pages/v_pages [L, P, ps, KVH, D],
    k_new/v_new [L, S * T, KVH, D] and positions [S * T], T =
    `rows_per_slot` consecutive rows per slot (1 for a decode step, K+1 for
    a verify step's flattened candidates); page_table [S, maxp], active
    [S]. In place."""
    t = int(rows_per_slot)
    if not k_pages.is_cuda:
        if t != 1:  # the plain version takes one row per table row
            page_table = page_table.repeat_interleave(t, dim=0)
            active = active.repeat_interleave(t)
        return write_decode(k_pages, v_pages, k_new, v_new, page_table, positions,
                            active, page_size)
    kernel, dev = "paged_write_decode", k_pages.device
    n_layers, num_pages, ps, kvh, d = k_pages.shape
    s = page_table.shape[0]
    if ps != page_size or t < 1:
        raise ValueError(f"{kernel}: pool page size {ps} != {page_size} or {t} rows per slot")
    _float_dtype(kernel, k_pages)
    _check(kernel, "k_pages", k_pages, dev)
    _check(kernel, "v_pages", v_pages, dev, k_pages.shape, k_pages.dtype)
    _check(kernel, "k_new", k_new, dev, (n_layers, s * t, kvh, d), k_pages.dtype)
    _check(kernel, "v_new", v_new, dev, (n_layers, s * t, kvh, d), k_pages.dtype)
    row_bytes = kvh * d * k_pages.element_size()
    if row_bytes % 16:
        raise ValueError(f"{kernel}: row of {row_bytes} bytes is not a multiple of 16")
    page_table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    positions = positions.to(device=dev, dtype=torch.int32).contiguous()
    active = active.to(device=dev, dtype=torch.bool).contiguous()
    if positions.shape != (s * t,) or active.shape != (s,):
        raise ValueError(f"{kernel}: positions/active do not match {s} slots x {t} rows")
    if n_layers * s:
        _launch("gridllm_paged_write_decode", kernel, _ptr(k_pages), _ptr(v_pages),
                _ptr(k_new), _ptr(v_new), _ptr(page_table), _ptr(positions), _ptr(active),
                n_layers, num_pages, ps, s * t, t, page_table.shape[1], row_bytes,
                _stream(k_pages))
    return k_pages, v_pages


def paged_write_chunk(k_pages, v_pages, k_new, v_new, table_row, start: int,
                      length: int, page_size: int):
    """`write_prefill` on the full pool, whole pages at a time: k_new/v_new
    [L, T, KVH, D] with T % ps == 0 and `start` page-aligned. Pages past
    `length` and unmapped entries are skipped; the padded tail of the last
    written page is written too (attention never reads past the length)."""
    if not k_pages.is_cuda:
        return write_prefill(k_pages, v_pages, k_new, v_new, table_row, start, length,
                             page_size)
    kernel, dev = "paged_write_chunk", k_pages.device
    n_layers, num_pages, ps, kvh, d = k_pages.shape
    t = k_new.shape[1]
    if ps != page_size or t % ps or int(start) % ps:
        raise ValueError(f"{kernel}: needs T % ps == 0 and a page-aligned start "
                         f"(T={t}, start={start}, ps={page_size})")
    _float_dtype(kernel, k_pages)
    _check(kernel, "k_pages", k_pages, dev)
    _check(kernel, "v_pages", v_pages, dev, k_pages.shape, k_pages.dtype)
    _check(kernel, "k_new", k_new, dev, (n_layers, t, kvh, d), k_pages.dtype)
    _check(kernel, "v_new", v_new, dev, (n_layers, t, kvh, d), k_pages.dtype)
    row_bytes = kvh * d * k_pages.element_size()
    if row_bytes % 16:
        raise ValueError(f"{kernel}: row of {row_bytes} bytes is not a multiple of 16")
    # destination page per chunk page, exactly as the TPU wrapper computes it
    table_row = table_row.to(device=dev, dtype=torch.int32)
    c = torch.arange(t // ps, device=dev, dtype=torch.int32)
    idx = torch.clamp(int(start) // ps + c, max=table_row.shape[0] - 1)
    mapped = table_row[idx.long()]
    covered = c * ps < int(length)
    dst = torch.where(covered & (mapped >= 0), mapped,
                      torch.full_like(mapped, num_pages)).contiguous()
    if n_layers * t:
        _launch("gridllm_paged_write_chunk", kernel, _ptr(k_pages), _ptr(v_pages),
                _ptr(k_new), _ptr(v_new), _ptr(dst), n_layers, num_pages, ps, t,
                row_bytes, _stream(k_pages))
    return k_pages, v_pages


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QueryTile:
    """One block of the flash_prefill kernel (one kv head of one sequence)."""
    qt: int                     # query tile index (blockIdx.x = n_tiles - 1 - qt)
    tok0: int                   # first query token
    ntok: int                   # query tokens held (<= bq; fewer at the end of T)
    zero_write: bool            # wholly past seq_len: zeros, no loads, no math
    kv_tiles: tuple[tuple[int, bool], ...]   # (first key, needs the per-element mask)
    rows: tuple[tuple[int, int], ...]        # row r -> (token, head within the group)


def prefill_tile_plan(t_len: int, seq_len: int, g: int, window: int = 0,
                      bk: int | None = None, n_rows: int = PREFILL_ROWS,
                      d: int = 128) -> list[QueryTile]:
    """The tile plan of csrc/flash_prefill.cu for one sequence and kv head,
    in the order the blocks are issued (heaviest first: the last query
    tokens see the most keys); bk None is the bf16 kernel's tile at head
    dim `d` (`prefill_bk`).

    A block holds bq = n_rows // g query tokens, row r = token tok0 + r // g,
    query head r % g of the group (rows past g * bq are spare, zeroed). It
    loads the K/V tiles of bk keys that hold the keys its rows can see:
    from the tile of max(tok0 - window + 1, 0) (0 without a window) up to
    min(last token + 1, seq_len), never past. A tile needs the per-element
    mask unless every row of the block sees every key of it: keys at most
    tok0, all below seq_len, and (with a window) the last token within the
    window of the tile's first key. A query tile that starts at or past
    seq_len writes zeros."""
    bk = prefill_bk(d) if bk is None else bk
    bq = n_rows // g
    n_tiles = -(-t_len // bq)
    plan = []
    for qt in range(n_tiles - 1, -1, -1):
        tok0 = qt * bq
        ntok = min(bq, t_len - tok0)
        rows = tuple((tok0 + r // g, r % g) for r in range(ntok * g))
        if tok0 >= seq_len:
            plan.append(QueryTile(qt, tok0, ntok, True, (), rows))
            continue
        tok_last = tok0 + ntok - 1
        k_hi = min(tok_last + 1, seq_len)
        k_lo = max(tok0 - window + 1, 0) if window > 0 else 0
        tiles = tuple(
            (kt0, kt0 + bk - 1 > tok0 or kt0 + bk > seq_len
             or (window > 0 and tok_last - kt0 >= window))
            for kt0 in range(k_lo // bk * bk, k_hi, bk))
        plan.append(QueryTile(qt, tok0, ntok, False, tiles, rows))
    return plan


def _prefill_launch(kernel: str, q, k, v, seq_lens, softcap: float, window: int):
    """Launch csrc/flash_prefill.cu for either wrapper, counted under
    `kernel`; the operands are checked by the caller."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    seq_lens = seq_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b * t:
        _launch("gridllm_flash_prefill", kernel, _ptr(q), _ptr(k), _ptr(v), _ptr(seq_lens),
                _ptr(out), _float_dtype(kernel, q), b, t, h, kvh, d,
                PREFILL_ROWS // (h // kvh), d ** -0.5, float(softcap), int(window),
                _stream(q))
    return out


def flash_prefill(q, k, v, seq_lens, softcap: float = 0.0, window: int = 0):
    """`attention_prefill_ref`: q [B, T, H, D], k/v [B, T, KVH, D],
    seq_lens [B] → [B, T, H, D] in q's dtype."""
    if not q.is_cuda:
        return attention_prefill_ref(q, k, v, seq_lens, logit_softcap=softcap,
                                     window=window)
    kernel, dev = "flash_prefill", q.device
    b, t, h, d = q.shape
    kvh, _ = _kv_heads_and_dim(kernel, k)
    _float_dtype(kernel, q)
    _gqa(kernel, h, kvh)
    _check(kernel, "q", q, dev)
    _check(kernel, "k", k, dev, (b, t, kvh, d), q.dtype)
    _check(kernel, "v", v, dev, (b, t, kvh, d), q.dtype)
    return _prefill_launch(kernel, q, k, v, seq_lens, softcap, window)


def flash_prefill_streamed(q, k, v, seq_lens, softcap: float = 0.0, window: int = 0):
    """`attention_prefill_blocked_ref` (the function of
    `attention_prefill_ref`, in bounded memory): q [B, T, H, D], k/v
    [B, T, KVH, D], seq_lens [B] → [B, T, H, D] in q's dtype. Rows at
    positions >= seq_lens[b] are padding: the kernel writes zeros for the
    query tiles wholly past the length. Shapes, dtypes and the head
    grouping are checked on every device; the head dim, device, layout and
    alignment only where the kernel launches."""
    kernel = "flash_prefill_streamed"
    b, t, h, d = q.shape
    kvh = k.shape[2]
    _gqa(kernel, h, kvh)
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{kernel}: {name} has dtype {x.dtype}, expected {q.dtype}")
        if tuple(x.shape) != (b, t, kvh, d):
            raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                             f"expected {(b, t, kvh, d)}")
    if tuple(seq_lens.shape) != (b,):
        raise ValueError(f"{kernel}: seq_lens has shape {tuple(seq_lens.shape)}, expected ({b},)")
    if not q.is_cuda:
        return attention_prefill_blocked_ref(q, k, v, seq_lens, logit_softcap=softcap,
                                             window=window)
    dev = q.device
    _kv_heads_and_dim(kernel, k)
    _float_dtype(kernel, q)
    _check(kernel, "q", q, dev)
    _check(kernel, "k", k, dev, (b, t, kvh, d), q.dtype)
    _check(kernel, "v", v, dev, (b, t, kvh, d), q.dtype)
    return _prefill_launch(kernel, q, k, v, seq_lens, softcap, window)


def _groups(kernel: str, fn: str, q, k_pages, v_pages, page_table, lengths, page_size: int,
            k_new, v_new, layer, softcap: float, window: int, legs: tuple[str, ...] = ()):
    """One launch of the group body through a per-phase entry point `fn`
    (csrc/per_phase_attention.cu) on CUDA tensors: q [S, Td, H, D], fresh
    K/V k_new/v_new [S, Td, KVH, D] or None, split over pages into
    `ragged_split_count` spans from host shapes (the scratch of
    `_split_args`, shared with ragged_attention's groups); no host sync."""
    dev = q.device
    k_pages, v_pages, layer = _full_pool(kernel, k_pages, v_pages, page_size, layer)
    _, num_pages, ps, kvh, d = k_pages.shape
    s, td, h, _ = q.shape
    code = _float_dtype(kernel, k_pages)
    _kv_heads_and_dim(kernel, k_pages)
    g = _gqa(kernel, h, kvh)
    _check(kernel, "q", q, dev, (s, td, h, d), k_pages.dtype)
    if (k_new is None) != (v_new is None):
        raise ValueError(f"{kernel}: k_cur and v_cur go together")
    if k_new is not None:
        _check(kernel, "k_cur", k_new, dev, (s, td, kvh, d), k_pages.dtype)
        _check(kernel, "v_cur", v_new, dev, (s, td, kvh, d), k_pages.dtype)
    page_table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if page_table.shape[0] != s or lengths.shape != (s,):
        raise ValueError(f"{kernel}: page_table/lengths do not match {s} slots")
    out = torch.empty_like(q)
    if s * td:
        stream = _stream(q)
        n_table = page_table.shape[1]
        split = _split_args(dev, stream, s, kvh, n_table, td * g, d, ps)
        _launch(fn, kernel, _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_new), _ptr(v_new),
                _ptr(out), _ptr(page_table), _ptr(lengths), s, td, n_table, num_pages, ps,
                layer, *split, h, kvh, d, _rows_per_warp(td * g, d), code, d ** -0.5,
                float(softcap), int(window), stream, legs=legs)
    return out


def paged_decode(q, k_pages, v_pages, page_table, lengths, page_size: int, k_cur=None,
                 v_cur=None, layer: int | None = None, softcap: float = 0.0,
                 window: int = 0):
    """`paged_attention_decode_ref` in one launch: q [S, H, D] against the
    pool (one layer [P, ps, KVH, D], or the full stack with `layer`
    selecting), page_table [S, maxp], lengths [S] on the device (the
    cached prefix when k_cur/v_cur [S, KVH, D] are given, else including
    the current token) → [S, H, D]. On the card: the group body at Td = 1,
    split over pages (`_groups`)."""
    if not q.is_cuda:
        return paged_attention_decode_ref(
            q, _layer_pool(k_pages, layer), _layer_pool(v_pages, layer), page_table,
            lengths, page_size, k_cur=k_cur, v_cur=v_cur, logit_softcap=softcap,
            window=window)
    cur = (None, None) if k_cur is None else (k_cur[:, None], v_cur[:, None])
    return _groups("paged_decode", "gridllm_paged_decode", q[:, None], k_pages, v_pages,
                   page_table, lengths, page_size, *cur, layer, softcap, window)[:, 0]


def _device_scalar(kernel: str, name: str, x, dev: torch.device) -> torch.Tensor:
    """A chunk bound as the kernels take it: a host int as a one-element
    int32 tensor on `dev`, or a one-element int32 tensor already there
    (read by the kernel, never by the host)."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor([int(x)], dtype=torch.int32, device=dev)
    if x.device != dev or x.dtype != torch.int32 or x.numel() != 1:
        raise ValueError(f"{kernel}: {name} must be a host int or one int32 on {dev}")
    return x


def prefix_chunk(q, k_pages, v_pages, table_row, start, total_len, page_size: int,
                 k_cur=None, v_cur=None, layer: int | None = None, softcap: float = 0.0,
                 window: int = 0):
    """`_prefix_chunk_ref` in one launch: q [1, C, H, D] at positions
    start + i against the pool (one layer, or the full stack with `layer`
    selecting) through table_row [maxp], plus the chunk's fresh K/V
    k_cur/v_cur [C, KVH, D] when given. `start` and `total_len` are
    one-element int32 tensors on the card, which the kernel reads itself,
    or host ints, copied there first; `total_len` None means start + C.
    → [1, C, H, D].

    Routes, by input type (`chunk_on_tensor_cores`): a bf16 q on a bf16
    pool whose pages hold whole 8-row boxes runs the wgmma + TMA chunk
    body ("chunk"), any other input the CUDA-core chunk region
    ("chunk_cores"); both in csrc/per_phase_attention.cu, the grid from
    host shapes (C, KVH), no host sync."""
    if not q.is_cuda:
        st = int(start)
        total = st + q.shape[1] if total_len is None else int(total_len)
        return _prefix_chunk_ref(
            q, _layer_pool(k_pages, layer), _layer_pool(v_pages, layer), table_row, st,
            total, page_size, k_cur=k_cur, v_cur=v_cur, logit_softcap=softcap,
            window=window)
    kernel, dev = "prefix_chunk", q.device
    k_pages, v_pages, layer = _full_pool(kernel, k_pages, v_pages, page_size, layer)
    n_layers, num_pages, ps, kvh, d = k_pages.shape
    _, c, h, _ = q.shape
    code = _float_dtype(kernel, k_pages)
    _kv_heads_and_dim(kernel, k_pages)
    g = _gqa(kernel, h, kvh)
    _check(kernel, "q", q, dev, (1, c, h, d), k_pages.dtype)
    if (k_cur is None) != (v_cur is None):
        raise ValueError(f"{kernel}: k_cur and v_cur go together")
    if k_cur is not None:
        _check(kernel, "k_cur", k_cur, dev, (c, kvh, d), k_pages.dtype)
        _check(kernel, "v_cur", v_cur, dev, (c, kvh, d), k_pages.dtype)
    table_row = table_row.to(device=dev, dtype=torch.int32).contiguous()
    start = _device_scalar(kernel, "start", start, dev)
    total = None if total_len is None else _device_scalar(kernel, "total_len", total_len, dev)
    out = torch.empty_like(q)
    if not c:
        return out
    stream = _stream(q)
    chunk = (_ptr(q), _ptr(k_cur), _ptr(v_cur), _ptr(out), _ptr(table_row), _ptr(start),
             _ptr(total), table_row.shape[0], num_pages)
    if chunk_on_tensor_cores(q.dtype, k_pages.dtype, ps, d):
        box = chunk_box_rows(ps, d)
        maps = [_pool_map(p, ps, kvh, d, box, kernel) for p in (k_pages, v_pages)]
        _launch("gridllm_prefix_chunk_wgmma", kernel, *maps, *chunk, n_layers * num_pages,
                ps, box, layer, c, PREFILL_ROWS // g, h, kvh, d, d ** -0.5, float(softcap),
                int(window), stream, legs=("chunk",))
    else:
        bq = max(1, _MAX_ROWS // g)
        _launch("gridllm_prefix_chunk", kernel, _ptr(q), _ptr(k_pages), _ptr(v_pages),
                *chunk[1:], ps, layer, c, bq, h, kvh, d, _rows_per_warp(min(bq, c) * g, d), code,
                d ** -0.5, float(softcap), int(window), stream, legs=("chunk_cores",))
    return out


def prefix_chunk_slots(q, k_pages, v_pages, page_table, lengths, page_size: int, k_cur,
                       v_cur, layer: int | None = None, softcap: float = 0.0,
                       window: int = 0):
    """`paged_attention_verify_ref` (a chain, no tree) in one launch for
    all slots: q [S, T, H, D], candidate i of slot s at position
    lengths[s] + i attending the slot's pages [0, lengths[s]) plus the
    candidates before it, k_cur/v_cur [S, T, KVH, D], page_table [S, maxp],
    lengths [S] on the device → [S, T, H, D]. On the card: the group body
    at Td = T, split over pages (`_groups`), counted as a prefix_chunk
    launch and in LEG_LAUNCHES["prefix_chunk.slots"]."""
    if not q.is_cuda:
        return paged_attention_verify_ref(
            q, _layer_pool(k_pages, layer), _layer_pool(v_pages, layer), page_table,
            lengths, page_size, k_cur, v_cur, logit_softcap=softcap, window=window)
    if k_cur is None or v_cur is None:
        raise ValueError("prefix_chunk: the verify over slots needs k_cur and v_cur")
    return _groups("prefix_chunk", "gridllm_prefix_chunk_slots", q, k_pages, v_pages,
                   page_table, lengths, page_size, k_cur, v_cur, layer, softcap, window,
                   legs=("slots",))


def tree_rows(td: int, tree_pos, tree_bits) -> tuple[int, list[int], list[int]]:
    """Check a group's tree-verify operands against its Td tokens and
    return (tree_n, depths, ancestor bitmasks) as host ints: (0, [], [])
    for a causal group, which may be of any width; a tree has Td <= 32
    nodes, depths in [0, Td) and node i's own bit set in its mask."""
    if tree_pos is None and tree_bits is None:
        return 0, [], []
    if tree_pos is None or tree_bits is None:
        raise ValueError("ragged_attention: tree_pos and tree_bits go together")
    pos = [int(x) for x in np.asarray(tree_pos).reshape(-1)]
    bits = [int(x) & 0xFFFFFFFF for x in np.asarray(tree_bits, dtype=np.int64).reshape(-1)]
    if not 0 < td <= MAX_TREE_NODES or len(pos) != td or len(bits) != td:
        raise ValueError(f"ragged_attention: a tree of {len(pos)} nodes for {td} group "
                         f"tokens (at most {MAX_TREE_NODES})")
    if any(not 0 <= p < td for p in pos) or any(not (b >> i) & 1 for i, b in enumerate(bits)):
        raise ValueError(f"ragged_attention: bad tree depths {pos} or bits {bits}")
    # each mask as the int32 the kernel reads (bit 31 is the sign)
    return td, pos, [b - (1 << 32) if b >> 31 else b for b in bits]


def tree_mask_from_bits(tree_bits, n: int) -> torch.Tensor:
    """[n, n] bool ancestor-or-self mask unpacked from n int32 bitmasks."""
    bits = torch.as_tensor(np.asarray(tree_bits, dtype=np.int64) & 0xFFFFFFFF)
    return ((bits[:, None] >> torch.arange(n)[None, :]) & 1).bool()


# ---------------------------------------------------------------------------
# ragged_attention: the index math of its two kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkTile:
    """One block of csrc/ragged_attention.cu's chunk kernel (one kv head)."""
    qt: int                     # query tile index (blockIdx.x = n_tiles - 1 - qt)
    tok0: int                   # first chunk token of the tile
    ntok: int                   # chunk tokens held (<= bq; fewer at the end of C)
    zero_write: bool            # wholly past chunk_total: zeros, no loads, no math
    # prefix tiles: (first key's absolute position, needs the per-element
    # mask, TMA boxes (first position, page coordinate layer * P + page, or
    # None for a box past the prefix that TMA fills with zeros))
    prefix_tiles: tuple[tuple[int, bool, tuple[tuple[int, int | None], ...]], ...]
    # fresh tiles: (first key's row of k_chunk, needs the per-element mask)
    fresh_tiles: tuple[tuple[int, bool], ...]
    rows: tuple[tuple[int, int], ...]        # row r -> (chunk token, head within the group)


def chunk_box_rows(page_size: int, d: int = 128) -> int:
    """Pool rows per TMA box of the chunk kernel at head dim `d`: gcd(ps,
    prefill_bk(d)), which must hold whole 8-row swizzle atoms (ps a
    multiple of 8)."""
    return int(np.gcd(page_size, prefill_bk(d)))


def chunk_on_tensor_cores(q_dtype: torch.dtype, pool_dtype: torch.dtype, page_size: int,
                          d: int = 128) -> bool:
    """The chunk region's route, by input type: the wgmma + TMA kernel for
    a bf16 q on a bf16 or an int8 pool (its tiles converted to bf16 in
    shared memory) whose page size holds whole 8-row boxes; the CUDA-core
    kernel ("chunk_cores") for float32 q or another page size."""
    return (q_dtype == torch.bfloat16 and pool_dtype in (torch.bfloat16, torch.int8)
            and chunk_box_rows(page_size, d) % 8 == 0)


def ragged_chunk_tile_plan(c: int, chunk_start: int, chunk_total: int, n_table: int,
                           page_size: int, g: int, window: int = 0, chunk_row=None,
                           layer: int = 0, num_pages: int | None = None, fresh: bool = True,
                           bk: int | None = None, n_rows: int = PREFILL_ROWS,
                           d: int = 128) -> list[ChunkTile]:
    """The tile plan of the chunk body (csrc/attention_bodies.cuh, launched
    by ragged_attention's and prefix_chunk's chunk kernels) for one kv head,
    in the order the blocks are issued (heaviest first).

    A block holds bq = n_rows // g chunk tokens, row r = token tok0 + r // g,
    query head r % g, at absolute position chunk_start + token. It walks
    the slot's pool keys [0, ctx), ctx = min(chunk_start, n_table * ps) (with
    `fresh` False, the chunk already in the pool: min(chunk_total, n_table *
    ps)), up to its last position, in tiles of bk keys (None: the kernel's
    tile at head dim `d`, `prefill_bk`) aligned to absolute positions,
    from the tile of max(first position - window + 1, 0) (0 without a
    window); each tile is bk / box_rows TMA boxes
    (`chunk_box_rows`) at page coordinate layer * num_pages +
    clamp(chunk_row[pos // ps], 0, num_pages - 1), a box past ctx read as
    zeros. Then, with `fresh`, the chunk's fresh keys in tiles of bk rows
    aligned to the chunk, from the tile of max(first position - window + 1
    - chunk_start, 0) up to min(last position + 1, f_limit) - chunk_start,
    f_limit = min(chunk_total, n_table * ps) (fresh rows at or past the
    capacity are cut). A tile needs the per-element mask unless every row
    of the block sees every key of it: keys at most the first position,
    below the tile's limit (ctx for pool tiles, f_limit for fresh ones), and
    (with a window) the last position within the window of the tile's first
    key. A query tile that starts at or past chunk_total writes zeros."""
    bk = prefill_bk(d) if bk is None else bk
    bq = n_rows // g
    ps = page_size
    box = int(np.gcd(ps, bk))
    n_qt = -(-c // bq)
    cap = n_table * ps
    ctx = min(max(chunk_start if fresh else chunk_total, 0), cap)
    f_limit = min(chunk_total, cap)
    row = None if chunk_row is None else [int(x) for x in np.asarray(chunk_row).reshape(-1)]

    def masked(kt0, q_first, q_last, limit):
        return (kt0 + bk - 1 > q_first or kt0 + bk > limit
                or (window > 0 and q_last - kt0 >= window))

    def page_coord(pos):
        if pos >= ctx or row is None:
            return None
        return layer * num_pages + min(max(row[pos // ps], 0), num_pages - 1)

    plan = []
    for qt in range(n_qt - 1, -1, -1):
        tok0 = qt * bq
        ntok = min(bq, c - tok0)
        rows = tuple((tok0 + r // g, r % g) for r in range(ntok * g))
        q_first, q_last = chunk_start + tok0, chunk_start + tok0 + ntok - 1
        if q_first >= chunk_total:
            plan.append(ChunkTile(qt, tok0, ntok, True, (), (), rows))
            continue
        p_lo = max(q_first - window + 1, 0) if window > 0 else 0
        p_hi = min(ctx, q_last + 1)
        prefix = tuple(
            (kt0, masked(kt0, q_first, q_last, ctx),
             tuple((pos, page_coord(pos)) for pos in range(kt0, kt0 + bk, box)))
            for kt0 in range(p_lo // bk * bk, p_hi, bk)) if p_lo < p_hi else ()
        c_hi = min(q_last + 1, f_limit) - chunk_start
        c_lo = max(q_first - window + 1 - chunk_start, 0) if window > 0 else 0
        fresh_tiles = tuple((j0, masked(chunk_start + j0, q_first, q_last, f_limit))
                            for j0 in range(c_lo // bk * bk, c_hi, bk)) if fresh else ()
        plan.append(ChunkTile(qt, tok0, ntok, False, prefix, fresh_tiles, rows))
    return plan


SPLIT_BLOCKS_PER_SM = 2        # target blocks of a group launch per SM
SPLIT_MAX_SPAN_KEYS = 2048     # the table's capacity in spans of at most this many keys
SPLIT_SCRATCH_BYTES = 64 << 20  # cap on the float32 partials of one launch


def ragged_split_count(s: int, kvh: int, n_table: int, rows: int, d: int, n_sms: int,
                       page_size: int = 64) -> int:
    """Spans per (slot, kv head) of a group launch, from host shapes only
    (never the lengths, which live on the device): enough blocks to give
    each SM SPLIT_BLOCKS_PER_SM, and enough that a slot at the table's
    capacity (n_table * page_size keys) walks at most SPLIT_MAX_SPAN_KEYS
    keys per block; at most one span per table page, and partials of at
    most SPLIT_SCRATCH_BYTES."""
    if s * kvh == 0:
        return 1
    n = max(-(-(SPLIT_BLOCKS_PER_SM * n_sms) // (s * kvh)),
            -(-(n_table * page_size) // SPLIT_MAX_SPAN_KEYS))
    per_span = s * kvh * rows * (d + 2) * 4
    return max(1, min(n, n_table, SPLIT_SCRATCH_BYTES // max(per_span, 1)))


def ragged_split_plan(lengths, n_table: int, page_size: int,
                      n_splits: int) -> list[list[tuple[int, int, bool]]]:
    """Per slot, per span: (first, end) pool rows [p0, p1) the span's block
    walks, and whether it also attends the fresh K/V (span 0 only, when a
    group has them). The slot's ctx = min(length, n_table * ps) cached rows
    are cut into n_splits spans of span_pages = ceil(ceil(ctx / ps) /
    n_splits) whole pages; a span past ctx walks nothing (p0 == p1) and
    writes an empty partial, except span 0, which always attends the fresh
    K/V. The kernel computes the same from the length it reads on the
    device."""
    ps = page_size
    plan = []
    for ln in lengths:
        ctx = min(max(int(ln), 0), n_table * ps)
        span_pages = -(-(-(-ctx // ps)) // n_splits)
        spans = []
        for i in range(n_splits):
            p0 = min(i * span_pages * ps, ctx)
            spans.append((p0, min(p0 + span_pages * ps, ctx), i == 0))
        plan.append(spans)
    return plan


def _span_partial(q, ks, vs, vis, scale: float, softcap: float):
    """One span's partial softmax state in float32, the kernel's way:
    q [R, D], keys ks/vs [N, D], vis [R, N] → (m [R],
    l [R], acc [R, D]) with m the running max of the visible logits (-1e30
    when none), l = sum e^(x - m), acc = sum e^(x - m) v."""
    x = (q @ ks.T) * scale
    if softcap > 0.0:
        x = softcap * torch.tanh(x / softcap)
    x = torch.where(vis, x, torch.full_like(x, -1e30))
    m = x.amax(dim=-1) if x.shape[-1] else torch.full((q.shape[0],), -1e30)
    p = torch.where(vis, torch.exp(x - m[:, None]), torch.zeros_like(x))
    return m, p.sum(-1), p @ vs


def ragged_split_merge_ref(k_pages, v_pages, page_size: int, q_group, page_table,
                           group_lengths, k_group, v_group, n_splits: int,
                           layer: int | None = None, softcap: float = 0.0, window: int = 0,
                           tree_pos=None, tree_mask=None) -> torch.Tensor:
    """The group body computed span by span (`ragged_split_plan`) and
    merged as csrc/attention_bodies.cuh's last block merges the partials:
    M = max m_i over spans with l_i > 0, out = sum e^(m_i - M) acc_i /
    max(sum e^(m_i - M) l_i, 1e-30). Pools one layer [P, ps, KVH, D] or the
    full stack with `layer`, fp or int8 (`QuantPages`, dequantized by
    gather_kv); a tree by tree_pos [Td] / tree_mask [Td, Td]. The body's two
    policies: with fresh K/V k_group/v_group [S, Td, KVH, D] query i sits at
    length + i and fresh row i is cut at the table's capacity (length + i
    >= n_table * ps); with k_group/v_group None (paged_decode with the
    current token in the pool) the query sits at length - 1 and attends the
    pool alone. Float32 math; → [S, Td, H, D] in q's dtype."""
    from gridllm_torch.ops.kvcache import gather_kv

    kp, vp = _layer_pool(k_pages, layer), _layer_pool(v_pages, layer)
    s, td, h, d = q_group.shape
    kvh = kp.shape[-2]
    g = h // kvh
    n_table = page_table.shape[1]
    cap = n_table * page_size
    scale = d ** -0.5
    has_fresh = k_group is not None
    plan = ragged_split_plan(group_lengths.tolist(), n_table, page_size, n_splits)
    depth = torch.arange(td) if tree_pos is None else torch.as_tensor(
        np.asarray(tree_pos), dtype=torch.int64)
    out = torch.empty(s, td, h, d, dtype=torch.float32)
    for si in range(s):
        length = max(int(group_lengths[si]), 0)
        ks, vs = gather_kv(kp, vp, page_table[si], page_size)
        ks, vs = ks.float(), vs.float()
        q_pos = (length if has_fresh else length - 1) + depth   # logical query positions
        n_fresh = max(min(td, cap - length), 0) if has_fresh else 0
        parts = []
        for p0, p1, fresh in plan[si]:
            k_pos = torch.arange(p0, p1)
            pool_vis = k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                pool_vis &= (q_pos[:, None] - k_pos[None, :]) < window
            nf = n_fresh if fresh else 0
            f_pos = length + depth[:nf]
            if tree_mask is None:
                f_vis = f_pos[None, :] <= q_pos[:, None]
            else:
                f_vis = torch.as_tensor(np.asarray(tree_mask), dtype=torch.bool)[:, :nf].clone()
            if window > 0:
                f_vis &= (q_pos[:, None] - f_pos[None, :]) < window
            vis = torch.cat([pool_vis, f_vis], dim=1)
            parts_h = []
            for kh in range(kvh):
                keys, vals = ks[p0:p1, kh], vs[p0:p1, kh]
                if nf:
                    keys = torch.cat([keys, k_group[si, :nf, kh].float()])
                    vals = torch.cat([vals, v_group[si, :nf, kh].float()])
                q = q_group[si, :, kh * g:(kh + 1) * g].float().reshape(td * g, d)
                parts_h.append(_span_partial(q, keys, vals, vis.repeat_interleave(g, dim=0),
                                             scale, softcap))
            parts.append(parts_h)
        for kh in range(kvh):
            ms = torch.stack([parts[i][kh][0] for i in range(n_splits)])
            ls = torch.stack([parts[i][kh][1] for i in range(n_splits)])
            accs = torch.stack([parts[i][kh][2] for i in range(n_splits)])
            live = ls > 0
            mx = torch.where(live, ms, torch.full_like(ms, -1e30)).amax(dim=0)
            w = torch.where(live, torch.exp(ms - mx), torch.zeros_like(ms))
            o = (w[..., None] * accs).sum(0) / (w * ls).sum(0).clamp_min(1e-30)[:, None]
            out[si, :, kh * g:(kh + 1) * g] = o.reshape(td, g, d)
    return out.to(q_group.dtype)


_sm_counts: dict[int, int] = {}
_scratch: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
_split_cache: dict[tuple, tuple[int, int | None, int | None, int | None]] = {}
_pool_maps: dict[tuple, ctypes.Array] = {}
_MAP_BYTES = 128  # sizeof(CUtensorMap)


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def _split_args(dev: torch.device, stream: int, s: int, kvh: int, n_table: int, rows: int,
                d: int, page_size: int) -> tuple[int, int | None, int | None, int | None]:
    """(n_splits, part_ml, part_acc, counters) of a group launch, the last
    three as addresses (None without a split), kept per launch shape so a
    step's launches do no work for them on the host. The float32 partials
    and int32 counters live in one buffer each per (device, stream), grown
    as needed: launches on one stream run in order, and each leaves its
    counters at zero for the next."""
    key = (dev, stream, s, kvh, n_table, rows, d, page_size)
    args = _split_cache.get(key)
    if args is not None:
        return args
    n = ragged_split_count(s, kvh, n_table, rows, d, _sm_count(dev), page_size)
    if n == 1:
        args = (1, None, None, None)
    else:
        need = s * kvh * n * rows * (d + 2)
        part, counters = _scratch.get((dev, stream), (None, None))
        if part is None or part.numel() < need or counters.numel() < s * kvh:
            part = torch.empty(max(need, 0 if part is None else part.numel()),
                               dtype=torch.float32, device=dev)
            counters = torch.zeros(max(s * kvh, 0 if counters is None else counters.numel()),
                                   dtype=torch.int32, device=dev)
            _scratch[(dev, stream)] = (part, counters)
            # addresses kept for this stream point into the old buffers
            for stale in [k for k in _split_cache if k[:2] == (dev, stream)]:
                del _split_cache[stale]
        base = part.data_ptr()
        args = (n, base, base + s * kvh * n * rows * 2 * 4, counters.data_ptr())
    _split_cache[key] = args
    return args


def _pool_map(pool: torch.Tensor, ps: int, kvh: int, d: int, box_rows: int,
              kernel: str = "ragged_attention") -> ctypes.Array:
    """The chunk body's TMA map of one bf16 or int8 pool [L, P, ps, KVH, D],
    encoded once per (address, shape, dtype) and kept: the map holds
    nothing else."""
    pool_pages = pool.shape[0] * pool.shape[1]
    key = (pool.device, pool.data_ptr(), pool.dtype, pool_pages, ps, kvh, d, box_rows)
    m = _pool_maps.get(key)
    if m is None:
        m = (ctypes.c_byte * _MAP_BYTES)()
        _raise_on(_fn("gridllm_ragged_pool_map")(pool.data_ptr(), pool_pages, ps, kvh, d,
                                                 box_rows, int(pool.dtype == torch.int8), m),
                  kernel)
        if len(_pool_maps) >= 64:
            _pool_maps.clear()
        _pool_maps[key] = m
    return m


def ragged_attention(k_pages, v_pages, page_size: int, q_chunk=None, chunk_row=None,
                     chunk_start=None, chunk_total=None, k_chunk=None, v_chunk=None,
                     q_group=None, page_table=None, group_lengths=None, k_group=None,
                     v_group=None, layer: int | None = None, softcap: float = 0.0,
                     window: int = 0, k_scale=None, v_scale=None, tree_pos=None,
                     tree_bits=None):
    """`ragged_paged_attention_ref` on the card (see
    ops.attention.ragged_paged_attention for the region contract). With
    k_scale/v_scale the pools are int8 values and these their float32
    per-row scales [L, P, ps] (or [P, ps] for one layer): the kernel's int8
    leg dequantizes each pool row after its load, and the compute dtype is
    q's. With tree_pos/tree_bits (host int arrays of Td <= 32 node depths
    and int32 ancestor bitmasks, as `tree_rows` checks) the group's tokens
    are a token tree: the kernel's tree leg, counted in
    LEG_LAUNCHES["ragged_attention.tree"].

    Launches: the chunk region of a bf16 q on a bf16 or an int8 pool runs
    the wgmma + TMA chunk kernel ("chunk"; on an int8 pool also "int8": its
    tiles converted exactly to bf16 in shared memory, the row scales
    applied in float32 to the logits and the probabilities); a float32
    chunk region, and the group region, run the CUDA-core kernel, one
    launch for both ("chunk_cores", "group"). A call with one region
    launches once; a mixed step on the tensor-core route twice, on one
    stream, each launch of an int8 pool counted "int8". The group region is
    split over pages into `ragged_split_count` spans, from host shapes
    only: the wrapper never reads a device value (no host sync)."""
    if q_chunk is None and q_group is None:
        raise ValueError("ragged_attention: needs a chunk or a group region")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("ragged_attention: k_scale and v_scale go together")
    has_tree = tree_pos is not None or tree_bits is not None
    if has_tree and q_group is None:
        raise ValueError("ragged_attention: a tree needs a group region")
    tree_n, t_pos, t_bits = tree_rows(q_group.shape[1] if has_tree else 0, tree_pos, tree_bits)
    if not k_pages.is_cuda:
        if quant:
            k_pages, v_pages = QuantPages(k_pages, k_scale), QuantPages(v_pages, v_scale)
        tree = {}
        if tree_n:
            tree = dict(tree_pos=torch.tensor(t_pos, dtype=torch.int32),
                        tree_mask=tree_mask_from_bits(t_bits, tree_n))
        return ragged_paged_attention_ref(
            k_pages, v_pages, page_size, q_chunk=q_chunk, chunk_row=chunk_row,
            chunk_start=chunk_start, chunk_total=chunk_total, k_chunk=k_chunk,
            v_chunk=v_chunk, q_group=q_group, page_table=page_table,
            group_lengths=group_lengths, k_group=k_group, v_group=v_group,
            layer=layer, logit_softcap=softcap, window=window, **tree)
    kernel, dev = "ragged_attention", k_pages.device
    some_q = q_chunk if q_chunk is not None else q_group
    cdtype = some_q.dtype   # the compute dtype: q's, whatever the pool holds
    code = _float_dtype(kernel, some_q)
    k_pages, v_pages, layer = _full_pool(kernel, k_pages, v_pages, page_size, layer)
    n_layers, num_pages, ps, kvh, d = k_pages.shape
    _kv_heads_and_dim(kernel, k_pages)
    if quant:
        if k_pages.dtype != torch.int8:
            raise TypeError(f"{kernel}: a pool with scales has dtype {k_pages.dtype}, "
                            "expected torch.int8")
        if k_scale.dim() == 2:
            k_scale, v_scale = k_scale[None], v_scale[None]
        _check(kernel, "k_scale", k_scale, dev, (n_layers, num_pages, ps), torch.float32)
        _check(kernel, "v_scale", v_scale, dev, (n_layers, num_pages, ps), torch.float32)
    elif k_pages.dtype != cdtype:
        raise TypeError(f"{kernel}: k_pages has dtype {k_pages.dtype}, expected {cdtype}")
    g = _gqa(kernel, some_q.shape[-2], kvh)
    h = g * kvh
    scale, cap, win = d ** -0.5, float(softcap), int(window)
    stream = _stream(k_pages)
    bq = max(1, _MAX_ROWS // g)
    rows = 0
    out_chunk = out_group = None
    c = n_tiles = n_table_c = start = total = 0
    on_cores = q_chunk is not None and not chunk_on_tensor_cores(cdtype, k_pages.dtype, ps, d)
    if q_chunk is not None:
        c = q_chunk.shape[1]
        _check(kernel, "q_chunk", q_chunk, dev, (1, c, h, d), cdtype)
        _check(kernel, "k_chunk", k_chunk, dev, (c, kvh, d), cdtype)
        _check(kernel, "v_chunk", v_chunk, dev, (c, kvh, d), cdtype)
        chunk_row = chunk_row.to(device=dev, dtype=torch.int32).contiguous()
        n_table_c = chunk_row.shape[0]
        start, total = int(chunk_start), int(chunk_total)
        out_chunk = torch.empty_like(q_chunk)
        if on_cores:
            n_tiles = -(-c // bq)
            rows = bq * g
        elif c:
            box = chunk_box_rows(ps, d)
            maps = [_pool_map(p, ps, kvh, d, box) for p in (k_pages, v_pages)]
            _launch("gridllm_ragged_chunk", kernel, *maps, _ptr(q_chunk), _ptr(k_chunk),
                    _ptr(v_chunk), _ptr(out_chunk), _ptr(chunk_row), _ptr(k_scale),
                    _ptr(v_scale), n_table_c, num_pages, n_layers * num_pages, ps, box, layer,
                    c, PREFILL_ROWS // g, start, total, h, kvh, d, scale, cap, win, stream,
                    legs=("chunk",) + ("int8",) * quant)
    s = td = n_table_g = 0
    n_splits, part_ml, part_acc, counters = 1, None, None, None
    if q_group is not None:
        s, td = q_group.shape[:2]
        _check(kernel, "q_group", q_group, dev, (s, td, h, d), cdtype)
        _check(kernel, "k_group", k_group, dev, (s, td, kvh, d), cdtype)
        _check(kernel, "v_group", v_group, dev, (s, td, kvh, d), cdtype)
        page_table = page_table.to(device=dev, dtype=torch.int32).contiguous()
        group_lengths = group_lengths.to(device=dev, dtype=torch.int32).contiguous()
        if page_table.shape[0] != s or group_lengths.shape != (s,):
            raise ValueError(f"{kernel}: page_table/group_lengths do not match {s} slots")
        n_table_g = page_table.shape[1]
        rows = max(rows, td * g)
        out_group = torch.empty_like(q_group)
        if s:
            n_splits, part_ml, part_acc, counters = _split_args(dev, stream, s, kvh, n_table_g,
                                                                td * g, d, ps)
    legs = (("int8",) * quant + ("tree",) * bool(tree_n) + ("chunk_cores",) * bool(n_tiles)
            + ("group",) * bool(s))
    if n_tiles + s:
        _launch("gridllm_ragged_attention", kernel, _ptr(k_pages), _ptr(v_pages),
                _ptr(k_scale), _ptr(v_scale), num_pages, ps, layer,
                _ptr(q_chunk), _ptr(k_chunk), _ptr(v_chunk), _ptr(out_chunk),
                _ptr(chunk_row), n_table_c, c, bq, start, total, n_tiles,
                _ptr(q_group), _ptr(k_group), _ptr(v_group), _ptr(out_group),
                _ptr(page_table), _ptr(group_lengths), n_table_g, s, td,
                n_splits, part_ml, part_acc, counters,
                h, kvh, d, _rows_per_warp(rows, d), code, scale, cap, win,
                tree_n, (ctypes.c_int * max(tree_n, 1))(*t_pos),
                (ctypes.c_int * max(tree_n, 1))(*t_bits), stream, legs=legs)
    return out_chunk, out_group
