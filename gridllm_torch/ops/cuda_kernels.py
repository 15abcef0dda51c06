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
counts, beside them, the launches of one leg of a kernel (the int8 pool
leg and the tree-verify leg of ragged_attention; one launch may take
both).

Kernels (gridllm_torch/csrc/), the TPU kernels they replace
(gridllm_tpu/ops/pallas_kernels.py) and their plain versions:
- flash_prefill       :129  → ops.attention.attention_prefill_ref
- flash_prefill_streamed :268 → ops.attention.attention_prefill_blocked_ref
  (both wrappers launch the one kernel of csrc/flash_prefill.cu, whose
  tile plan `prefill_tile_plan` gives in Python)
- paged_decode        :479  → ops.attention.paged_attention_decode_ref
- prefix_chunk        :739  → ops.attention._prefix_chunk_ref
- ragged_attention    :1168 → ops.attention.ragged_paged_attention_ref
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
}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LEG_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict[str, int]:
    return {**LAUNCHES, **LEG_LAUNCHES}


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES: dict[str, tuple[str, list]] = {
    "gridllm_paged_write_decode": (
        "paged_write.cu", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _P]),
    "gridllm_paged_write_chunk": (
        "paged_write.cu", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P]),
    "gridllm_flash_prefill": (
        "flash_prefill.cu",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]),
    "gridllm_paged_decode": (
        "paged_decode.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P,          # q, pools, k/v_cur, out, table, lengths
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # S, n_table, P, ps, layer, H, KVH, D, rpw, dtype
         _F, _F, _I, _P]),                        # scale, softcap, window, stream
    "gridllm_prefix_chunk": (
        "prefix_chunk.cu",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P,      # q, pools, k/v_cur, out, row, start, total
         _I, _I, _I, _I, _I, _I,                  # n_table, P, ps, layer, C, bq
         _I, _I, _I, _I, _I,                      # H, KVH, D, rpw, dtype
         _F, _F, _I, _P]),                        # scale, softcap, window, stream
    "gridllm_ragged_attention": (
        "ragged_attention.cu",
        [_P, _P, _P, _P, _I, _I, _I,              # pools, scales, P, ps, layer
         _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,  # chunk region
         _P, _P, _P, _P, _P, _P, _I, _I, _I,      # group region
         _I, _I, _I, _I, _I, _F, _F, _I,          # H, KVH, D, rpw, dtype, ...
         _I, _P, _P, _P]),                        # tree_n, tree_pos, tree_bits, stream
    "gridllm_error_string": ("paged_write.cu", [_I]),
}
_fns: dict[str, Any] = {}
_fns_lock = threading.Lock()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_ROWS = 32  # query rows one block holds: kWarps (4) x RPW (<= 8)
MAX_TREE_NODES = 32  # the tree leg's int32 ancestor bitmask per node
PREFILL_ROWS = 128  # flash_prefill.cu: query rows per block, two m64 slabs
PREFILL_BK = 128    # flash_prefill.cu: keys per K/V tile (bf16)
# codes of flash_prefill.cu's entry point beside cudaError_t values
_PREFILL_ERRORS = {-1: "cuTensorMapEncodeTiled not found in libcuda.so.1",
                   -2: "the driver refused a TMA tensor map"}


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
    if err != 0:
        msg = _PREFILL_ERRORS.get(err) or _fn("gridllm_error_string")(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({err})")
    LAUNCHES[kernel] += 1
    for leg in legs:
        LEG_LAUNCHES[f"{kernel}.{leg}"] += 1


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


def _rows_per_warp(rows: int) -> int:
    """Smallest compiled rows-per-warp whose 4 warps hold `rows` (<= 32)."""
    for rpw in (1, 2, 4, 8):
        if 4 * rpw >= min(rows, _MAX_ROWS):
            return rpw
    return 8


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
                      bk: int = PREFILL_BK, n_rows: int = PREFILL_ROWS) -> list[QueryTile]:
    """The tile plan of csrc/flash_prefill.cu for one sequence and kv head,
    in the order the blocks are issued (heaviest first: the last query
    tokens see the most keys).

    A block holds bq = n_rows // g query tokens, row r = token tok0 + r // g,
    query head r % g of the group (rows past g * bq are spare, zeroed). It
    loads the K/V tiles of bk keys that hold the keys its rows can see:
    from the tile of max(tok0 - window + 1, 0) (0 without a window) up to
    min(last token + 1, seq_len), never past. A tile needs the per-element
    mask unless every row of the block sees every key of it: keys at most
    tok0, all below seq_len, and (with a window) the last token within the
    window of the tile's first key. A query tile that starts at or past
    seq_len writes zeros."""
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


def paged_decode(q, k_pages, v_pages, page_table, lengths, page_size: int, k_cur=None,
                 v_cur=None, layer: int | None = None, softcap: float = 0.0,
                 window: int = 0):
    """`paged_attention_decode_ref` in one launch: q [S, H, D] against the
    pool (one layer [P, ps, KVH, D], or the full stack with `layer`
    selecting), page_table [S, maxp], lengths [S] on the device (the
    cached prefix when k_cur/v_cur [S, KVH, D] are given, else including
    the current token) → [S, H, D]."""
    if not q.is_cuda:
        return paged_attention_decode_ref(
            q, _layer_pool(k_pages, layer), _layer_pool(v_pages, layer), page_table,
            lengths, page_size, k_cur=k_cur, v_cur=v_cur, logit_softcap=softcap,
            window=window)
    kernel, dev = "paged_decode", q.device
    k_pages, v_pages, layer = _full_pool(kernel, k_pages, v_pages, page_size, layer)
    _, num_pages, ps, kvh, d = k_pages.shape
    s, h, _ = q.shape
    code = _float_dtype(kernel, k_pages)
    _kv_heads_and_dim(kernel, k_pages)
    g = _gqa(kernel, h, kvh)
    _check(kernel, "q", q, dev, (s, h, d), k_pages.dtype)
    if (k_cur is None) != (v_cur is None):
        raise ValueError(f"{kernel}: k_cur and v_cur go together")
    if k_cur is not None:
        _check(kernel, "k_cur", k_cur, dev, (s, kvh, d), k_pages.dtype)
        _check(kernel, "v_cur", v_cur, dev, (s, kvh, d), k_pages.dtype)
    page_table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if page_table.shape[0] != s or lengths.shape != (s,):
        raise ValueError(f"{kernel}: page_table/lengths do not match {s} slots")
    out = torch.empty_like(q)
    if s:
        _launch("gridllm_paged_decode", kernel, _ptr(q), _ptr(k_pages), _ptr(v_pages),
                _ptr(k_cur), _ptr(v_cur), _ptr(out), _ptr(page_table), _ptr(lengths),
                s, page_table.shape[1], num_pages, ps, layer, h, kvh, d, _rows_per_warp(g),
                code, d ** -0.5, float(softcap), int(window), _stream(q))
    return out


def _device_scalar(kernel: str, name: str, x, dev: torch.device) -> torch.Tensor:
    """A host int as a one-element int32 tensor on `dev`, or a one-element
    int32 tensor already there (read by the kernel, never by the host)."""
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
    k_cur/v_cur [C, KVH, D] when given. `start` and `total_len` are host
    ints or one-element int32 tensors on the card, which the kernel reads
    itself; `total_len` None means start + C. → [1, C, H, D]."""
    if not q.is_cuda:
        st = int(start)
        total = st + q.shape[1] if total_len is None else int(total_len)
        return _prefix_chunk_ref(
            q, _layer_pool(k_pages, layer), _layer_pool(v_pages, layer), table_row, st,
            total, page_size, k_cur=k_cur, v_cur=v_cur, logit_softcap=softcap,
            window=window)
    kernel, dev = "prefix_chunk", q.device
    k_pages, v_pages, layer = _full_pool(kernel, k_pages, v_pages, page_size, layer)
    _, num_pages, ps, kvh, d = k_pages.shape
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
    bq = max(1, _MAX_ROWS // g)
    out = torch.empty_like(q)
    if c:
        _launch("gridllm_prefix_chunk", kernel, _ptr(q), _ptr(k_pages), _ptr(v_pages),
                _ptr(k_cur), _ptr(v_cur), _ptr(out), _ptr(table_row), _ptr(start),
                _ptr(total), table_row.shape[0], num_pages, ps, layer, c, bq, h, kvh, d,
                _rows_per_warp(min(bq, c) * g), code, d ** -0.5, float(softcap),
                int(window), _stream(q))
    return out


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


def ragged_attention(k_pages, v_pages, page_size: int, q_chunk=None, chunk_row=None,
                     chunk_start=None, chunk_total=None, k_chunk=None, v_chunk=None,
                     q_group=None, page_table=None, group_lengths=None, k_group=None,
                     v_group=None, layer: int | None = None, softcap: float = 0.0,
                     window: int = 0, k_scale=None, v_scale=None, tree_pos=None,
                     tree_bits=None):
    """`ragged_paged_attention_ref` in one launch (see
    ops.attention.ragged_paged_attention for the region contract). With
    k_scale/v_scale the pools are int8 values and these their float32
    per-row scales [L, P, ps] (or [P, ps] for one layer): the kernel's int8
    leg dequantizes each pool row after its load, and the compute dtype is
    q's. With tree_pos/tree_bits (host int arrays of Td <= 32 node depths
    and int32 ancestor bitmasks, as `tree_rows` checks) the group's tokens
    are a token tree: the kernel's tree leg, counted in
    LEG_LAUNCHES["ragged_attention.tree"]."""
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
    bq = max(1, _MAX_ROWS // g)
    rows = 0
    out_chunk = out_group = None
    c = n_tiles = n_table_c = start = total = 0
    if q_chunk is not None:
        c = q_chunk.shape[1]
        _check(kernel, "q_chunk", q_chunk, dev, (1, c, h, d), cdtype)
        _check(kernel, "k_chunk", k_chunk, dev, (c, kvh, d), cdtype)
        _check(kernel, "v_chunk", v_chunk, dev, (c, kvh, d), cdtype)
        chunk_row = chunk_row.to(device=dev, dtype=torch.int32).contiguous()
        n_table_c = chunk_row.shape[0]
        start, total = int(chunk_start), int(chunk_total)
        n_tiles = -(-c // bq)
        rows = bq * g
        out_chunk = torch.empty_like(q_chunk)
    s = td = n_table_g = 0
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
    legs = ("int8",) * quant + ("tree",) * bool(tree_n)
    if n_tiles + s:
        _launch("gridllm_ragged_attention", kernel, _ptr(k_pages), _ptr(v_pages),
                _ptr(k_scale), _ptr(v_scale), num_pages, ps, layer,
                _ptr(q_chunk), _ptr(k_chunk), _ptr(v_chunk), _ptr(out_chunk),
                _ptr(chunk_row), n_table_c, c, bq, start, total, n_tiles,
                _ptr(q_group), _ptr(k_group), _ptr(v_group), _ptr(out_group),
                _ptr(page_table), _ptr(group_lengths), n_table_g, s, td,
                h, kvh, d, _rows_per_warp(rows), code, d ** -0.5, float(softcap),
                int(window), tree_n, (ctypes.c_int * max(tree_n, 1))(*t_pos),
                (ctypes.c_int * max(tree_n, 1))(*t_bits), _stream(k_pages), legs=legs)
    return out_chunk, out_group
