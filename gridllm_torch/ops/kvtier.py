"""Host-RAM KV tier: the spill target behind the device prefix cache.

The JAX package's ops/kvtier.py. The ref-counted ``PageAllocator`` keeps
refcount-0 prefix-cache pages in a reuse LRU on the device; when a fresh
allocation evicts from that LRU, the page's content would be gone and the
next ``match_prefix`` would pay a cold prefill. With the tier enabled
(``GRIDLLM_KV_HOST_BYTES`` > 0) the engine copies each evicted page to host
memory first, encoded with the migration wire format as the spill codec
(``transfer/wire.py build_spill_header``: same version/crc/digest
discipline, addressed by the page's content-addressed CHAIN KEY), and a
later ``match_prefix`` walking the same chain pages the content back into a
fresh pool page.

Spill quantization: fp pools quantize each page to int8 on spill
(``GRIDLLM_KV_SPILL_INT8``, default on) with ONE symmetric scale per
(layer, page), halving host bytes; ``=0`` spills the raw dtype, making
tier-on streams byte-identical to tier-off. Resident int8 pools spill their
int8 rows and per-row scales verbatim.

The tier is a bounded LRU over whole pages; the capacity IS the enable
knob. All methods are thread-safe (one internal lock). Pages are numpy
buffers; a bfloat16 page is held as its 16-bit words and named by the
``dtype`` the caller passes (numpy has no bfloat16, see transfer/wire.py).
The quantization arithmetic is the JAX package's numpy code, so both
packages store the same bytes for the same page.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from gridllm_torch.obs import default_registry
from gridllm_torch.transfer.wire import (
    Assembler,
    WireError,
    as_float32,
    build_spill_header,
    spill_arrays,
)
from gridllm_torch.utils.logging import get_logger

_OBS = default_registry()
_SPILLS = _OBS.counter(
    "gridllm_kv_tier_spills_total",
    "KV pages spilled from the HBM prefix cache into the host tier, "
    "by model.",
    ("model",),
)
_RESTORES = _OBS.counter(
    "gridllm_kv_tier_restores_total",
    "KV pages restored (paged back into HBM) from the host tier on "
    "match_prefix hits, by model.",
    ("model",),
)
_MISSES = _OBS.counter(
    "gridllm_kv_tier_misses_total",
    "Host-tier lookups that found nothing (chain key never spilled or "
    "already evicted), by model.",
    ("model",),
)
_EVICTIONS = _OBS.counter(
    "gridllm_kv_tier_evictions_total",
    "KV pages evicted from the host tier's byte-bounded LRU, by model.",
    ("model",),
)
_SPILL_BYTES = _OBS.counter(
    "gridllm_kv_tier_spill_bytes_total",
    "Encoded bytes written into the host tier by page spills, by model.",
    ("model",),
)
_RESTORE_BYTES = _OBS.counter(
    "gridllm_kv_tier_restore_bytes_total",
    "Encoded bytes read back from the host tier by page restores, "
    "by model.",
    ("model",),
)
_RESTORE_FAILURES = _OBS.counter(
    "gridllm_kv_tier_restore_failures_total",
    "Host-tier restores that failed (injected fault, pool pressure, or "
    "integrity error) and degraded to a cold prefill, by model.",
    ("model",),
)
_TIER_PAGES = _OBS.gauge(
    "gridllm_kv_tier_pages",
    "KV pages resident per cache tier (hbm = refcount-0 pages in the "
    "HBM reuse LRU, host = pages in the host-RAM tier), by model.",
    ("model", "tier"),
)
_TIER_BYTES = _OBS.gauge(
    "gridllm_kv_tier_bytes",
    "KV bytes resident per cache tier (hbm = reuse-LRU pages at pool "
    "bytes/page, host = encoded spill bytes), by model.",
    ("model", "tier"),
)


def set_tier_gauges(model: str, hbm_pages: int, hbm_bytes: int,
                    host_pages: int, host_bytes: int) -> None:
    """One choke point for the per-tier residency gauges (the engine's
    _update_kv_gauges calls it so scrape values always move together)."""
    _TIER_PAGES.set(hbm_pages, model=model, tier="hbm")
    _TIER_BYTES.set(hbm_bytes, model=model, tier="hbm")
    _TIER_PAGES.set(host_pages, model=model, tier="host")
    _TIER_BYTES.set(host_bytes, model=model, tier="host")


def quantize_page(x: np.ndarray, dtype: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization with ONE scale per (layer, page):
    x [L, 1, ps, KVH, D] float (`dtype` "bfloat16" for uint16 words) →
    (int8 values, float32 scales [L, 1]). The scale is amax/127 so the
    full range is representable; an all-zero page keeps scale 1.0
    (dequant stays exact zeros)."""
    xf = as_float32(x, dtype or str(x.dtype))
    amax = np.max(np.abs(xf), axis=(2, 3, 4))
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(xf / scale[:, :, None, None, None]),
                -127, 127).astype(np.int8)
    return q, scale


def quantize_rows_np(x: np.ndarray, dtype: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Host-side per-row symmetric int8 quantization (numpy mirror of
    ops.kvcache.quantize_kv_rows): x [..., KVH, D] float (`dtype`
    "bfloat16" for uint16 words) → (int8 values, float32 scales [...]).
    Used when fp wire pages land on an int8 pool (migration import /
    fp-spill restore)."""
    xf = as_float32(x, dtype or str(x.dtype))
    amax = np.max(np.abs(xf), axis=(-2, -1))
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(xf / scale[..., None, None]),
                -127, 127).astype(np.int8)
    return q, scale


def dequantize_page(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_page` (float32 result; the caller casts
    to the pool dtype)."""
    return np.asarray(q, np.float32) * scale[:, :, None, None, None]


class HostKVTier:
    """Byte-bounded LRU of spilled KV pages, keyed by prefix-cache chain
    key. Stores each page as its wire-codec (header, payload) pair so a
    restore goes back through the Assembler's digest check — a corrupted
    host buffer fails loudly into the cold-prefill path instead of
    silently decoding garbage."""

    def __init__(self, capacity_bytes: int, model: str = "",
                 spill_int8: bool = True):
        self.capacity_bytes = max(int(capacity_bytes), 0)
        self.model = model or "unknown"
        self.spill_int8 = bool(spill_int8)
        self._lock = threading.Lock()
        # key → (header, payload); insertion order is the LRU order
        # (move_to_end on hit)
        self._recs: dict[bytes, tuple[dict[str, Any], bytes]] = {}
        self._bytes = 0
        # cumulative plain-int mirrors of the obs counters so
        # /admin/memory and bench read without touching the registry
        self.spills = 0
        self.restores = 0
        self.misses = 0
        self.evictions = 0
        self.restore_failures = 0

    # -- capacity -----------------------------------------------------------

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._recs

    @property
    def pages(self) -> int:
        with self._lock:
            return len(self._recs)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "pages": len(self._recs),
                "bytes": self._bytes,
                "capacityBytes": self.capacity_bytes,
                "spillDtype": "int8-page" if self.spill_int8 else "raw",
                "spills": self.spills,
                "restores": self.restores,
                "misses": self.misses,
                "evictions": self.evictions,
                "restoreFailures": self.restore_failures,
            }

    # -- spill / restore ----------------------------------------------------

    def put(self, key: bytes, k: np.ndarray, v: np.ndarray,
            k_scale: np.ndarray | None = None,
            v_scale: np.ndarray | None = None,
            quant: str | None = None, dtype: str | None = None) -> bool:
        """Spill one page. ``k``/``v``: [L, 1, ps, KVH, D] host arrays of
        wire dtype ``dtype`` (default numpy's name; "bfloat16" for uint16
        words). With ``quant`` (``int8-rows``) the arrays are already int8
        and the scales ride along verbatim; otherwise fp pages
        int8-quantize here per the tier policy. Returns False when the
        page exceeds the whole tier capacity."""
        if quant is None and self.spill_int8 and k.dtype != np.int8:
            k, k_scale = quantize_page(k, dtype)
            v, v_scale = quantize_page(v, dtype)
            quant, dtype = "int8-page", None
        header, payload = build_spill_header(
            key.hex(), self.model, k, v, dtype=dtype,
            k_scale=k_scale, v_scale=v_scale, quant=quant,
        )
        size = len(payload)
        if size > self.capacity_bytes:
            return False
        with self._lock:
            old = self._recs.pop(key, None)
            if old is not None:
                self._bytes -= len(old[1])
            self._recs[key] = (header, payload)
            self._bytes += size
            self.spills += 1
            while self._bytes > self.capacity_bytes and self._recs:
                oldest = next(iter(self._recs))
                if oldest == key and len(self._recs) == 1:
                    break
                _, dropped = self._recs.pop(oldest)
                self._bytes -= len(dropped)
                self.evictions += 1
                _EVICTIONS.inc(model=self.model)
        _SPILLS.inc(model=self.model)
        _SPILL_BYTES.inc(size, model=self.model)
        return True

    def get(self, key: bytes) -> tuple[
        np.ndarray, np.ndarray, np.ndarray | None, np.ndarray | None,
        str | None,
    ] | None:
        """Decode one page (LRU-promoted, NOT removed: the device copy the
        caller installs re-spills for free on its next eviction, the
        engine's spill hook skipping a key already held). Returns (k, v,
        k_scale, v_scale, quant) or None on a miss; a raw record (quant
        None) holds the spilling pool's dtype, bfloat16 as uint16 words.
        A failed digest/shape check counts as a restore
        failure and drops the record. Success accounting happens in
        :meth:`mark_restored`, only AFTER the caller lands the page on the
        device."""
        with self._lock:
            rec = self._recs.get(key)
            if rec is None:
                self.misses += 1
                _MISSES.inc(model=self.model)
                return None
            # promote: reinsert at the MRU end
            self._recs.pop(key)
            self._recs[key] = rec
        header, payload = rec
        try:
            asm = Assembler(dict(header))
            asm.feed_raw(payload)
            k, v, ks, vs = spill_arrays(header, asm.payload())
        except (WireError, ValueError) as e:
            self.note_restore_failure()
            self.drop(key)
            get_logger("kvtier").warning(
                "host-tier page failed integrity check; dropped",
                model=self.model, error=str(e))
            return None
        return k, v, ks, vs, header.get("quant")

    def mark_restored(self, key: bytes) -> None:
        with self._lock:
            rec = self._recs.get(key)
            size = len(rec[1]) if rec else 0
            self.restores += 1
        _RESTORES.inc(model=self.model)
        if size:
            _RESTORE_BYTES.inc(size, model=self.model)

    def note_restore_failure(self) -> None:
        with self._lock:
            self.restore_failures += 1
        _RESTORE_FAILURES.inc(model=self.model)

    def drop(self, key: bytes) -> None:
        with self._lock:
            rec = self._recs.pop(key, None)
            if rec is not None:
                self._bytes -= len(rec[1])

    def clear(self) -> None:
        with self._lock:
            self._recs.clear()
            self._bytes = 0
