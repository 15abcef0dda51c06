"""Versioned chunked wire format for paged-KV state migration.

The JAX package's transfer/wire.py, byte for byte on the wire: a KV
migration ships the longest cached full-page prefix of a request's prompt
from one worker to another, and a host-tier spill stores one evicted
prefix-cache page, in the same format. The wire carries:

- a JSON header: format version, request/model identity, pool geometry
  (page size, layer/head/dim counts), dtype, kvLayout (``ragged`` or
  ``legacy``, the attention mode of the pool that wrote it; the port's
  pools are never lane-padded), the weight-quant mode (info only), the
  token ids the pages cover, and a blake2b digest of the whole payload;
- a raw payload: K bytes then V bytes, each [L, n_pages, ps, KVH, D]
  C-contiguous in the header's dtype;
- chunk frames: the payload split into ``chunkBytes`` pieces, each with
  its sequence number and a crc32 (one bus message per chunk on
  ``kvx:{xfer_id}``), or the whole payload in one HTTP POST.

numpy has no bfloat16 (the JAX package reaches it through ml_dtypes, which
the port does not use): a bfloat16 page is held here as its raw 16-bit
words (``uint16``), with ``dtype="bfloat16"`` named by the caller, so the
header, payload, frames and digest equal the JAX package's for the same
pages. ``Assembler.arrays`` and ``spill_arrays`` return bfloat16 pages as
those words; ``as_float32`` decodes them exactly.
"""

from __future__ import annotations

import base64
import hashlib
import json
import zlib
from typing import Any

import numpy as np

WIRE_VERSION = 1

# wire dtype name → the numpy dtype its bytes are held in here
_WORDS = {"bfloat16": np.dtype(np.uint16)}


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a wire dtype's bytes (bfloat16 as its
    16-bit words)."""
    return _WORDS.get(name) or np.dtype(name)


def as_float32(x: np.ndarray, dtype: str) -> np.ndarray:
    """Pages of wire dtype `dtype` as float32 (exact; bfloat16 held as
    uint16 words)."""
    if dtype == "bfloat16":
        return (np.asarray(x, np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(x, np.float32)


def _dtype_name(x: np.ndarray, dtype: str | None) -> str:
    name = dtype or str(x.dtype)
    if np.dtype(x.dtype) != _np_dtype(name):
        raise ValueError(f"{name} pages must be held as {_np_dtype(name)}, got {x.dtype}")
    return name


def payload_bytes(k: np.ndarray, v: np.ndarray) -> bytes:
    """K then V, C-contiguous raw bytes."""
    return np.ascontiguousarray(k).tobytes() + np.ascontiguousarray(v).tobytes()


def build_header(
    request_id: str,
    model: str,
    tokens: list[int],
    k: np.ndarray,
    v: np.ndarray,
    *,
    dtype: str | None = None,
    kv_layout: str = "legacy",
    quant: str | None = None,
    chunk_bytes: int = 256 * 1024,
) -> tuple[dict[str, Any], bytes]:
    """(header, payload) for one export. ``k``/``v``: [L, n, ps, KVH, D]
    host arrays; ``dtype`` names their wire dtype where numpy's name is
    not it (``"bfloat16"`` for uint16 words)."""
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {k.shape} vs {v.shape}")
    if k.ndim != 5:
        raise ValueError(f"expected [L, n, ps, KVH, D] pages, got {k.shape}")
    name = _dtype_name(k, dtype)
    n_layers, n_pages, page_size, kv_heads, head_dim = k.shape
    if n_pages * page_size != len(tokens):
        raise ValueError(
            f"{n_pages} pages of {page_size} cover "
            f"{n_pages * page_size} tokens, not {len(tokens)}")
    payload = payload_bytes(k, v)
    chunk_bytes = max(int(chunk_bytes), 1)
    header = {
        "v": WIRE_VERSION,
        "requestId": request_id,
        "model": model,
        "dtype": name,
        "pageSize": page_size,
        "numLayers": n_layers,
        "kvHeads": kv_heads,
        "headDim": head_dim,
        "numPages": n_pages,
        "kvLayout": kv_layout,
        "quant": quant,
        "tokens": [int(t) for t in tokens],
        "totalBytes": len(payload),
        "chunkBytes": chunk_bytes,
        "numChunks": -(-len(payload) // chunk_bytes),
        "digest": hashlib.blake2b(payload, digest_size=16).hexdigest(),
    }
    return header, payload


def iter_chunks(header: dict[str, Any], payload: bytes):
    """Yield (seq, frame_json) chunk frames for the bus path."""
    cb = int(header["chunkBytes"])
    for seq in range(int(header["numChunks"])):
        piece = payload[seq * cb:(seq + 1) * cb]
        yield seq, json.dumps({
            "seq": seq,
            "crc": zlib.crc32(piece) & 0xFFFFFFFF,
            "data": base64.b64encode(piece).decode("ascii"),
        })


def build_spill_header(
    key_hex: str,
    model: str,
    k: np.ndarray,
    v: np.ndarray,
    *,
    dtype: str | None = None,
    k_scale: np.ndarray | None = None,
    v_scale: np.ndarray | None = None,
    quant: str | None = None,
    chunk_bytes: int = 256 * 1024,
) -> tuple[dict[str, Any], bytes]:
    """(header, payload) for ONE host-tier page spill: the migration wire
    addressed by the prefix cache's chain key instead of token ids.
    ``k``/``v``: [L, 1, ps, KVH, D] host arrays. ``quant`` names the scale
    layout riding in ``k_scale``/``v_scale`` (float32): ``int8-page`` = one
    scale per (layer, page), the spill quantization of an fp pool;
    ``int8-rows`` = the per-row scales of a resident int8 pool."""
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {k.shape} vs {v.shape}")
    if k.ndim != 5 or k.shape[1] != 1:
        raise ValueError(f"expected [L, 1, ps, KVH, D] page, got {k.shape}")
    if (k_scale is None) != (v_scale is None) or (
        (quant is None) != (k_scale is None)
    ):
        raise ValueError("quant and k_scale/v_scale travel together")
    name = _dtype_name(k, dtype)
    payload = payload_bytes(k, v)
    scale_shape: list[int] = []
    if k_scale is not None:
        k_scale = np.ascontiguousarray(k_scale, np.float32)
        v_scale = np.ascontiguousarray(v_scale, np.float32)
        if k_scale.shape != v_scale.shape:
            raise ValueError(
                f"scale shape mismatch: {k_scale.shape} vs {v_scale.shape}")
        scale_shape = list(k_scale.shape)
        payload += k_scale.tobytes() + v_scale.tobytes()
    n_layers, _, page_size, kv_heads, head_dim = k.shape
    chunk_bytes = max(int(chunk_bytes), 1)
    header = {
        "v": WIRE_VERSION,
        "kind": "kv-spill",
        "chainKey": key_hex,
        "model": model,
        "dtype": name,
        "pageSize": page_size,
        "numLayers": n_layers,
        "kvHeads": kv_heads,
        "headDim": head_dim,
        "numPages": 1,
        "quant": quant,
        "scaleShape": scale_shape,
        "totalBytes": len(payload),
        "chunkBytes": chunk_bytes,
        "numChunks": -(-len(payload) // chunk_bytes),
        "digest": hashlib.blake2b(payload, digest_size=16).hexdigest(),
    }
    return header, payload


def spill_arrays(
    header: dict[str, Any], payload: bytes
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None, np.ndarray | None]:
    """(k, v, k_scale, v_scale) from a verified spill payload (feed it
    through :class:`Assembler` first: that is what checks the digest)."""
    h = header
    dtype = _np_dtype(h["dtype"])
    shape = (int(h["numLayers"]), int(h["numPages"]), int(h["pageSize"]),
             int(h["kvHeads"]), int(h["headDim"]))
    n = int(np.prod(shape)) * dtype.itemsize
    scale_shape = tuple(int(s) for s in (h.get("scaleShape") or []))
    sn = int(np.prod(scale_shape)) * 4 if scale_shape else 0
    if len(payload) != 2 * n + 2 * sn:
        raise WireError(
            f"spill payload {len(payload)} bytes does not match "
            f"2×{n} + 2×{sn} for shape {shape} {h['dtype']}")
    k = np.frombuffer(payload[:n], dtype=dtype).reshape(shape)
    v = np.frombuffer(payload[n:2 * n], dtype=dtype).reshape(shape)
    k_scale = v_scale = None
    if sn:
        k_scale = np.frombuffer(
            payload[2 * n:2 * n + sn], dtype=np.float32).reshape(scale_shape)
        v_scale = np.frombuffer(
            payload[2 * n + sn:], dtype=np.float32).reshape(scale_shape)
    return k, v, k_scale, v_scale


class WireError(RuntimeError):
    """Integrity/shape failure during reassembly: the import is aborted
    and the sender falls back to local serving."""


class Assembler:
    """Reassemble one transfer from chunk frames (bus) or the whole
    payload (HTTP). Duplicate chunks are ignored; crc32 guards each
    chunk, the header digest guards the whole payload."""

    def __init__(self, header: dict[str, Any]):
        if int(header.get("v", -1)) != WIRE_VERSION:
            raise WireError(f"unsupported wire version {header.get('v')!r}")
        self.header = header
        self.total = int(header["numChunks"])
        self._chunks: dict[int, bytes] = {}
        self._payload: bytes | None = None

    @property
    def received(self) -> int:
        return len(self._chunks)

    @property
    def contiguous(self) -> int:
        """Highest seq N such that chunks 0..N-1 all arrived: the receiver
        advertises it for sender-side backpressure."""
        n = 0
        while n in self._chunks:
            n += 1
        return n

    @property
    def complete(self) -> bool:
        return self._payload is not None or len(self._chunks) >= self.total

    def feed(self, frame: str) -> bool:
        """One bus chunk frame; returns True when the transfer completed."""
        rec = json.loads(frame)
        seq = int(rec["seq"])
        if seq < 0 or seq >= self.total or seq in self._chunks:
            return self.complete
        piece = base64.b64decode(rec["data"])
        if (zlib.crc32(piece) & 0xFFFFFFFF) != int(rec["crc"]):
            raise WireError(f"crc mismatch on chunk {seq}")
        self._chunks[seq] = piece
        return self.complete

    def feed_raw(self, payload: bytes) -> bool:
        """The HTTP path: the whole payload in one body."""
        self._payload = payload
        return True

    def payload(self) -> bytes:
        if self._payload is None:
            if not self.complete:
                raise WireError(
                    f"incomplete transfer: {self.received}/{self.total}")
            self._payload = b"".join(
                self._chunks[i] for i in range(self.total))
        if len(self._payload) != int(self.header["totalBytes"]):
            raise WireError(
                f"payload size {len(self._payload)} != "
                f"{self.header['totalBytes']}")
        digest = hashlib.blake2b(self._payload, digest_size=16).hexdigest()
        if digest != self.header["digest"]:
            raise WireError("payload digest mismatch")
        return self._payload

    def arrays(self) -> tuple[list[int], np.ndarray, np.ndarray]:
        """(tokens, k, v) with k/v reshaped to [L, n, ps, KVH, D] (bfloat16
        as uint16 words)."""
        h = self.header
        payload = self.payload()
        dtype = _np_dtype(h["dtype"])
        shape = (int(h["numLayers"]), int(h["numPages"]), int(h["pageSize"]),
                 int(h["kvHeads"]), int(h["headDim"]))
        n = int(np.prod(shape)) * dtype.itemsize
        if len(payload) != 2 * n:
            raise WireError(
                f"payload {len(payload)} bytes does not match 2×{n} for "
                f"shape {shape} {h['dtype']}")
        k = np.frombuffer(payload[:n], dtype=dtype).reshape(shape)
        v = np.frombuffer(payload[n:], dtype=dtype).reshape(shape)
        return [int(t) for t in h["tokens"]], k, v
