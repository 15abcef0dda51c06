"""KV-page migration: sender/receiver machinery over the bus (+ HTTP).

The JAX package's transfer/migrate.py on the port's bus, for the data
plane of disaggregated serving and of drain by migration. One migration:

1. The scheduler assigns the job to a PREFILL worker with a planned
   decode target in ``metadata.disagg`` (or a draining worker picks a
   peer itself).
2. The sender exports the prompt's cached full-page KV prefix and calls
   :func:`send_kv`:
   - a ``kv_import`` prepare message (carrying the wire header) goes to
     the target's job channel; its :class:`KVImportManager` subscribes
     ``kvx:{xfer}`` and sets the ready key;
   - the payload streams as crc-checked chunk frames with windowed
     backpressure against the receiver's advertised contiguous-seq key,
     or, past ``GRIDLLM_KVX_HTTP_BYTES``, as ONE direct worker-to-worker
     HTTP POST to the target's health port (``/kvx/{id}``);
   - the receiver verifies the digest, installs the pages through its
     engine's ref-counted allocator (they join the content-addressed
     prefix cache at once), and sets the ack key.
3. On a positive ack the sender hands the job off; any failure or timeout
   falls back to serving the request locally: the transfer is an
   optimization, never a correctness dependency.

All coordination uses bus KEYS (TTL'd), not pub/sub, where ordering
matters (ready/recv/ack): pub/sub has no replay.

Env knobs (documented in README "Disaggregated serving"):
  GRIDLLM_KVX_CHUNK_BYTES   chunk size for the bus path (default 262144)
  GRIDLLM_KVX_WINDOW        chunks in flight before awaiting recv
                            progress (default 8)
  GRIDLLM_KVX_TIMEOUT_MS    end-to-end transfer deadline (default 15000)
  GRIDLLM_KVX_HTTP_BYTES    payload size beyond which the direct HTTP
                            path is tried first (default 8388608)
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Any, Callable

from gridllm_torch import faults
from gridllm_torch.bus.base import kvx_channel, worker_job_channel
from gridllm_torch.obs import default_flight_recorder, default_registry
from gridllm_torch.transfer.wire import Assembler, WireError, iter_chunks
from gridllm_torch.utils.config import env_int_lenient
from gridllm_torch.utils.logging import get_logger

log = get_logger("transfer")

# migration accounting on the process registry (the JAX series)
_OBS = default_registry()
_MIGRATIONS = _OBS.counter(
    "gridllm_kv_migrations_total",
    "KV-page migrations by side (send/recv) and outcome (ok/failed/"
    "timeout/released/rejected).",
    ("side", "outcome"),
)
_MIG_BYTES = _OBS.histogram(
    "gridllm_kv_migration_bytes",
    "Payload bytes per completed KV migration (sender side).",
    buckets=(1e4, 1e5, 1e6, 1e7, 1e8, 1e9),
)
_MIG_SECONDS = _OBS.histogram(
    "gridllm_kv_migration_seconds",
    "Wall seconds per KV migration attempt (sender side, prepare → ack).",
)
_MIG_INFLIGHT = _OBS.gauge(
    "gridllm_kv_migrations_inflight",
    "KV migrations currently in flight in this process (both sides).",
)


def ready_key(xfer_id: str) -> str:
    return f"kvx:ready:{xfer_id}"


def recv_key(xfer_id: str) -> str:
    return f"kvx:recv:{xfer_id}"


def ack_key(xfer_id: str) -> str:
    return f"kvx:ack:{xfer_id}"


def kvx_settings() -> dict[str, int]:
    # lenient reads: these are resolved mid-migration, never at startup —
    # a malformed knob must degrade to the registry default, not fail the
    # handoff after prefill+export already succeeded
    return {
        "chunk_bytes": max(env_int_lenient("GRIDLLM_KVX_CHUNK_BYTES"), 1),
        "window": max(env_int_lenient("GRIDLLM_KVX_WINDOW"), 1),
        "timeout_ms": max(env_int_lenient("GRIDLLM_KVX_TIMEOUT_MS"), 1),
        "http_bytes": max(env_int_lenient("GRIDLLM_KVX_HTTP_BYTES"), 0),
    }


async def _poll_key(bus, key: str, deadline: float,
                    interval: float = 0.02) -> str | None:
    """Poll a bus key until it appears or the deadline passes."""
    while True:
        val = await bus.get(key)
        if val is not None:
            return val
        if time.monotonic() >= deadline:
            return None
        await asyncio.sleep(interval)


async def _send_http(addr: str, request_id: str, payload: bytes,
                     timeout_s: float) -> dict[str, Any] | None:
    """Direct worker-to-worker POST of the whole payload; returns the
    receiver's ack dict, or None when the HTTP path is unusable (caller
    falls back to bus chunks)."""
    try:
        import aiohttp
    except ImportError:   # the HTTP path needs aiohttp; the bus path does not
        return None

    url = f"http://{addr}/kvx/{request_id}"
    try:
        async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=timeout_s)
        ) as sess:
            async with sess.post(url, data=payload) as resp:
                return await resp.json()
    except Exception as e:  # noqa: BLE001 — any transport failure → bus path
        log.warning("kvx http path failed; falling back to bus",
                    request_id=request_id, addr=addr, error=str(e))
        return None


async def send_kv(
    bus,
    request_id: str,
    target_worker: str,
    header: dict[str, Any],
    payload: bytes,
    *,
    target_addr: str | None = None,
    from_worker: str = "",
    aborted: set[str] | None = None,
    settings: dict[str, int] | None = None,
) -> tuple[bool, str, dict[str, Any]]:
    """Run one migration as the sender. Returns (ok, reason, stats);
    ``ok=False`` means the caller must serve the request locally.

    ``aborted`` is the worker's live set of released/cancelled job ids —
    checked between windows so a ``kv_release`` (scheduler orphan path)
    stops the stream promptly instead of timing out."""
    import uuid

    s = settings or kvx_settings()
    t0 = time.monotonic()
    deadline = t0 + s["timeout_ms"] / 1000.0
    # per-ATTEMPT transfer id: the chunk channel and every coordination
    # key are namespaced by it, never by the request id alone — a
    # requeued job's fresh migration must not consume the TTL'd ack (or
    # straggler chunks) of a released earlier attempt
    xfer = uuid.uuid4().hex
    stats: dict[str, Any] = {"bytes": len(payload), "path": "bus",
                             "chunks": int(header["numChunks"])}
    _MIG_INFLIGHT.inc()
    try:
        # kvx.send fault site (faults.py): an injected failure takes the
        # same except-path a dead transport would — the sender serves the
        # request locally and the migration is counted failed
        faults.inject("kvx.send")
        # receiver prepare: the decode worker's KVImportManager subscribes
        # the chunk channel and sets the ready key (header travels here,
        # out of band of the chunk stream)
        await bus.publish(worker_job_channel(target_worker), json.dumps({
            "type": "kv_import",
            "jobId": request_id,
            "xfer": xfer,
            "fromWorker": from_worker,
            "header": header,
        }))
        # wait for readiness, but also watch the ack key: a prepare-time
        # rejection (bad header / wire-version mismatch) NACKs without
        # ever becoming ready, and the sender must fall back immediately
        # instead of eating the whole transfer timeout
        while True:
            if await bus.get(ready_key(xfer)) is not None:
                break
            raw_nack = await bus.get(ack_key(xfer))
            if raw_nack is not None:
                ack = json.loads(raw_nack)
                _MIGRATIONS.inc(side="send", outcome="rejected")
                return False, str(ack.get("error") or "import_rejected"), stats
            if time.monotonic() >= deadline:
                _MIGRATIONS.inc(side="send", outcome="timeout")
                return False, "receiver_not_ready", stats
            await asyncio.sleep(0.02)

        # a kv_release may have landed while awaiting readiness — stop
        # BEFORE committing the payload to either path (the HTTP path in
        # particular would otherwise upload the whole thing just to be 409'd)
        if aborted is not None and request_id in aborted:
            _MIGRATIONS.inc(side="send", outcome="released")
            return False, "released", stats

        sent_via_http = False
        if target_addr and s["http_bytes"] and len(payload) >= s["http_bytes"]:
            ack = await _send_http(
                target_addr, request_id, payload,
                timeout_s=max(deadline - time.monotonic(), 0.1))
            if ack is not None:
                stats["path"] = "http"
                sent_via_http = True
                stats["seconds"] = time.monotonic() - t0
                if ack.get("ok"):
                    stats["tokens"] = int(ack.get("tokens", 0))
                    _MIGRATIONS.inc(side="send", outcome="ok")
                    _MIG_BYTES.observe(len(payload))
                    _MIG_SECONDS.observe(stats["seconds"])
                    return True, "", stats
                _MIGRATIONS.inc(side="send", outcome="rejected")
                return False, str(ack.get("error") or "import_rejected"), stats

        if not sent_via_http:
            # bus path: windowed chunk stream with receiver-driven
            # backpressure — never more than `window` chunks past the
            # receiver's advertised contiguous sequence number
            window = s["window"]
            for seq, frame in iter_chunks(header, payload):
                if aborted is not None and request_id in aborted:
                    _MIGRATIONS.inc(side="send", outcome="released")
                    return False, "released", stats
                while seq - await _recv_progress(bus, xfer) >= window:
                    if time.monotonic() >= deadline:
                        _MIGRATIONS.inc(side="send", outcome="timeout")
                        return False, "backpressure_timeout", stats
                    await asyncio.sleep(0.01)
                await bus.publish(kvx_channel(xfer), frame)

        raw_ack = await _poll_key(bus, ack_key(xfer), deadline)
        stats["seconds"] = time.monotonic() - t0
        if raw_ack is None:
            _MIGRATIONS.inc(side="send", outcome="timeout")
            return False, "ack_timeout", stats
        ack = json.loads(raw_ack)
        if not ack.get("ok"):
            _MIGRATIONS.inc(side="send", outcome="rejected")
            return False, str(ack.get("error") or "import_rejected"), stats
        stats["tokens"] = int(ack.get("tokens", 0))
        _MIGRATIONS.inc(side="send", outcome="ok")
        _MIG_BYTES.observe(len(payload))
        _MIG_SECONDS.observe(stats["seconds"])
        return True, "", stats
    except Exception as e:  # noqa: BLE001 — transfer failure → local fallback
        stats["seconds"] = time.monotonic() - t0
        _MIGRATIONS.inc(side="send", outcome="failed")
        log.warning("kv migration send failed", request_id=request_id,
                    error=str(e))
        return False, f"send_error:{e}", stats
    finally:
        _MIG_INFLIGHT.dec()


async def _recv_progress(bus, xfer_id: str) -> int:
    raw = await bus.get(recv_key(xfer_id))
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


class _Import:
    __slots__ = ("assembler", "sub", "from_worker", "started", "finalizing",
                 "expire_task", "xfer")

    def __init__(self, assembler: Assembler, from_worker: str, xfer: str):
        self.assembler = assembler
        self.sub = None
        self.from_worker = from_worker
        self.started = time.monotonic()
        self.finalizing = False
        self.expire_task: asyncio.Task | None = None
        self.xfer = xfer  # per-attempt id namespacing channel + keys


class KVImportManager:
    """Decode-side receiver: one instance per WorkerService.

    ``resolve_engine(model)`` must return the engine whose pool the
    pages install into (WorkerService._resolve_engine). Installed pages
    land refcount-0 in the engine's content-addressed prefix cache, so
    the decode job's normal admission (``match_prefix``) finds them —
    the warm-path replay then yields a token stream bit-identical to
    unified serving in float32."""

    def __init__(self, bus, resolve_engine: Callable[[str], Any],
                 worker_id: str = "", tracer=None):
        self.bus = bus
        self.resolve_engine = resolve_engine
        self.worker_id = worker_id
        self.tracer = tracer
        self.imported: dict[str, int] = {}  # request_id → tokens installed
        # request_id → payload bytes imported, popped once into the usage
        # attribution of the decode job's result
        self.imported_bytes: dict[str, int] = {}
        self._pending: dict[str, _Import] = {}
        self.flightrec = default_flight_recorder()

    def take_imported_bytes(self, rid: str) -> int:
        """Pop the migrated-bytes tally for a request (0 if none) —
        consumed exactly once by the decode worker's usage payload."""
        return self.imported_bytes.pop(rid, 0)

    @property
    def inflight(self) -> int:
        return len(self._pending)

    async def prepare(self, msg: dict[str, Any]) -> None:
        """Handle a ``kv_import`` prepare message: subscribe the chunk
        channel, then advertise readiness via the ready key. A fresh
        attempt for a job we already hold state for SUPERSEDES it — the
        old attempt's sender is gone (requeue/replan) and its partial
        assembly must not swallow the new stream."""
        rid = str(msg.get("jobId") or "")
        header = msg.get("header")
        xfer = str(msg.get("xfer") or rid)
        if not rid or not isinstance(header, dict):
            return
        old = self._pending.get(rid)
        if old is not None:
            if old.xfer == xfer:
                return  # duplicate prepare for the same attempt
            await self._finish(rid, ok=False, error="superseded")
        try:
            state = _Import(Assembler(header),
                            str(msg.get("fromWorker") or ""), xfer)
        except WireError as e:
            await self._ack(xfer, ok=False, error=str(e))
            return
        self._pending[rid] = state
        _MIG_INFLIGHT.inc()

        async def on_chunk(_ch: str, frame: str) -> None:
            await self._feed(rid, frame)

        state.sub = await self.bus.subscribe(kvx_channel(xfer), on_chunk)

        # sender-failure safety net: a sender that crashes or falls back
        # mid-stream never completes this transfer, and the scheduler's
        # kv_release only covers the paths it sees (fallback handoff,
        # orphan) — expire the assembly state locally so buffered chunks
        # and the subscription can never leak for the process lifetime
        ttl_s = max(kvx_settings()["timeout_ms"] / 1000.0 * 2, 30.0)

        async def expire() -> None:
            await asyncio.sleep(ttl_s)
            cur = self._pending.get(rid)
            if cur is state and not state.finalizing:
                log.warning("kv import expired; dropping partial state",
                            request_id=rid, received=state.assembler.received)
                _MIGRATIONS.inc(side="recv", outcome="timeout")
                await self._finish(rid, ok=False, error="receive timeout")

        state.expire_task = asyncio.ensure_future(expire())
        await self.bus.set_with_expiry(ready_key(xfer), "1", ttl_s=60.0)

    async def _feed(self, rid: str, frame: str) -> None:
        state = self._pending.get(rid)
        if state is None or state.finalizing:
            return
        try:
            done = state.assembler.feed(frame)
            # advertise contiguous progress for sender backpressure
            await self.bus.set_with_expiry(
                recv_key(state.xfer), str(state.assembler.contiguous),
                ttl_s=60.0)
        except WireError as e:
            await self._finish(rid, ok=False, error=str(e))
            return
        if done:
            state.finalizing = True
            await self._finalize(rid)

    async def feed_http(self, rid: str, payload: bytes) -> dict[str, Any]:
        """The direct HTTP path: whole payload in one body. The prepare
        message must have arrived first (it carries the header)."""
        state = self._pending.get(rid)
        if state is None:
            return {"ok": False, "error": "no pending import (prepare "
                                          "message not seen)"}
        if state.finalizing:
            return {"ok": False, "error": "import already finalizing"}
        state.finalizing = True
        state.assembler.feed_raw(payload)
        return await self._finalize(rid)

    async def _finalize(self, rid: str) -> dict[str, Any]:
        state = self._pending.get(rid)
        assert state is not None
        t0 = time.time()  # tracer spans use wall-clock epoch seconds
        try:
            # kvx.import fault site: the receiver NACKs exactly as it
            # would on a digest/geometry mismatch; the sender falls back
            faults.inject("kvx.import")
            tokens_list, k, v = state.assembler.arrays()
            header = state.assembler.header
            engine = self.resolve_engine(header.get("model", ""))
            if engine is None:
                raise WireError(f"model not served here: {header.get('model')}")
            installed = await asyncio.to_thread(
                engine.import_prefix_pages, tokens_list, k, v, header)
            self.imported[rid] = installed
            while len(self.imported) > 256:  # bounded: newest kept
                self.imported.pop(next(iter(self.imported)))
            self.imported_bytes[rid] = int(header["totalBytes"])
            while len(self.imported_bytes) > 256:
                self.imported_bytes.pop(next(iter(self.imported_bytes)))
            if self.tracer is not None:
                self.tracer.record(
                    rid, "kvx.import", t0, time.time(),
                    tokens=installed, bytes=int(header["totalBytes"]),
                    fromWorker=state.from_worker)
            _MIGRATIONS.inc(side="recv", outcome="ok")
            self.flightrec.record(
                "transfer", "kv_imported", request=rid,
                worker=self.worker_id, tokens=installed,
                bytes=int(header["totalBytes"]))
            return await self._finish(rid, ok=True, tokens=installed)
        except Exception as e:  # noqa: BLE001 — NACK the sender, never crash
            _MIGRATIONS.inc(side="recv", outcome="failed")
            log.warning("kv import failed", request_id=rid, error=str(e))
            return await self._finish(rid, ok=False, error=str(e))

    async def _finish(self, rid: str, ok: bool, tokens: int = 0,
                      error: str = "") -> dict[str, Any]:
        state = self._pending.pop(rid, None)
        xfer = state.xfer if state is not None else rid
        ack: dict[str, Any] = {"ok": ok, "tokens": tokens}
        if error:
            ack["error"] = error
        # Synchronous cleanup first (gauge + expire timer survive any
        # cancellation below), then the ack, then the unsubscribe —
        # strictly in that order. _finish usually runs inside the chunk
        # channel's OWN handler pump, and unsubscribing that subscription
        # cancels the very task executing this coroutine; before this
        # ordering the CancelledError landed mid-ack (the sender saw a
        # timeout) while desyncing the bus connection's reply stream.
        # The unsubscribe is detached (and exception-guarded — the bus
        # may be dead by now) from a finally so it runs even when the
        # ack itself is cancelled.
        if state is not None:
            _MIG_INFLIGHT.dec()
            if (state.expire_task is not None
                    and state.expire_task is not asyncio.current_task()):
                state.expire_task.cancel()
        try:
            await self._ack(xfer, **ack)
        finally:
            if state is not None and state.sub is not None:
                sub = state.sub

                async def _unsub() -> None:
                    try:
                        await sub.unsubscribe()
                    except Exception:  # noqa: BLE001 — bus may be gone
                        pass

                asyncio.ensure_future(_unsub())
        return ack

    async def _ack(self, xfer_id: str, **ack: Any) -> None:
        try:
            await self.bus.set_with_expiry(
                ack_key(xfer_id), json.dumps(ack), ttl_s=60.0)
        except Exception as e:  # noqa: BLE001
            log.warning("kvx ack publish failed", xfer=xfer_id,
                        error=str(e))

    async def release(self, rid: str) -> None:
        """Scheduler-driven release (orphaned mid-migration): drop any
        partially assembled state and stop listening. Pages already
        installed are refcount-0 cached content — valid KV for their
        token prefix — so they stay in the LRU and age out normally."""
        if rid in self._pending:
            _MIGRATIONS.inc(side="recv", outcome="released")
            self.flightrec.record("transfer", "kv_released", request=rid,
                                  worker=self.worker_id)
            await self._finish(rid, ok=False, error="released")

    async def shutdown(self) -> None:
        for rid in list(self._pending):
            await self._finish(rid, ok=False, error="worker stopping")
