"""Per-request span timelines, stitched gateway↔worker over the bus.

A ``Span`` is a named wall-clock interval (or point event) tied to a
``request_id``. The gateway's :class:`Tracer` records the control-plane
stages (receive, queue-wait, dispatch, first-token, complete); each worker
records its execution stages (execute, prefill, decode) on its OWN tracer
and publishes the finished timeline on ``trace:{request_id}`` when the job
resolves. The gateway psubscribes ``trace:*`` (scheduler.initialize) and
merges what arrives, so ``GET /admin/trace/{request_id}`` returns ONE
timeline spanning both sides.

Timestamps are epoch seconds (``time.time()``) — stitching relies on the
hosts' clocks, which is exactly what a distributed trace can honestly
offer without a clock-sync protocol; same-host deployments (and the whole
test suite) are exact.

Storage is bounded: finished timelines are an LRU of ``max_traces``; spans
still open when a request is finished/aborted are closed with an
``aborted`` marker rather than leaked (the chaos tests assert
``active_count() == 0`` after timeout storms). Pure stdlib.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Iterator

# The trace channel family is registered in the bus channel registry
# (bus/base.py, family "trace") but its helpers live HERE: bus/base
# imports obs.metrics, so importing back from obs would be circular.
# The channel-discipline rule resolves this constant inside the helper
# and verifies it against the registered pattern, so the spellings
# cannot drift.
TRACE_CHANNEL_PREFIX = "trace:"


def trace_channel(request_id: str) -> str:
    return f"{TRACE_CHANNEL_PREFIX}{request_id}"


def trace_pattern() -> str:
    """Glob pattern covering every trace channel (psubscribe)."""
    return f"{TRACE_CHANNEL_PREFIX}*"


class Span:
    __slots__ = ("request_id", "name", "source", "start", "end", "meta")

    def __init__(self, request_id: str, name: str, source: str,
                 start: float | None = None, end: float | None = None,
                 meta: dict[str, Any] | None = None):
        self.request_id = request_id
        self.name = name
        self.source = source
        self.start = time.time() if start is None else start
        self.end = end
        self.meta = meta or {}

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "source": self.source,
            "start": self.start,
            "end": self.end,
        }
        if self.end is not None:
            d["durationMs"] = round((self.end - self.start) * 1000, 3)
        if self.meta:
            d["meta"] = self.meta
        return d

    @classmethod
    def from_dict(cls, request_id: str, d: dict[str, Any]) -> "Span":
        return cls(
            request_id,
            str(d.get("name", "?")),
            str(d.get("source", "?")),
            start=float(d.get("start") or 0.0),
            end=None if d.get("end") is None else float(d["end"]),
            meta=dict(d.get("meta") or {}),
        )


class Tracer:
    """Thread-safe span store for one process role (gateway or worker)."""

    def __init__(self, source: str = "gateway", max_traces: int = 512):
        self.source = source
        self.max_traces = max_traces
        self._lock = threading.Lock()
        self._open: dict[str, list[Span]] = {}      # request → open spans
        self._closed: dict[str, list[Span]] = {}    # request → closed spans
        self._done: OrderedDict[str, list[Span]] = OrderedDict()  # LRU

    # -- recording ----------------------------------------------------------
    def begin(self, request_id: str, name: str, **meta: Any) -> Span:
        span = Span(request_id, name, self.source, meta=meta)
        with self._lock:
            self._open.setdefault(request_id, []).append(span)
        return span

    def end(self, span: Span, **meta: Any) -> Span:
        with self._lock:
            if span.end is None:
                span.end = time.time()
                span.meta.update(meta)
                opens = self._open.get(span.request_id, [])
                if span in opens:
                    opens.remove(span)
                    if not opens:
                        del self._open[span.request_id]
                self._closed.setdefault(span.request_id, []).append(span)
                self._absorb_locked(span.request_id)
            elif meta:
                # a seal (scheduler-side failure/timeout abort) raced ahead
                # of the span's owner and force-closed it — the owner's
                # metadata (outcome etc.) must still land, and the span DID
                # get a proper end, so drop the seal's aborted marker
                span.meta.pop("aborted", None)
                span.meta.update(meta)
        return span

    @contextmanager
    def span(self, request_id: str, name: str, **meta: Any) -> Iterator[Span]:
        s = self.begin(request_id, name, **meta)
        try:
            yield s
        finally:
            self.end(s)

    def event(self, request_id: str, name: str, **meta: Any) -> Span:
        """Point-in-time mark: a zero-duration span."""
        now = time.time()
        span = Span(request_id, name, self.source, start=now, end=now,
                    meta=meta)
        with self._lock:
            self._closed.setdefault(request_id, []).append(span)
            self._absorb_locked(request_id)
        return span

    def record(self, request_id: str, name: str, start: float, end: float,
               **meta: Any) -> Span:
        """Add an already-measured interval (e.g. derived from engine
        timings) with explicit timestamps."""
        span = Span(request_id, name, self.source, start=start, end=end,
                    meta=meta)
        with self._lock:
            self._closed.setdefault(request_id, []).append(span)
            self._absorb_locked(request_id)
        return span

    def _absorb_locked(self, request_id: str) -> None:
        """Called with the lock held after a span lands in ``_closed``.
        Spans recorded AFTER a request's timeline was sealed (e.g. a
        retry event arriving once the waiter timed out and finished the
        trace) fold straight into the bounded finished LRU rather than
        accumulating in ``_closed``; and ``_closed`` itself is hard-capped
        by force-sealing its oldest request, so a request that never
        reaches a terminal seal cannot grow gateway memory without bound."""
        if request_id in self._done and request_id not in self._open:
            self._merge_done_locked(request_id, self._closed.pop(request_id))
        if len(self._closed) > self.max_traces:
            for rid in list(self._closed):  # oldest-first insertion order
                if len(self._closed) <= self.max_traces:
                    break
                if rid in self._open:  # still live — skip, not worth sealing
                    continue
                self._merge_done_locked(rid, self._closed.pop(rid))

    def _merge_done_locked(self, request_id: str, extra: list[Span]) -> None:
        spans = self._done.pop(request_id, []) + extra
        spans.sort(key=lambda s: (s.start, s.end or s.start))
        self._done[request_id] = spans
        self._trim_done_locked()

    def _trim_done_locked(self) -> None:
        """LRU-evict finished timelines — but never a request that still
        has OPEN spans here: evicting it would silently drop its already-
        ingested worker half, and the later finish() would re-insert only
        the gateway half (a half-merged timeline for a live request).
        If every entry is open (pathological), evict oldest anyway —
        bounded memory beats a perfect timeline."""
        while len(self._done) > self.max_traces:
            victim = next(
                (rid for rid in self._done if rid not in self._open), None)
            if victim is None:
                self._done.popitem(last=False)
                continue
            del self._done[victim]

    # -- lifecycle ----------------------------------------------------------
    def finish(self, request_id: str) -> list[dict[str, Any]]:
        """Move a request's spans to the finished LRU (closing any still
        open with an aborted marker) and return the serialized timeline."""
        return self._seal(request_id, reason="")

    def abort(self, request_id: str, reason: str = "aborted") -> None:
        """Close every open span for the request (timeout/cancel paths must
        never leak an active span) and seal the timeline. Idempotent."""
        self._seal(request_id, reason=reason)

    def _seal(self, request_id: str, reason: str) -> list[dict[str, Any]]:
        now = time.time()
        with self._lock:
            opens = self._open.pop(request_id, [])
            for s in opens:
                # a span still open at seal time is abnormal whichever path
                # sealed it (clean finish should have ended everything)
                s.end = now
                s.meta.setdefault("aborted", True)
                if reason:
                    s.meta.setdefault("reason", reason)
            spans = self._done.pop(request_id, [])
            spans += self._closed.pop(request_id, [])
            spans += opens
            if not spans:
                return []
            spans.sort(key=lambda s: (s.start, s.end or s.start))
            self._done[request_id] = spans
            self._trim_done_locked()
            return [s.to_dict() for s in spans]

    def ingest(self, request_id: str, span_dicts: list[dict[str, Any]]) -> None:
        """Merge remote spans (a worker's published timeline) into the
        finished store, preserving chronological order. Each publication
        carries the publishing side's FULL timeline (finish() re-seals), so
        a re-publication — e.g. a worker that NACKed earlier and later ran
        the job — REPLACES that source's spans rather than duplicating them.

        Incoming spans that are still OPEN (a flight-recorder dump of a
        dying worker's active spans — normal publications are sealed by
        finish()) are closed here with an aborted marker: the publisher is
        never coming back to end them, and /admin/trace must not serve a
        half-merged timeline with remote spans dangling open forever."""
        incoming = [Span.from_dict(request_id, d) for d in span_dicts]
        if not incoming:
            return
        for s in incoming:
            if s.end is None:
                s.end = s.start
                s.meta.setdefault("aborted", True)
                s.meta.setdefault("reason", "unsealed_at_publish")
        sources = {s.source for s in incoming}
        with self._lock:
            # requests still in flight gateway-side keep their open/closed
            # spans where they are; they join at finish()/abort()
            kept = [s for s in self._done.pop(request_id, [])
                    if s.source not in sources]
            spans = kept + incoming
            spans.sort(key=lambda s: (s.start, s.end or s.start))
            self._done[request_id] = spans
            self._trim_done_locked()

    # -- queries ------------------------------------------------------------
    def export(self, request_id: str) -> list[dict[str, Any]] | None:
        """The stitched timeline for a request (finished + still-recording
        spans), or None if the tracer has never seen it."""
        with self._lock:
            done = self._done.get(request_id)
            closed = self._closed.get(request_id)
            opens = self._open.get(request_id)
            if done is None and closed is None and opens is None:
                return None
            spans = list(done or []) + list(closed or []) + list(opens or [])
        spans.sort(key=lambda s: (s.start, s.end or s.start))
        return [s.to_dict() for s in spans]

    def active_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._open.values())

    def active_ids(self) -> list[str]:
        with self._lock:
            return list(self._open)

    def ids(self) -> list[str]:
        with self._lock:
            return list(self._done)
