"""The fleet-wide causal event timeline (the JAX package's obs/timeline.py).

Every member stamps its flight-recorder lifecycle events, plus bus send
and receive edges, with a hybrid logical clock (HLC: physical milliseconds
plus a logical counter, merged on every bus message received), batches
them on a bounded queue, and publishes them on the durable ``obs:event``
channel. A member running a `TimelineStore` (the gateway) subscribes that
channel and answers ``GET /admin/timeline/{request_id}`` with the causal
slice of one request stitched across members; obs/forensics.py assembles
incident reports from the same store. A worker only publishes. The HLC
framing of bus payloads is the JAX package's byte for byte, so JAX and
torch members share one bus.

The publisher never blocks an emitter: events land in a lock-guarded
deque; when the flush task cannot drain it, the oldest events are dropped
and counted (``gridllm_timeline_dropped_events_total``).

bus/base.py imports this module's HLC helpers at top level, so nothing
here imports bus code at module level: channel constants are imported
inside methods. Pure stdlib.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable

from gridllm_torch.obs.metrics import default_registry
from gridllm_torch.utils.logging import get_logger

log = get_logger("obs.timeline")


# -- hybrid logical clock ----------------------------------------------------


@dataclass(frozen=True, order=True)
class HLCStamp:
    """One HLC reading: orders by (wall_ms, logical, member) — the member
    id is the deterministic tie-break between concurrent events, never a
    statement about real time."""

    wall_ms: int
    logical: int
    member: str = ""

    def encode(self) -> str:
        return f"{self.wall_ms},{self.logical},{self.member}"

    @classmethod
    def parse(cls, raw: str) -> "HLCStamp":
        wall, logical, member = raw.split(",", 2)
        return cls(int(wall), int(logical), member)

    def to_list(self) -> list[Any]:
        return [self.wall_ms, self.logical, self.member]

    @classmethod
    def from_list(cls, raw: Any) -> "HLCStamp | None":
        try:
            wall, logical, member = raw
            return cls(int(wall), int(logical), str(member))
        except Exception:
            return None


class HLC:
    """Hybrid logical clock (Kulkarni et al.): ``tick()`` stamps local
    events and sends, ``update()`` merges a remote stamp on receive.
    Both are monotone; ``update()`` always returns a stamp ordered after
    the remote one, so a received message provably happens-after its
    send even when the hosts' physical clocks disagree by minutes.
    ``now_fn`` is injectable so tests can skew one member's clock."""

    def __init__(self, member: str = "",
                 now_fn: Callable[[], float] = time.time):
        self.member = member
        self.now_fn = now_fn
        self._wall = 0
        self._logical = 0
        self._lock = threading.Lock()

    def _now_ms(self) -> int:
        return int(self.now_fn() * 1000)

    def set_member(self, member: str) -> None:
        self.member = member

    def tick(self) -> HLCStamp:
        """Advance for a local event or a message send."""
        with self._lock:
            now = self._now_ms()
            if now > self._wall:
                self._wall, self._logical = now, 0
            else:
                self._logical += 1
            return HLCStamp(self._wall, self._logical, self.member)

    def update(self, remote: HLCStamp) -> HLCStamp:
        """Merge a remote stamp on message receive; the returned stamp is
        strictly after both the local clock and ``remote``."""
        with self._lock:
            now = self._now_ms()
            if now > self._wall and now > remote.wall_ms:
                self._wall, self._logical = now, 0
            elif remote.wall_ms > self._wall:
                self._wall = remote.wall_ms
                self._logical = remote.logical + 1
            elif self._wall > remote.wall_ms:
                self._logical += 1
            else:
                self._logical = max(self._logical, remote.logical) + 1
            return HLCStamp(self._wall, self._logical, self.member)

    def peek(self) -> HLCStamp:
        with self._lock:
            return HLCStamp(self._wall, self._logical, self.member)


_CLOCK = HLC()


def default_clock() -> HLC:
    """The process-global HLC every bus publish/receive runs through."""
    return _CLOCK


# -- wire framing ------------------------------------------------------------
# An HLC stamp rides INSIDE every bus message as a prefix frame (inside
# the broker's seq framing, which RespBus strips first), so the single
# strip-and-merge site in bus/base.py's HandlerPump covers both bus
# implementations. Mark bytes can't appear in JSON payloads.

_HLC_MARK = "\x00h\x00"


def encode_hlc(stamp: HLCStamp, payload: str) -> str:
    return f"{_HLC_MARK}{stamp.encode()}\x00{payload}"


def split_hlc(payload: str) -> tuple[HLCStamp | None, str]:
    """Split a framed message into (stamp, body); unframed messages (an
    old member mid-rolling-upgrade, tests publishing raw strings) pass
    through with ``stamp=None``."""
    if not payload.startswith(_HLC_MARK):
        return None, payload
    head, sep, body = payload[len(_HLC_MARK):].partition("\x00")
    if not sep:
        return None, payload
    try:
        return HLCStamp.parse(head), body
    except (ValueError, TypeError):
        return None, payload


# -- typed event registry ----------------------------------------------------
# Every timeline event type is declared exactly once here: name
# ("subsystem.event" — flight-recorder sites keep their existing
# spellings), the payload keys its sites may attach, and the modules
# allowed to emit it. The event-discipline analyzer rule
# (analysis/rules/event_discipline.py) statically discovers every
# flight-recorder ``record()`` / ``emit_event()`` call site and verifies
# both directions against this registry and the README "Timeline events"
# table, so an undeclared event (or a dead declaration) is a gridcheck
# finding, not a silent drift.


@dataclass(frozen=True)
class EventSpec:
    name: str
    keys: tuple[str, ...]
    modules: tuple[str, ...]
    open_keys: bool = False


EVENTS: dict[str, EventSpec] = {}


def register_event(name: str, *, keys: tuple[str, ...] = (),
                   modules: tuple[str, ...] = (),
                   open_keys: bool = False) -> None:
    """Declare one timeline event type. ``open_keys`` marks events whose
    sites splat dynamic fields (``**loaded``) — key sets are then a
    lower bound, not exact."""
    if name in EVENTS:
        raise ValueError(f"duplicate register_event({name!r})")
    EVENTS[name] = EventSpec(name, tuple(keys), tuple(modules), open_keys)


register_event("bus.failover", keys=("conn", "endpoint", "epoch"),
               modules=("gridllm_torch/bus/resp.py",))
register_event("bus.recv", keys=("channel",),
               modules=("gridllm_torch/bus/base.py",))
register_event("bus.resume_gap", keys=("channel", "lost"),
               modules=("gridllm_torch/bus/resp.py",))
register_event("bus.send", keys=("channel",),
               modules=("gridllm_torch/bus/base.py",))
register_event("bus.seq_reset", keys=("channel",),
               modules=("gridllm_torch/bus/resp.py",))
register_event("bus.subscriber_down", keys=("endpoint",),
               modules=("gridllm_torch/bus/resp.py",))
register_event("bus.subscriber_reconnected", keys=("endpoint", "outageS"),
               modules=("gridllm_torch/bus/resp.py",))
register_event("engine.admit",
               keys=("cachedTokens", "model", "promptTokens", "request",
                     "slot"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("engine.block", keys=("gen", "k", "model", "pending", "slots"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("engine.finish",
               keys=("model", "reason", "request", "slot", "tokens"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("engine.kv_import",
               keys=("model", "pagesInstalled", "pagesShared", "tokens"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("engine.kv_park", keys=("model", "pages", "tokens"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("engine.profile_capture", keys=("path", "reason", "seconds"),
               modules=("gridllm_torch/obs/perf.py",))
register_event("engine.recompile",
               keys=("context", "fn", "nArrays", "reason", "shapes",
                     "statics"),
               modules=("gridllm_torch/obs/perf.py",))
register_event("engine.recompile_storm", keys=(),
               modules=("gridllm_torch/obs/perf.py",), open_keys=True)
register_event("engine.runner_dead", keys=("error", "model"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("engine.step_failure", keys=("error", "model", "streak"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("engine.verify",
               keys=("drafted", "gen", "k", "model", "pending", "slots"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("engine.verify_tree",
               keys=("drafted", "gen", "model", "nodes", "pending",
                     "slots"),
               modules=("gridllm_torch/engine/engine.py",))
register_event("gateway.server_error", keys=("method", "route", "status"),
               modules=("gridllm_torch/gateway/obs_routes.py",))
register_event("health.degraded", keys=("reason", "worker"),
               modules=("gridllm_torch/obs/health.py",))
register_event("health.probation", keys=("reason", "worker"),
               modules=("gridllm_torch/obs/health.py",))
register_event("health.quarantined", keys=("reason", "worker"),
               modules=("gridllm_torch/obs/health.py",))
register_event("health.recovered", keys=("reason", "worker"),
               modules=("gridllm_torch/obs/health.py",))
register_event("gateway.submitted", keys=("model",),
               modules=("gridllm_torch/controlplane/client.py",))
register_event("numcheck.nonfinite", keys=("op",),
               modules=("gridllm_torch/analysis/numcheck.py",), open_keys=True)
register_event("numcheck.tolerance", keys=("op",),
               modules=("gridllm_torch/analysis/numcheck.py",), open_keys=True)
register_event("probe.golden_drift",
               keys=("expected", "got", "model", "worker"),
               modules=("gridllm_torch/obs/probe.py",))
register_event("probe.golden_sealed", keys=("hash", "model", "worker"),
               modules=("gridllm_torch/obs/probe.py",))
register_event("registry.liveness_resumed", keys=("workers",),
               modules=("gridllm_torch/scheduler/registry.py",))
register_event("registry.liveness_suspended", keys=("workers",),
               modules=("gridllm_torch/scheduler/registry.py",))
register_event("registry.worker_crash", keys=("reason", "worker"),
               modules=("gridllm_torch/obs/watchdog.py",))
register_event("registry.worker_registered", keys=("models", "worker"),
               modules=("gridllm_torch/scheduler/registry.py",))
register_event("registry.worker_removed",
               keys=("currentJobs", "reason", "worker"),
               modules=("gridllm_torch/scheduler/registry.py",))
register_event("scheduler.cancelled", keys=("job", "reason"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.deadline_exceeded", keys=("job", "model"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.disagg_fallback", keys=("job", "reason", "worker"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.drain_handoff",
               keys=("fromWorker", "job", "toWorker", "tokens"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.drain_requeued", keys=("fromWorker", "job"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.duplicate_completion",
               keys=("job", "tokens", "worker"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.failed",
               keys=("error", "job", "model", "tenant", "worker"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.handoff",
               keys=("fromWorker", "job", "toWorker", "tokens"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.hang", keys=("ageS", "job", "phase", "worker"),
               modules=("gridllm_torch/obs/watchdog.py",))
register_event("scheduler.migration_lost",
               keys=("fromWorker", "job", "toWorker"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.nacked", keys=("job", "nacks", "worker"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.orphaned", keys=("job", "reason", "worker"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.preempt_requested",
               keys=("job", "waiting", "worker"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.preempted",
               keys=("fromWorker", "job", "parkedTokens"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.retry", keys=("attempt", "error", "job"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.retry_budget_exhausted", keys=("error", "job"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.shard_adopted", keys=("member", "shard"),
               modules=("gridllm_torch/scheduler/scheduler.py",),
               open_keys=True)
register_event("scheduler.shard_released",
               keys=("active", "queued", "shard"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("scheduler.timeout",
               keys=("job", "model", "reason", "tenant", "worker"),
               modules=("gridllm_torch/scheduler/scheduler.py",))
register_event("transfer.kv_imported",
               keys=("bytes", "request", "tokens", "worker"),
               modules=("gridllm_torch/transfer/migrate.py",))
register_event("transfer.kv_released", keys=("request", "worker"),
               modules=("gridllm_torch/transfer/migrate.py",))
register_event("transfer.kv_send_failed",
               keys=("bytes", "job", "reason", "to", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("transfer.kv_sent",
               keys=("bytes", "job", "reason", "to", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("worker.drain_handoff",
               keys=("job", "migrated", "to", "tokens", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("worker.draining", keys=("budgetS", "jobs", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("worker.duplicate_dropped", keys=("job", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("worker.engine_dead", keys=("model", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("worker.fatal_exit", keys=("reason", "worker"),
               modules=("gridllm_torch/worker/main.py",))
register_event("worker.job_failed",
               keys=("error", "job", "model", "tenant", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("worker.preempt_handoff",
               keys=("job", "parkedTokens", "tokens", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("worker.started", keys=("models", "worker"),
               modules=("gridllm_torch/worker/service.py",))
register_event("worker.stopped", keys=("announce", "worker"),
               modules=("gridllm_torch/worker/service.py",))


# -- bus-edge helpers --------------------------------------------------------
# Channel families whose send/receive edges become timeline events.
# Deliberately EXCLUDES the hot volume families (stream frames, KV
# transfer chunks, heartbeats, status envelopes, trace publications):
# edges exist to order lifecycle transitions, not to mirror the data
# plane. The HLC stamp itself still rides on EVERY message.

EDGE_FAMILIES = frozenset({
    "job:completed", "job:failed", "job:handoff", "job:drain",
    "job:preempted", "job:snapshot", "ctrl:submit", "ctrl:cancel",
    "worker:job",
})


def edge_request_id(message: str) -> str | None:
    """Best-effort request id from a lifecycle payload (all the edge
    families carry JSON with one of these spellings)."""
    try:
        data = json.loads(message)
    except (ValueError, TypeError):
        return None
    if not isinstance(data, dict):
        return None
    rid = data.get("jobId") or data.get("requestId")
    if isinstance(rid, str) and rid:
        return rid
    for key in ("request", "job"):
        sub = data.get(key)
        if isinstance(sub, dict) and isinstance(sub.get("id"), str):
            return sub["id"]
    return None


# -- module-level emitter ----------------------------------------------------
# One process-global publisher (like the flight recorder): armed once at
# process start; every subsystem — and the bus-edge hooks in bus/base.py —
# emits through it. None = timeline disabled, emits are no-ops.

_EMITTER: "TimelinePublisher | None" = None


def set_emitter(pub: "TimelinePublisher | None") -> None:
    global _EMITTER
    _EMITTER = pub


def timeline_emitter() -> "TimelinePublisher | None":
    return _EMITTER


def timeline_armed() -> bool:
    return _EMITTER is not None


def emit_event(name: str, *, member: str | None = None,
               request_id: str | None = None,
               stamp: HLCStamp | None = None, **fields: Any) -> None:
    """Emit one timeline event through the global publisher (no-op when
    the timeline is disarmed). ``member``/``request_id``/``stamp`` are
    envelope attributes, not payload keys."""
    if _EMITTER is not None:
        _EMITTER.emit(name, member=member, request_id=request_id,
                      stamp=stamp, fields=fields)


def stamp_key(ev: dict[str, Any]) -> tuple[int, int, str]:
    """Sort key: the event's HLC stamp (causal order across members)."""
    stamp = HLCStamp.from_list(ev.get("stamp"))
    if stamp is None:
        return (0, 0, "")
    return (stamp.wall_ms, stamp.logical, stamp.member)


class TimelinePublisher:
    """Bounded, never-blocking event publisher for one member.

    ``emit()`` appends to a lock-guarded deque (callable from any
    thread); a flush task drains batches onto the durable ``obs:event``
    channel. Overflow drops the OLDEST events and counts them — recent
    history is what forensics wants, and a wedged bus must cost
    telemetry, never decode ITL. ``install()`` wires the process: the
    global emitter slot plus a flight-recorder tap so every existing
    ``record()`` site becomes a timeline event without changing."""

    def __init__(self, member: str, *, queue_capacity: int = 2048,
                 flush_ms: float = 200.0, batch_max: int = 256,
                 registry=None):
        self.member = member
        self.queue_capacity = queue_capacity
        self.flush_s = max(flush_ms, 1.0) / 1000.0
        self.batch_max = batch_max
        self.clock = default_clock()
        if not self.clock.member:
            # first armer names the process clock (tie-break identity)
            self.clock.set_member(member)
        self._q: deque[dict[str, Any]] = deque()
        self._lock = threading.Lock()
        self._bus = None
        self._task: asyncio.Task | None = None
        self._dropped = (registry or default_registry()).counter(
            "gridllm_timeline_dropped_events_total",
            "Timeline events dropped by the bounded publisher queue "
            "(bus backpressure) instead of blocking an emitter, by "
            "member.",
            ("member",),
        )

    # -- emit side (any thread, never blocks) -------------------------------
    def emit(self, name: str, *, member: str | None = None,
             request_id: str | None = None,
             stamp: HLCStamp | None = None,
             fields: dict[str, Any] | None = None) -> None:
        if stamp is None:
            stamp = self.clock.tick()
        ev: dict[str, Any] = {
            "name": name,
            "member": member or self.member,
            "stamp": stamp.to_list(),
        }
        if request_id:
            ev["requestId"] = request_id
        if fields:
            ev["fields"] = fields
        with self._lock:
            if len(self._q) >= self.queue_capacity:
                self._q.popleft()
                self._dropped.inc(member=self.member)
            self._q.append(ev)

    def _on_record(self, subsystem: str, event: str,
                   fields: dict[str, Any]) -> None:
        """Flight-recorder tap: every existing ``record()`` site becomes
        a ``subsystem.event`` timeline event. Member attribution prefers
        an explicit ``member`` field, then the worker id on worker-side
        subsystems, then this publisher's member."""
        member = fields.get("member")
        if not member and subsystem in ("worker", "transfer", "engine"):
            member = fields.get("worker")
        rid = (fields.get("job") or fields.get("jobId")
               or fields.get("request") or fields.get("requestId"))
        payload = {k: v for k, v in fields.items() if k != "member"}
        self.emit(f"{subsystem}.{event}",
                  member=member if isinstance(member, str) else None,
                  request_id=rid if isinstance(rid, str) else None,
                  fields=payload)

    def install(self) -> None:
        """Become the process emitter: global slot + flight-recorder tap."""
        from gridllm_torch.obs.flightrec import default_flight_recorder

        set_emitter(self)
        default_flight_recorder().set_tap(self._on_record)

    # -- flush side (event loop) --------------------------------------------
    async def start(self, bus) -> None:
        self._bus = bus
        if self._task is None:
            self._task = asyncio.create_task(self._flush_loop())

    async def stop(self) -> None:
        from gridllm_torch.obs.flightrec import default_flight_recorder

        if self._task is not None:
            self._task.cancel()
            self._task = None
        if timeline_emitter() is self:
            set_emitter(None)
            default_flight_recorder().set_tap(None)

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.flush_s)
            try:
                await self.flush_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — telemetry must not kill
                log.warning("timeline flush failed", error=str(e))

    async def flush_once(self) -> int:
        """Drain up to ``batch_max`` queued events onto the bus. A failed
        publish counts the batch as dropped rather than requeueing it —
        backpressure never grows the queue beyond its bound."""
        if self._bus is None:
            return 0
        with self._lock:
            if not self._q:
                return 0
            batch = [self._q.popleft()
                     for _ in range(min(len(self._q), self.batch_max))]
        # deferred import: bus/base.py imports the obs package at module
        # load, so the constant cannot be imported at OUR module level
        from gridllm_torch.bus.base import CH_OBS_EVENT

        payload = json.dumps({"member": self.member, "events": batch},
                             default=str)
        try:
            await self._bus.publish(CH_OBS_EVENT, payload)
        except Exception as e:  # noqa: BLE001
            for _ in batch:
                self._dropped.inc(member=self.member)
            log.warning("timeline publish failed; batch dropped",
                        error=str(e), events=len(batch))
            return 0
        return len(batch)

    def pending(self) -> int:
        with self._lock:
            return len(self._q)


class TimelineStore:
    """Fleet-merged event store: subscribes ``obs:event``, keeps a global
    ring plus a bounded per-request index, and serves HLC-ordered slices.
    Ingesting also merges every event's stamp into the local clock, so
    anything this member emits afterwards (incident reports) is causally
    after everything it has seen."""

    def __init__(self, *, capacity: int = 4096, max_requests: int = 512):
        self.capacity = capacity
        self.max_requests = max_requests
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._by_request: OrderedDict[str, list[dict[str, Any]]] = (
            OrderedDict())
        self._listeners: list[Callable[[dict[str, Any]], None]] = []
        self._sub = None

    async def attach(self, bus) -> None:
        from gridllm_torch.bus.base import CH_OBS_EVENT

        self._sub = await bus.subscribe(CH_OBS_EVENT, self._on_batch)

    async def detach(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
            self._sub = None

    async def _on_batch(self, channel: str, raw: str) -> None:
        try:
            data = json.loads(raw)
        except (ValueError, TypeError):
            return
        events = data.get("events") if isinstance(data, dict) else None
        if not isinstance(events, list):
            return
        for ev in events:
            if isinstance(ev, dict) and isinstance(ev.get("name"), str):
                self.ingest(ev)

    def ingest(self, ev: dict[str, Any]) -> None:
        stamp = HLCStamp.from_list(ev.get("stamp"))
        if stamp is not None:
            default_clock().update(stamp)
        self._ring.append(ev)
        rid = ev.get("requestId")
        if isinstance(rid, str) and rid:
            bucket = self._by_request.get(rid)
            if bucket is None:
                bucket = self._by_request[rid] = []
                while len(self._by_request) > self.max_requests:
                    self._by_request.popitem(last=False)
            else:
                self._by_request.move_to_end(rid)
            bucket.append(ev)
            # per-request bound: a runaway stream cannot pin the index
            if len(bucket) > self.capacity:
                del bucket[0]
        for fn in list(self._listeners):
            try:
                fn(ev)
            except Exception as e:  # noqa: BLE001 — listeners are best-effort
                log.warning("timeline listener failed", error=str(e))

    def add_listener(self, fn: Callable[[dict[str, Any]], None]) -> None:
        self._listeners.append(fn)

    def slice(self, request_id: str) -> list[dict[str, Any]]:
        """All events for one request in HLC (causal) order."""
        return sorted(self._by_request.get(request_id, ()), key=stamp_key)

    def window(self, wall_lo_ms: int, wall_hi_ms: int) -> list[dict[str, Any]]:
        """Events whose physical component falls in [lo, hi], HLC-ordered
        — the incident collector's causal-window query."""
        out = [ev for ev in self._ring
               if wall_lo_ms <= stamp_key(ev)[0] <= wall_hi_ms]
        out.sort(key=stamp_key)
        return out

    def events(self) -> list[dict[str, Any]]:
        return list(self._ring)


# -- critical-path decomposition ---------------------------------------------

CRITICAL_PATH_SEGMENTS = (
    "queue_wait", "dispatch", "prefill", "decode_device",
    "decode_host_stall", "migration", "suspend_resume",
)

# span name → segment, in descending precedence when intervals overlap:
# KV migration work wins over the prefill/decode it interrupts, compute
# wins over the queue span that may straddle a requeue.
_MIGRATION_SPANS = ("kvx.send", "kvx.import", "engine.prefill_export")


def critical_path(spans: list[dict[str, Any]]) -> dict[str, float] | None:
    """Decompose a stitched trace into additive latency segments.

    Sweeps the root ``gateway.request`` interval: every elementary
    sub-interval is attributed to exactly ONE segment by precedence
    (migration > prefill > decode > queue-wait), uncovered time inside
    the worker-execution hull but between execute spans is
    ``suspend_resume`` (preemption/handoff gaps), and all other
    uncovered time is ``dispatch`` (control-plane transit). Decode time
    splits into device compute (the engine-measured ``engineNs`` share)
    vs host stall. The segments sum to the e2e latency exactly, so the
    ``gridllm_critical_path_seconds`` histogram is an additive
    decomposition, not a set of overlapping timers. Returns None until
    the root span is sealed."""
    root = next((s for s in spans
                 if s.get("name") == "gateway.request"
                 and s.get("end") is not None), None)
    if root is None:
        return None
    t0, t1 = float(root["start"]), float(root["end"])
    if t1 <= t0:
        return None

    def clipped(names: tuple[str, ...] | str) -> list[tuple[float, float]]:
        wanted = (names,) if isinstance(names, str) else names
        out = []
        for s in spans:
            if s.get("name") not in wanted or s.get("end") is None:
                continue
            a = max(t0, float(s["start"]))
            b = min(t1, float(s["end"]))
            if b > a:
                out.append((a, b))
        return out

    migration = clipped(_MIGRATION_SPANS)
    prefill = clipped("engine.prefill")
    decode = clipped("engine.decode")
    queue = clipped("queue.wait")
    execs = clipped("worker.execute")
    exec_hull = ((min(a for a, _ in execs), max(b for _, b in execs))
                 if execs else None)

    def covers(ivs: list[tuple[float, float]], x: float) -> bool:
        return any(a <= x < b for a, b in ivs)

    points = sorted({t0, t1,
                     *(p for iv in (*migration, *prefill, *decode,
                                    *queue, *execs) for p in iv)})
    seg = dict.fromkeys(CRITICAL_PATH_SEGMENTS, 0.0)
    decode_cov = 0.0
    for a, b in zip(points, points[1:]):
        if b <= t0 or a >= t1:
            continue
        mid = (a + b) / 2
        dur = b - a
        if covers(migration, mid):
            seg["migration"] += dur
        elif covers(prefill, mid):
            seg["prefill"] += dur
        elif covers(decode, mid):
            decode_cov += dur
        elif covers(queue, mid):
            seg["queue_wait"] += dur
        elif (exec_hull is not None
              and exec_hull[0] <= mid < exec_hull[1]
              and not covers(execs, mid)):
            seg["suspend_resume"] += dur
        else:
            seg["dispatch"] += dur
    # engine-measured device time bounds the device share of decode; the
    # remainder is host stall (python step loop, transfers, GIL)
    engine_s = sum(
        float((s.get("meta") or {}).get("engineNs") or 0.0) / 1e9
        for s in spans if s.get("name") == "engine.decode")
    seg["decode_device"] = min(decode_cov, engine_s)
    seg["decode_host_stall"] = decode_cov - seg["decode_device"]
    seg["e2e"] = t1 - t0
    return seg
