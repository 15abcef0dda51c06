"""Black-box flight recorder: bounded rings of lifecycle events.

Every subsystem (gateway, scheduler, registry, bus, worker, engine) appends
structured events to its own fixed-capacity ring on the process-global
recorder. Appends are a deque push under a lock — cheap enough for the
engine's sampled step loop. Nothing is persisted; the recorder exists so
that the moment something dies there is a recent-history record to dump,
not so every event survives forever.

Dumps: :func:`build_dump` assembles ONE JSON-able artifact — ring contents,
active + recent traces, SLO snapshot, registry state, engine batch state —
and is invoked both on demand (``GET /admin/dump``) and automatically by the
hang watchdog on hang/worker-crash detection (auto dumps are retained on the
recorder, bounded, and included in subsequent on-demand dumps).

Engine access is indirect: workers register a *probe* callable per engine
(:func:`register_engine_probe`) returning a point-in-time batch-state dict,
so the dump path never has to import or lock engine internals itself.
Pure stdlib.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

SUBSYSTEMS = ("gateway", "scheduler", "registry", "bus", "worker", "engine")


class FlightRecorder:
    """Per-subsystem bounded event rings + a small retained-auto-dump list."""

    def __init__(self, capacity: int = 256, max_auto_dumps: int = 4):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._rings: dict[str, deque[dict[str, Any]]] = {}
        self._auto_dumps: deque[dict[str, Any]] = deque(maxlen=max_auto_dumps)
        self._dropped: dict[str, int] = {}  # subsystem → events evicted
        # fleet timeline tap: obs/timeline.py's publisher
        # mirrors every record() onto the causal event bus without the
        # ~60 existing call sites changing
        self._tap: Callable[[str, str, dict[str, Any]], None] | None = None

    def set_capacity(self, capacity: int) -> None:
        """Resize the rings (GRIDLLM_FLIGHTREC_CAPACITY at process start —
        the process-global recorder is built before config loads)."""
        with self._lock:
            self.capacity = capacity
            for name, ring in self._rings.items():
                self._rings[name] = deque(ring, maxlen=capacity)

    def set_tap(self,
                fn: Callable[[str, str, dict[str, Any]], None] | None) -> None:
        """Install (or clear) the timeline tap called after every
        ``record()`` append."""
        self._tap = fn

    def record(self, subsystem: str, event: str, **fields: Any) -> None:
        """Append one event. Fields must be JSON-able plain data; callers
        keep them small (ids, counts, reasons — not payloads)."""
        entry = {"ts": time.time(), "event": event, **fields}
        with self._lock:
            ring = self._rings.get(subsystem)
            if ring is None:
                ring = self._rings[subsystem] = deque(maxlen=self.capacity)
            if len(ring) == self.capacity:
                self._dropped[subsystem] = self._dropped.get(subsystem, 0) + 1
            ring.append(entry)
        tap = self._tap
        if tap is not None:
            try:  # outside the lock; the ring append must never fail
                tap(subsystem, event, fields)
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass

    def snapshot(self) -> dict[str, Any]:
        """Ring contents, oldest-first, plus eviction counts so a reader
        knows when the window is truncated (no silent caps)."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "evicted": dict(self._dropped),
                "rings": {name: list(ring)
                          for name, ring in self._rings.items()},
            }

    def add_auto_dump(self, artifact: dict[str, Any]) -> None:
        with self._lock:
            self._auto_dumps.append(artifact)

    def auto_dumps(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._auto_dumps)

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._auto_dumps.clear()
            self._dropped.clear()


_DEFAULT = FlightRecorder()


def default_flight_recorder() -> FlightRecorder:
    """The process-global recorder (all subsystems of this process)."""
    return _DEFAULT


# -- engine probes -----------------------------------------------------------
# worker/service.py registers one probe per engine at start (and removes it
# at stop); dumps and watchdog diagnoses read them without touching engine
# internals. Keyed so repeated starts replace rather than accumulate.

_probes: dict[str, Callable[[], dict[str, Any]]] = {}
_probes_lock = threading.Lock()


def register_engine_probe(name: str, fn: Callable[[], dict[str, Any]]) -> None:
    with _probes_lock:
        _probes[name] = fn


def unregister_engine_probe(name: str) -> None:
    with _probes_lock:
        _probes.pop(name, None)


def engine_states() -> dict[str, Any]:
    """Point-in-time batch state from every registered engine probe. A
    probe that raises (engine mid-teardown) reports the error instead of
    breaking the dump."""
    with _probes_lock:
        probes = dict(_probes)
    out: dict[str, Any] = {}
    for name, fn in probes.items():
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — dumps must always assemble
            out[name] = {"error": str(e)}
    return out


# -- dump assembly -----------------------------------------------------------


def build_dump(scheduler: Any = None, reason: str = "on_demand",
               recorder: FlightRecorder | None = None,
               include_auto_dumps: bool = True,
               **extra: Any) -> dict[str, Any]:
    """Assemble the post-mortem artifact: rings + active/recent traces +
    SLO snapshot + registry/scheduler state + engine batch state. Every
    section is best-effort — a dead subsystem must never block the dump
    that is supposed to explain its death."""
    rec = recorder or default_flight_recorder()
    artifact: dict[str, Any] = {
        "generatedAt": time.time(),
        "reason": reason,
        "flightRecorder": rec.snapshot(),
        "engines": engine_states(),
    }
    artifact.update(extra)
    if scheduler is not None:
        try:
            tracer = scheduler.tracer
            active = tracer.active_ids()
            artifact["activeTraces"] = {
                rid: tracer.export(rid) for rid in active
            }
            artifact["recentTraceIds"] = tracer.ids()[-16:]
        except Exception as e:  # noqa: BLE001
            artifact["activeTraces"] = {"error": str(e)}
        try:
            artifact["slo"] = scheduler.slo.snapshot()
        except Exception as e:  # noqa: BLE001
            artifact["slo"] = {"error": str(e)}
        try:
            artifact["scheduler"] = {
                "stats": scheduler.get_stats(),
                "queued": [qj.request.id for qj in scheduler.job_queue],
                "active": {
                    job_id: {"worker": a.workerId,
                             "assignedAt": a.assignedAt,
                             "model": a.request.model}
                    for job_id, a in scheduler.active_jobs.items()
                },
            }
        except Exception as e:  # noqa: BLE001
            artifact["scheduler"] = {"error": str(e)}
        try:
            artifact["registry"] = {
                "counts": scheduler.registry.get_worker_count(),
                "workers": [
                    {"workerId": w.workerId, "status": w.status,
                     "currentJobs": w.currentJobs,
                     "lastHeartbeat": w.lastHeartbeat,
                     "models": w.model_names()}
                    for w in scheduler.registry.get_all_workers()
                ],
            }
        except Exception as e:  # noqa: BLE001
            artifact["registry"] = {"error": str(e)}
    if include_auto_dumps:
        artifact["autoDumps"] = rec.auto_dumps()
    return artifact
