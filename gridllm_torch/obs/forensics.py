"""Automated incident forensics over the fleet timeline (the JAX package's
obs/forensics.py).

The :class:`IncidentCollector` listens to a member's
:class:`~gridllm_torch.obs.timeline.TimelineStore`. When a trigger event
lands — watchdog hang, shard lease loss, broker failover, lost
migration, preemption — it opens a bounded incident report whose causal
window (± ``window_ms`` around the trigger's HLC physical time) is
re-sliced from the store on READ, flight-recorder style: by the time an
operator fetches ``GET /admin/incidents``, every member's surrounding
events have usually arrived, and the report says so explicitly via
``complete`` when the window has fully elapsed. No timers, no background
tasks — assembly is lazy and bounded. Pure stdlib.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

from gridllm_torch.obs.metrics import default_registry
from gridllm_torch.obs.timeline import TimelineStore, stamp_key

# trigger event name → incident kind: the cross-member failure modes;
# anything else on the timeline is context, not a trigger.
TRIGGERS: dict[str, str] = {
    "scheduler.hang": "watchdog_hang",
    "scheduler.shard_adopted": "shard_lease_lost",
    "bus.failover": "broker_failover",
    "scheduler.migration_lost": "migration_lost",
    "scheduler.preempted": "preemption",
    # active fleet health: a quarantine verdict or a canary golden-hash
    # mismatch names the worker in its incident key
    "health.quarantined": "worker_quarantined",
    "probe.golden_drift": "canary_drift",
}


class IncidentCollector:
    """Bounded auto-assembled incident reports from the fleet timeline."""

    def __init__(self, store: TimelineStore, *, member: str = "",
                 window_ms: float = 5000.0, max_incidents: int = 32,
                 registry=None):
        self.store = store
        self.member = member
        self.window_ms = window_ms
        self._incidents: deque[dict[str, Any]] = deque(maxlen=max_incidents)
        self._seq = 0
        self._counter = (registry or default_registry()).counter(
            "gridllm_incidents_total",
            "Auto-assembled incident reports opened by the forensics "
            "collector, by kind (watchdog_hang/shard_lease_lost/"
            "broker_failover/migration_lost/preemption/"
            "worker_quarantined/canary_drift).",
            ("kind",),
        )
        store.add_listener(self._on_event)

    def _on_event(self, ev: dict[str, Any]) -> None:
        kind = TRIGGERS.get(ev.get("name") or "")
        if kind is None:
            return
        wall_ms = stamp_key(ev)[0]
        key = (ev.get("requestId")
               or (ev.get("fields") or {}).get("worker")
               or (ev.get("fields") or {}).get("shard")
               or (ev.get("fields") or {}).get("endpoint") or "")
        # debounce: one report per (kind, subject) per window — a retry
        # storm around one failure is one incident, not a report flood
        for inc in self._incidents:
            if (inc["kind"] == kind and inc["key"] == str(key)
                    and abs(inc["triggerWallMs"] - wall_ms)
                    <= self.window_ms):
                return
        self._seq += 1
        self._counter.inc(kind=kind)
        self._incidents.append({
            "id": f"{kind}-{self._seq}",
            "kind": kind,
            "key": str(key),
            "member": self.member,
            "trigger": ev,
            "triggerWallMs": wall_ms,
            "windowMs": self.window_ms,
        })

    def reports(self, now_ms: float | None = None) -> list[dict[str, Any]]:
        """Assemble every open incident against the CURRENT store
        contents (lazy finalize). ``complete`` flips once the causal
        window has fully elapsed — before that, late members may still
        be flushing their half of the story."""
        if now_ms is None:
            now_ms = time.time() * 1000
        out = []
        for inc in self._incidents:
            lo = inc["triggerWallMs"] - self.window_ms
            hi = inc["triggerWallMs"] + self.window_ms
            events = self.store.window(int(lo), int(hi))
            out.append({
                "id": inc["id"],
                "kind": inc["kind"],
                "key": inc["key"],
                "collectedBy": inc["member"],
                "trigger": inc["trigger"],
                "windowMs": inc["windowMs"],
                "complete": now_ms >= hi,
                "members": sorted({str(ev.get("member") or "?")
                                   for ev in events}),
                "events": events,
            })
        return out

    def count(self) -> int:
        return len(self._incidents)
