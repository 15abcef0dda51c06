"""Per-worker health baselines + quarantine state machine.

Each scheduler shard owns a :class:`HealthMonitor`.  Rolling per-worker
baselines — canary end-to-end latency (obs/probe.py), decode ITL from
the span-derived timing the SLO judge already computes, and heartbeat
inter-arrival gap measured receiver-side — feed an EWMA+z-score
regression detector (same decay idiom as obs/capacity.py).  Verdicts
drive a four-state machine per worker::

    online ──strikes──▶ degraded ──strikes──▶ quarantined
      ▲                    │                      │ (re-register)
      └───clean canaries───┘        probation ◀───┘
      ▲                                │
      └────────clean canaries─────────┘
    (any state) ──golden drift──▶ quarantined

Degraded workers stay in placement with a load-score penalty
(``GRIDLLM_HEALTH_DEGRADED_PENALTY``, mirroring the
prefix-affinity weight); quarantined workers are excluded and drained
through the graceful-drain path ({"type": "drain"} on their job
channel), so in-flight work resumes exactly-once on peers.  A
quarantined worker that re-registers (operator restart) enters
probation: canaries keep flowing, user traffic is routed elsewhere
while alternatives exist, and ``GRIDLLM_HEALTH_PROBATION_PASSES`` clean
rounds readmit it.

Transitions replicate on the durable ``health:state`` channel so every
registry — scheduler shards and observer-mode gateway replicas — holds
the same ``WorkerInfo.healthState``; forensics opens an
incident on ``health.quarantined`` and ``probe.golden_drift``.

Import-cycle note: bus/base.py imports ``gridllm_torch.obs`` at module
load, and faults.py imports ``gridllm_torch.obs`` too — so channel
helpers AND the fault layer are imported lazily inside methods here
(same pattern as obs/timeline.py).  Pure stdlib.
"""

from __future__ import annotations

import asyncio
import json
import math
import time
from typing import Any, Callable

from gridllm_torch.utils.config import env_float, env_int
from gridllm_torch.utils.logging import get_logger

from .flightrec import default_flight_recorder
from .metrics import MetricsRegistry

log = get_logger("obs.health")

HEALTH_STATES = ("online", "degraded", "quarantined", "probation")
# numeric codes for the gridllm_worker_health_state gauge (alert exprs
# compare against these: 3 == quarantined)
STATE_CODES = {"online": 0, "probation": 1, "degraded": 2, "quarantined": 3}

# baseline signal names (snapshot keys; one _Baseline each per worker)
SIG_CANARY_E2E = "canary_e2e"
SIG_ITL = "itl"
SIG_HEARTBEAT_GAP = "heartbeat_gap"


class _Baseline:
    """Exponentially decayed mean/variance with a shared half-life:
    ``zscore(x)`` judges a fresh observation against the baseline BEFORE
    folding it in, so a regression cannot mask itself by dragging the
    mean toward it in the same call."""

    __slots__ = ("halflife", "count", "vsum", "v2sum", "t_last")

    def __init__(self, halflife_s: float) -> None:
        self.halflife = max(float(halflife_s), 1e-3)
        self.count = 0.0
        self.vsum = 0.0
        self.v2sum = 0.0
        self.t_last = time.time()

    def _decay_to(self, now: float) -> None:
        dt = max(now - self.t_last, 0.0)
        if dt > 0:
            f = 0.5 ** (dt / self.halflife)
            self.count *= f
            self.vsum *= f
            self.v2sum *= f
            self.t_last = now

    def mean(self) -> float:
        return self.vsum / self.count if self.count > 1e-9 else 0.0

    def std(self) -> float:
        if self.count <= 1e-9:
            return 0.0
        m = self.mean()
        return math.sqrt(max(self.v2sum / self.count - m * m, 0.0))

    def zscore(self, value: float) -> float:
        """Deviation of ``value`` from the current baseline, in baseline
        standard deviations (floored at 10% of the mean so a perfectly
        steady baseline cannot manufacture infinite z from jitter)."""
        std = max(self.std(), abs(self.mean()) * 0.1, 1e-9)
        return (value - self.mean()) / std

    def observe(self, value: float, now: float | None = None) -> None:
        now = time.time() if now is None else now
        if self.count <= 1e-9:
            # epoch starts at the first sample — decaying an empty
            # baseline across the construction->first-observe gap would
            # be a no-op on real clocks but wrong under injected time
            self.t_last = now
        self._decay_to(now)
        self.count += 1.0
        self.vsum += float(value)
        self.v2sum += float(value) * float(value)


class _WorkerHealth:
    __slots__ = ("state", "strikes", "passes", "baselines",
                 "pending_anomaly", "last_heartbeat", "last_reason")

    def __init__(self) -> None:
        self.state = "online"
        self.strikes = 0          # consecutive anomalous canary rounds
        self.passes = 0           # consecutive clean canary rounds
        self.baselines: dict[str, _Baseline] = {}
        # regression flagged by an out-of-band signal (ITL, heartbeat
        # gap) since the last canary round — folded into that round's
        # verdict so all transitions happen at one cadence
        self.pending_anomaly = ""
        self.last_heartbeat = 0.0
        self.last_reason = ""


class HealthMonitor:
    """Per-worker regression detection + health state machine for one
    scheduler shard.  Pure bookkeeping is synchronous (unit-testable
    without a loop); bus publishes ride best-effort tasks."""

    def __init__(self, bus: Any, registry: Any, metrics: MetricsRegistry,
                 member: Callable[[], str] | str = "") -> None:
        self.bus = bus
        self.registry = registry
        self._member = member
        self.halflife_s = env_float("GRIDLLM_HEALTH_EWMA_HALFLIFE_S")
        self.z_threshold = env_float("GRIDLLM_HEALTH_Z_THRESHOLD")
        self.min_samples = env_int("GRIDLLM_HEALTH_MIN_SAMPLES")
        self.degrade_strikes = max(env_int("GRIDLLM_HEALTH_DEGRADE_STRIKES"), 1)
        self.quarantine_strikes = max(
            env_int("GRIDLLM_HEALTH_QUARANTINE_STRIKES"), 1)
        self.probation_passes = max(
            env_int("GRIDLLM_HEALTH_PROBATION_PASSES"), 1)
        self._workers: dict[str, _WorkerHealth] = {}
        self.flightrec = default_flight_recorder()
        self._state_gauge = metrics.gauge(
            "gridllm_worker_health_state",
            "Health-monitor verdict per worker: 0 online, 1 probation, "
            "2 degraded, 3 quarantined.",
            ("worker",))
        self._transitions = metrics.counter(
            "gridllm_health_transitions_total",
            "Worker health-state transitions, by target state "
            "(online/degraded/quarantined/probation).",
            ("state",))

    # -- helpers -------------------------------------------------------------
    def member(self) -> str:
        return self._member() if callable(self._member) else str(self._member)

    def _get(self, worker_id: str) -> _WorkerHealth:
        wh = self._workers.get(worker_id)
        if wh is None:
            wh = self._workers[worker_id] = _WorkerHealth()
            self._state_gauge.set(0, worker=worker_id)
        return wh

    def state_of(self, worker_id: str) -> str:
        wh = self._workers.get(worker_id)
        return wh.state if wh is not None else "online"

    def _observe(self, wh: _WorkerHealth, signal: str,
                 value: float) -> float | None:
        """Fold one observation into a baseline; returns the z-score it
        was judged at, or None while the baseline is still warming up
        (or when the health.baseline fault site drops the observation)."""
        from gridllm_torch import faults  # lazy: faults imports obs

        if faults.check("health.baseline"):
            return None
        bl = wh.baselines.get(signal)
        if bl is None:
            bl = wh.baselines[signal] = _Baseline(self.halflife_s)
        z = bl.zscore(value) if bl.count >= self.min_samples else None
        bl.observe(value)
        return z

    # -- out-of-band signals -------------------------------------------------
    def note_itl(self, worker_id: str, itl_s: float) -> None:
        """Decode inter-token latency from the SLO judge's span-derived
        timing — real traffic trains the baseline between canaries."""
        wh = self._get(worker_id)
        z = self._observe(wh, SIG_ITL, float(itl_s))
        if z is not None and z > self.z_threshold:
            wh.pending_anomaly = f"itl z={z:.1f}"

    def note_heartbeat(self, worker_id: str, now: float | None = None) -> None:
        """Heartbeat inter-arrival gap, measured receiver-side (the
        payload is untouched): a worker whose event loop is seizing
        shows up here before any request does."""
        now = time.time() if now is None else now
        wh = self._get(worker_id)
        if wh.last_heartbeat > 0:
            z = self._observe(wh, SIG_HEARTBEAT_GAP, now - wh.last_heartbeat)
            if z is not None and z > self.z_threshold:
                wh.pending_anomaly = f"heartbeat_gap z={z:.1f}"
        wh.last_heartbeat = now

    def note_registered(self, worker_id: str, status: str = "online") -> None:
        """An ONLINE (re-)registration readmits a quarantined worker to
        probation — the only exit from quarantine: the worker restarted,
        so its canaries get a fresh chance to prove it.  Non-online
        registrations (the quarantine drain itself re-registers with
        status "draining") must not launder the verdict."""
        if status != "online":
            return
        wh = self._workers.get(worker_id)
        if wh is not None and wh.state == "quarantined":
            self._transition(worker_id, "probation", "reregistered")

    # -- the canary cadence --------------------------------------------------
    def note_canary(self, worker_id: str, *, ok: bool, e2e_s: float,
                    drift: bool = False) -> None:
        """One canary round's verdict for a worker.  All state-machine
        transitions happen here (one cadence); out-of-band anomalies
        flagged since the last round fold into this verdict."""
        wh = self._get(worker_id)
        if drift:
            # byte-level correctness drift outranks every latency signal:
            # quarantine immediately from any state
            self._transition(worker_id, "quarantined", "golden_drift")
            return
        reason = "" if ok else "canary_failed"
        if ok:
            z = self._observe(wh, SIG_CANARY_E2E, e2e_s)
            if z is not None and z > self.z_threshold:
                reason = f"canary_e2e z={z:.1f}"
        if not reason and wh.pending_anomaly:
            reason = wh.pending_anomaly
        wh.pending_anomaly = ""
        if reason:
            wh.passes = 0
            wh.strikes += 1
            wh.last_reason = reason
            if wh.state == "online" and wh.strikes >= self.degrade_strikes:
                self._transition(worker_id, "degraded", reason)
            elif (wh.state == "degraded"
                  and wh.strikes >= self.quarantine_strikes):
                self._transition(worker_id, "quarantined", reason)
            elif wh.state == "probation":
                # a probation worker is on its last chance — any strike
                # sends it straight back to quarantine
                self._transition(worker_id, "quarantined", reason)
        else:
            wh.strikes = 0
            wh.passes += 1
            if (wh.state in ("degraded", "probation")
                    and wh.passes >= self.probation_passes):
                self._transition(worker_id, "online", "recovered")

    # -- transitions ---------------------------------------------------------
    def _transition(self, worker_id: str, new: str, reason: str) -> None:
        wh = self._get(worker_id)
        old = wh.state
        if old == new:
            return
        wh.state = new
        wh.strikes = 0
        wh.passes = 0
        wh.last_reason = reason
        self._state_gauge.set(STATE_CODES[new], worker=worker_id)
        self._transitions.inc(state=new)
        # literal event names per branch: the event-discipline analyzer
        # resolves record() sites statically against the EVENTS registry
        if new == "online":
            self.flightrec.record("health", "recovered",
                                  worker=worker_id, reason=reason)
        elif new == "degraded":
            self.flightrec.record("health", "degraded",
                                  worker=worker_id, reason=reason)
        elif new == "probation":
            self.flightrec.record("health", "probation",
                                  worker=worker_id, reason=reason)
        else:
            self.flightrec.record("health", "quarantined",
                                  worker=worker_id, reason=reason)
        log.warning("worker health transition", worker_id=worker_id,
                    old=old, new=new, reason=reason)
        # apply locally first: the next dispatch pass must see the
        # verdict even if the bus echo is slow (or the bus is dead)
        apply_state = getattr(self.registry, "apply_health_state", None)
        if apply_state is not None:
            apply_state(worker_id, new)
        self._spawn(self._announce(worker_id, new, reason))
        if new == "quarantined":
            self._spawn(self._request_drain(worker_id))

    def _spawn(self, coro) -> None:
        # get_running_loop, not ensure_future: outside a loop the latter
        # silently CREATES one on the main thread and parks the task there
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # no running loop (sync unit tests)
            coro.close()
            return
        loop.create_task(coro)

    async def _announce(self, worker_id: str, state: str,
                        reason: str) -> None:
        from gridllm_torch.bus.base import CH_HEALTH_STATE  # lazy: cycle

        try:
            await self.bus.publish(CH_HEALTH_STATE, json.dumps({
                "worker": worker_id, "state": state, "reason": reason,
                "member": self.member(), "ts": time.time()}))
        except Exception as e:  # noqa: BLE001 — the local apply already
            log.warning("health:state publish failed",  # routed around it
                        worker_id=worker_id, error=str(e))

    async def _request_drain(self, worker_id: str) -> None:
        """Quarantine drains through the graceful path: the
        worker live-migrates or requeues its in-flight jobs (resumed
        exactly-once on peers) and refuses new work."""
        from gridllm_torch.bus.base import worker_job_channel  # lazy: cycle

        try:
            await self.bus.publish(
                worker_job_channel(worker_id),
                json.dumps({"type": "drain", "reason": "quarantine"}))
        except Exception as e:  # noqa: BLE001 — placement exclusion
            log.warning("quarantine drain publish failed",  # still holds
                        worker_id=worker_id, error=str(e))

    # -- views ---------------------------------------------------------------
    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in HEALTH_STATES}
        for wh in self._workers.values():
            out[wh.state] = out.get(wh.state, 0) + 1
        return out

    def snapshot(self) -> dict[str, Any]:
        """JSON view for ctrl:status / GET /admin/health/fleet."""
        workers: dict[str, Any] = {}
        for worker_id, wh in self._workers.items():
            workers[worker_id] = {
                "state": wh.state,
                "strikes": wh.strikes,
                "passes": wh.passes,
                "reason": wh.last_reason,
                "baselines": {
                    sig: {"mean": round(bl.mean(), 6),
                          "std": round(bl.std(), 6),
                          "n": round(bl.count, 2)}
                    for sig, bl in wh.baselines.items()},
            }
        return {"workers": workers, "counts": self.counts()}
