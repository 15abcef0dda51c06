"""Per-model demand / capacity model behind ``GET /admin/capacity``.

Each scheduler shard owns a :class:`DemandTracker`: exponentially
decayed per-model arrival rate, service (completion) rate, queue-wait
EWMA and service-time EWMA (half-life ``GRIDLLM_CAPACITY_EWMA_HALFLIFE_S``),
joined at snapshot time with live queue depth and the slot/KV headroom
workers advertise per model in their heartbeats.  The derived *scale
hint* is the signed replica delta that would bring slot utilization to
the ``TARGET_UTILIZATION`` burn rate at current demand — the consumable
surface the future autoscaler (ROADMAP items 1/2) keys off.

``controlplane/status.py`` ships ``snapshot()`` in every ``ctrl:status``
envelope; :func:`merge_capacity` folds the per-shard snapshots into the
fleet view any gateway replica serves.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Iterable, Mapping

from gridllm_torch.utils.config import env_float

from .metrics import MetricsRegistry

# slot-utilization the scale hint steers toward: enough headroom to
# absorb bursts without idling paid-for accelerators.
TARGET_UTILIZATION = 0.8

_LN2 = math.log(2.0)


class _Decay:
    """Exponentially decayed event counter + weighted mean with a shared
    half-life.  ``rate()`` is events/second (steady state of the decayed
    count is ``rate * halflife / ln2``); ``mean()`` is the decayed
    average of observed values (queue wait, service time)."""

    __slots__ = ("halflife", "count", "vsum", "t_last")

    def __init__(self, halflife_s: float) -> None:
        self.halflife = max(float(halflife_s), 1e-3)
        self.count = 0.0
        self.vsum = 0.0
        self.t_last = time.time()

    def _decay_to(self, now: float) -> None:
        dt = max(now - self.t_last, 0.0)
        if dt > 0:
            f = 0.5 ** (dt / self.halflife)
            self.count *= f
            self.vsum *= f
            self.t_last = now

    def observe(self, value: float = 0.0, now: float | None = None) -> None:
        now = time.time() if now is None else now
        self._decay_to(now)
        self.count += 1.0
        self.vsum += float(value)

    def rate(self, now: float | None = None) -> float:
        now = time.time() if now is None else now
        self._decay_to(now)
        return self.count * _LN2 / self.halflife

    def mean(self, now: float | None = None) -> float:
        now = time.time() if now is None else now
        self._decay_to(now)
        return self.vsum / self.count if self.count > 1e-9 else 0.0


class _ModelDemand:
    __slots__ = ("arrivals", "completions", "waits", "services")

    def __init__(self, halflife_s: float) -> None:
        self.arrivals = _Decay(halflife_s)
        self.completions = _Decay(halflife_s)
        self.waits = _Decay(halflife_s)
        self.services = _Decay(halflife_s)


def aggregate_worker_capacity(
    workers: Iterable[Any],
) -> dict[str, dict[str, int]]:
    """Sum the per-model ``modelCapacity`` heartbeat blocks across live
    workers: free/total decode slots, free KV pages, worker count."""
    agg: dict[str, dict[str, int]] = {}
    for w in workers:
        mc = getattr(w, "modelCapacity", None) or {}
        for model, caps in mc.items():
            if not isinstance(caps, Mapping):
                continue
            cell = agg.setdefault(
                model, {"slotsFree": 0, "slotsTotal": 0, "kvPagesFree": 0, "workers": 0}
            )
            cell["slotsFree"] += int(caps.get("slotsFree") or 0)
            cell["slotsTotal"] += int(caps.get("slotsTotal") or 0)
            cell["kvPagesFree"] += int(caps.get("kvPagesFree") or 0)
            cell["workers"] += 1
    return agg


def dedup_capacity_totals(workers: Iterable[Any]) -> dict[str, int]:
    """Fleet slot/KV totals counting each distinct engine pool ONCE. Copy-model aliases serve one engine under
    several names; per-model cells rightly attribute the shared pool to
    every name (any of them can use it), but summing those cells into a
    fleet total double-counts. Heartbeat blocks carry an ``engine``
    identity token — aliases share it, so dedup is per (worker, token).
    Blocks without a token (older workers) are counted per name."""
    totals = {"slotsFree": 0, "slotsTotal": 0, "kvPagesFree": 0, "engines": 0}
    for w in workers:
        mc = getattr(w, "modelCapacity", None) or {}
        seen: set[int] = set()
        for caps in mc.values():
            if not isinstance(caps, Mapping):
                continue
            tok = int(caps.get("engine") or 0)
            if tok:
                if tok in seen:
                    continue
                seen.add(tok)
            totals["slotsFree"] += int(caps.get("slotsFree") or 0)
            totals["slotsTotal"] += int(caps.get("slotsTotal") or 0)
            totals["kvPagesFree"] += int(caps.get("kvPagesFree") or 0)
            totals["engines"] += 1
    return totals


def _utilization(cap: Mapping[str, int]) -> float:
    total = int(cap.get("slotsTotal") or 0)
    if total <= 0:
        return 0.0
    free = max(min(int(cap.get("slotsFree") or 0), total), 0)
    return (total - free) / total


def _scale_hint(
    *, workers: int, utilization: float, arrival_rate: float, queue_depth: int
) -> int:
    """Signed replica delta to bring slot utilization to
    ``TARGET_UTILIZATION`` at current demand.  No workers + live demand
    asks for one; a standing queue always asks for at least one more;
    scale-down never drops below a single replica."""
    if workers <= 0:
        return 1 if (arrival_rate > 0 or queue_depth > 0) else 0
    needed = math.ceil(workers * utilization / TARGET_UTILIZATION)
    hint = needed - workers
    if queue_depth > 0:
        hint = max(hint, 1)
    return max(hint, -(workers - 1))


class DemandTracker:
    """Per-shard demand/capacity model.  ``queue_depths`` and
    ``worker_capacity`` are live views supplied by the scheduler; the
    tracker owns only the decayed rate state."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        *,
        halflife_s: float | None = None,
        queue_depths: Callable[[], Mapping[str, int]] | None = None,
        worker_capacity: Callable[[], Mapping[str, Mapping[str, int]]] | None = None,
        pool_totals: Callable[[], Mapping[str, int]] | None = None,
    ) -> None:
        self.halflife = float(
            halflife_s
            if halflife_s is not None
            else env_float("GRIDLLM_CAPACITY_EWMA_HALFLIFE_S")
        )
        self._queue_depths = queue_depths or (lambda: {})
        self._worker_capacity = worker_capacity or (lambda: {})
        self._pool_totals = pool_totals or (lambda: {})
        self._models: dict[str, _ModelDemand] = {}
        self._lock = threading.Lock()
        self._g_arrival = metrics.gauge(
            "gridllm_capacity_arrival_rate",
            "Per-model request arrival rate (EWMA, requests/s) at this shard.",
            ("model",),
        )
        self._g_service = metrics.gauge(
            "gridllm_capacity_service_rate",
            "Per-model request completion rate (EWMA, requests/s) at this shard.",
            ("model",),
        )
        self._g_queue = metrics.gauge(
            "gridllm_capacity_queue_depth",
            "Per-model jobs queued at this shard.",
            ("model",),
        )
        self._g_wait = metrics.gauge(
            "gridllm_capacity_wait_seconds",
            "Per-model queue-wait EWMA (seconds) at this shard.",
            ("model",),
        )
        self._g_util = metrics.gauge(
            "gridllm_capacity_utilization",
            "Per-model fleet decode-slot utilization (0..1) as seen by "
            "this shard's worker registry.",
            ("model",),
        )
        self._g_headroom = metrics.gauge(
            "gridllm_capacity_headroom",
            "Per-model free capacity across live workers (decode slots "
            "or KV pages).",
            ("model", "resource"),
        )
        self._g_hint = metrics.gauge(
            "gridllm_capacity_scale_hint",
            "Signed replica delta to hold the SLO at current burn rate "
            "(positive = scale out).",
            ("model",),
        )
        self._g_fleet = metrics.gauge(
            "gridllm_capacity_fleet_slots",
            "Fleet decode slots deduped by engine identity (copy-model "
            "aliases counted once), by state (free / total).",
            ("state",),
        )
        metrics.add_collector("capacity", self._collect)

    def _demand(self, model: str) -> _ModelDemand:
        d = self._models.get(model)
        if d is None:
            d = self._models.setdefault(model, _ModelDemand(self.halflife))
        return d

    def note_arrival(self, model: str) -> None:
        with self._lock:
            self._demand(model).arrivals.observe()

    def note_dispatch(self, model: str, wait_s: float) -> None:
        with self._lock:
            self._demand(model).waits.observe(max(float(wait_s), 0.0))

    def note_completion(self, model: str, service_s: float) -> None:
        with self._lock:
            d = self._demand(model)
            d.completions.observe()
            d.services.observe(max(float(service_s), 0.0))

    def snapshot(self) -> dict[str, Any]:
        now = time.time()
        queues = dict(self._queue_depths())
        caps = {m: dict(c) for m, c in self._worker_capacity().items()}
        models: dict[str, Any] = {}
        with self._lock:
            names = set(self._models) | set(queues) | set(caps)
            for model in sorted(names):
                d = self._models.get(model)
                cap = caps.get(
                    model,
                    {"slotsFree": 0, "slotsTotal": 0, "kvPagesFree": 0, "workers": 0},
                )
                util = _utilization(cap)
                arrival = d.arrivals.rate(now) if d else 0.0
                qd = int(queues.get(model, 0))
                models[model] = {
                    "arrivalRate": round(arrival, 4),
                    "serviceRate": round(d.completions.rate(now) if d else 0.0, 4),
                    "queueDepth": qd,
                    "waitEwmaS": round(d.waits.mean(now) if d else 0.0, 4),
                    "serviceEwmaS": round(d.services.mean(now) if d else 0.0, 4),
                    "utilization": round(util, 4),
                    "headroom": {
                        "slots": int(cap.get("slotsFree") or 0),
                        "kvPages": int(cap.get("kvPagesFree") or 0),
                    },
                    "slotsTotal": int(cap.get("slotsTotal") or 0),
                    "workers": int(cap.get("workers") or 0),
                    "scaleHint": _scale_hint(
                        workers=int(cap.get("workers") or 0),
                        utilization=util,
                        arrival_rate=arrival,
                        queue_depth=qd,
                    ),
                }
        fleet = {k: int(v) for k, v in dict(self._pool_totals()).items()}
        return {"halflifeS": self.halflife, "models": models, "fleet": fleet}

    def _collect(self) -> None:
        snap = self.snapshot()
        for model, m in snap["models"].items():
            self._g_arrival.set(m["arrivalRate"], model=model)
            self._g_service.set(m["serviceRate"], model=model)
            self._g_queue.set(m["queueDepth"], model=model)
            self._g_wait.set(m["waitEwmaS"], model=model)
            self._g_util.set(m["utilization"], model=model)
            self._g_headroom.set(m["headroom"]["slots"], model=model, resource="slots")
            self._g_headroom.set(
                m["headroom"]["kvPages"], model=model, resource="kv_pages"
            )
            self._g_hint.set(m["scaleHint"], model=model)
        fleet = snap.get("fleet") or {}
        if fleet:
            self._g_fleet.set(fleet.get("slotsFree", 0), state="free")
            self._g_fleet.set(fleet.get("slotsTotal", 0), state="total")


def merge_capacity(snapshots: Iterable[Mapping[str, Any]]) -> dict[str, Any]:
    """Fold per-shard capacity snapshots into the fleet view.  Demand
    (arrival/service rates, queue depth) is partitioned across shards so
    it sums; worker headroom is observed identically by every shard's
    registry, so element-wise max avoids double counting.  The scale
    hint is recomputed from the merged numbers."""
    models: dict[str, dict[str, Any]] = {}
    fleet: dict[str, int] = {}
    shards = 0
    halflife = 0.0
    for snap in snapshots:
        if not snap:
            continue
        shards += 1
        halflife = max(halflife, float(snap.get("halflifeS") or 0.0))
        # every shard's registry observes the same workers — element-wise
        # max (like headroom), never a sum
        for k, v in (snap.get("fleet") or {}).items():
            fleet[k] = max(int(fleet.get(k, 0)), int(v or 0))
        for model, m in (snap.get("models") or {}).items():
            cell = models.setdefault(
                model,
                {
                    "arrivalRate": 0.0,
                    "serviceRate": 0.0,
                    "queueDepth": 0,
                    "waitEwmaS": 0.0,
                    "_wait_w": 0.0,
                    "headroom": {"slots": 0, "kvPages": 0},
                    "slotsTotal": 0,
                    "workers": 0,
                },
            )
            arr = float(m.get("arrivalRate") or 0.0)
            cell["arrivalRate"] += arr
            cell["serviceRate"] += float(m.get("serviceRate") or 0.0)
            cell["queueDepth"] += int(m.get("queueDepth") or 0)
            w = max(arr, 1e-9)
            cell["waitEwmaS"] += float(m.get("waitEwmaS") or 0.0) * w
            cell["_wait_w"] += w
            hr = m.get("headroom") or {}
            cell["headroom"]["slots"] = max(
                cell["headroom"]["slots"], int(hr.get("slots") or 0)
            )
            cell["headroom"]["kvPages"] = max(
                cell["headroom"]["kvPages"], int(hr.get("kvPages") or 0)
            )
            cell["slotsTotal"] = max(cell["slotsTotal"], int(m.get("slotsTotal") or 0))
            cell["workers"] = max(cell["workers"], int(m.get("workers") or 0))
    for model, cell in models.items():
        wsum = cell.pop("_wait_w")
        cell["waitEwmaS"] = round(cell["waitEwmaS"] / wsum, 4) if wsum > 1e-9 else 0.0
        cell["arrivalRate"] = round(cell["arrivalRate"], 4)
        cell["serviceRate"] = round(cell["serviceRate"], 4)
        total = cell["slotsTotal"]
        util = (total - min(cell["headroom"]["slots"], total)) / total if total else 0.0
        cell["utilization"] = round(util, 4)
        cell["scaleHint"] = _scale_hint(
            workers=cell["workers"],
            utilization=util,
            arrival_rate=cell["arrivalRate"],
            queue_depth=cell["queueDepth"],
        )
    return {"shards": shards, "halflifeS": halflife, "models": models,
            "fleet": fleet}
