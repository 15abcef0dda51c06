"""Demand-driven model placement: the loop that makes the
fleet's resident model set elastic.

Each scheduler shard runs one :class:`ModelPlacementController`. Every
``GRIDLLM_PLACEMENT_INTERVAL_MS`` it compares per-model demand — the
:class:`~gridllm_torch.obs.capacity.DemandTracker` aggregates (queue
depth, arrival rate, scale hints) — against the replicas actually
resident on live workers, and closes the gap with targeted
``load_model`` / ``unload_model`` ops on the existing admin channel
(``worker:admin`` with a ``workerId`` key; only the named worker acts):

- **swap-in / scale-up**: a model with queued demand and zero replicas
  gets loaded immediately (the scheduler QUEUES zero-replica requests —
  ``note_unserved`` fires from the dispatch pass, so swap-in starts on
  the first held job, not the next tick); a served model with a standing
  queue and a positive scale hint gets one more replica.
- **scale-to-zero**: a model with no queued/active demand for longer
  than ``GRIDLLM_MODEL_IDLE_TTL_MS`` is unloaded replica by replica
  (always ``if_idle`` — the worker, the ground truth for in-flight
  work, declines the race where a request arrived in the window).
- **floors**: ``GRIDLLM_MODEL_FLOORS`` (``model=N,...``) pins SLO-class
  models to a minimum replica count — never unloaded below it, restored
  toward it when under.
- **hysteresis**: per-model ``GRIDLLM_SWAP_COOLDOWN_MS`` between
  actions, so demand flapping around a threshold cannot thrash
  load/unload cycles; at most one op in flight per model.

The controller is advisory machinery on top of a correct-by-itself
scheduler: with it disabled (interval 0, the default) placement is
static and nothing else changes — queued jobs for an unserved model
still wait for an operator-driven load.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any

from gridllm_torch.bus.base import CH_WORKER_ADMIN, MessageBus, admin_result_channel
from gridllm_torch.utils.config import env_int, env_str
from gridllm_torch.utils.logging import get_logger

log = get_logger("scheduler.placement")

# answer budget for one targeted admin op: loads re-read checkpoints, so
# this is generous; a timeout counts as a failed action (cooldown applies,
# the next tick retries elsewhere)
OP_TIMEOUT_S = 120.0

# arrival-rate floor (req/s) below which EWMA residue counts as idle —
# the decayed rate never reaches exactly zero
IDLE_RATE_EPS = 1e-3


def parse_floors(spec: str) -> dict[str, int]:
    """``model=N,model2=M`` → {model: N}; malformed entries are skipped
    loudly (a typo'd floor silently scaling a model to zero is the worst
    failure mode this knob can have)."""
    floors: dict[str, int] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, val = entry.partition("=")
        try:
            floors[name.strip()] = max(int(val), 0)
        except ValueError:
            log.warning("ignoring malformed floor entry", entry=entry)
    return floors


class ModelPlacementController:
    """Per-shard elastic placement loop (see module docstring)."""

    def __init__(self, scheduler: Any, registry: Any, bus: MessageBus,
                 metrics: Any) -> None:
        self.scheduler = scheduler
        self.registry = registry
        self.bus = bus
        self.interval_ms = env_int("GRIDLLM_PLACEMENT_INTERVAL_MS")
        self.idle_ttl_ms = env_int("GRIDLLM_MODEL_IDLE_TTL_MS")
        self.cooldown_ms = env_int("GRIDLLM_SWAP_COOLDOWN_MS")
        self.floors = parse_floors(env_str("GRIDLLM_MODEL_FLOORS"))
        self._task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self._running = False
        # model → monotonic ts of last observed demand (queue/active/
        # arrivals); absent = not yet seen (stamped on first sight so a
        # freshly served model gets a full TTL before idle-unload)
        self._last_active: dict[str, float] = {}
        # model → monotonic ts of last completed action (hysteresis)
        self._last_action: dict[str, float] = {}
        self._inflight: set[str] = set()   # models with an op in flight
        self._unserved: set[str] = set()   # swap-in requests from dispatch
        self._swaps = metrics.counter(
            "gridllm_model_swaps_total",
            "Placement-controller admin ops by op (load/unload) and "
            "outcome (ok / declined / error / timeout).",
            ("op", "outcome"),
        )
        self._g_replicas = metrics.gauge(
            "gridllm_model_replicas",
            "Online workers currently serving each model, as seen by "
            "this shard's placement controller.",
            ("model",),
        )

    @property
    def enabled(self) -> bool:
        return self.interval_ms > 0

    def start(self) -> None:
        if not self.enabled or self._task is not None:
            return
        self._running = True
        self._task = asyncio.create_task(self._loop())
        log.info("placement controller started",
                 interval_ms=self.interval_ms, idle_ttl_ms=self.idle_ttl_ms,
                 cooldown_ms=self.cooldown_ms, floors=self.floors)

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None

    def note_unserved(self, model: str) -> None:
        """Dispatch found a queued job with zero owners: request an
        immediate swap-in instead of waiting out the tick interval."""
        if not self.enabled:
            return
        self._unserved.add(model)
        self._wake.set()

    # ------------------------------------------------------------- loop

    async def _loop(self) -> None:
        while self._running:
            try:
                self._wake.clear()
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), self.interval_ms / 1000.0)
                except asyncio.TimeoutError:
                    pass
                if self._running:
                    await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the loop must survive
                log.warning("placement tick failed", error=str(e))

    async def tick(self) -> None:
        """One decision pass (public: tests drive it directly)."""
        snap = self.scheduler.capacity.snapshot().get("models", {})
        now = time.monotonic()
        names = set(snap) | set(self.floors) | set(self._unserved)
        for model in sorted(names):
            m = snap.get(model, {})
            replicas = [
                w for w in self.registry.get_workers_with_model(model)
                if getattr(w, "healthState", "online") != "quarantined"
            ]
            self._g_replicas.set(len(replicas), model=model)
            queue = int(m.get("queueDepth") or 0)
            busy = (queue > 0
                    or float(m.get("arrivalRate") or 0.0) > IDLE_RATE_EPS
                    or float(m.get("utilization") or 0.0) > 0.0
                    or model in self._unserved)
            if busy or model not in self._last_active:
                self._last_active[model] = now
            if model in self._inflight:
                continue
            floor = self.floors.get(model, 0)
            action: str | None = None
            if len(replicas) < floor:
                action = "load_model"
            elif queue > 0 and not replicas:
                action = "load_model"
            elif (queue > 0 and int(m.get("scaleHint") or 0) > 0
                  and replicas):
                action = "load_model"
            elif (self.idle_ttl_ms > 0 and replicas and not busy
                  and len(replicas) > floor
                  and (now - self._last_active[model]) * 1000.0
                  >= self.idle_ttl_ms):
                action = "unload_model"
            if action is None:
                self._unserved.discard(model)
                continue
            # hysteresis: one action per model per cooldown window. The
            # swap-in path (zero replicas, queued work) is exempt — a
            # model the fleet cannot serve at all must never wait out a
            # cooldown stamped by its own unload.
            held = (now - self._last_action.get(model, -1e9)) * 1000.0
            urgent = action == "load_model" and not replicas and (
                queue > 0 or model in self._unserved or floor > 0)
            if held < self.cooldown_ms and not urgent:
                continue
            target = (self._pick_load_target(model, replicas)
                      if action == "load_model"
                      else self._pick_unload_target(replicas))
            if target is None:
                continue
            self._inflight.add(model)
            self._last_action[model] = now
            try:
                outcome = await self._issue(action, model, target)
            finally:
                self._inflight.discard(model)
            if action == "load_model" and outcome == "ok":
                self._unserved.discard(model)
                # fresh capacity is live — drain any held jobs now
                self.scheduler.request_dispatch()

    # ------------------------------------------------------- target picks

    def _pick_load_target(self, model: str, replicas: list[Any]) -> str | None:
        """Least-loaded online worker not already serving the model:
        fewest resident models first (swap churn concentrates where it
        displaces least), then most free decode slots."""
        serving = {w.workerId for w in replicas}
        candidates = [
            w for w in self.registry.get_online_workers()
            if w.workerId not in serving
            and getattr(w, "healthState", "online") != "quarantined"
        ]
        if not candidates:
            return None
        candidates.sort(key=lambda w: (
            len(w.model_names()),
            -int(getattr(w, "decodeSlotsFree", 0) or 0),
            w.workerId,
        ))
        return candidates[0].workerId

    def _pick_unload_target(self, replicas: list[Any]) -> str | None:
        """Replica with the least in-flight work (the unload is if_idle —
        the worker still declines if anything raced in)."""
        if not replicas:
            return None
        return min(replicas, key=lambda w: (
            int(getattr(w, "currentJobs", 0) or 0), w.workerId,
        )).workerId

    # ------------------------------------------------------------ admin op

    async def _issue(self, op: str, model: str, worker_id: str) -> str:
        """One targeted admin op; returns the outcome label. The result
        subscription is live BEFORE the publish (no ack/answer race)."""
        rid = uuid.uuid4().hex[:12]
        done = asyncio.Event()
        result: dict[str, Any] = {}

        async def on_result(_ch: str, raw: str) -> None:
            msg = json.loads(raw)
            if msg.get("workerId") != worker_id or "ok" not in msg:
                return  # ack frame, or another worker's answer
            result.update(msg)
            done.set()

        sub = await self.bus.subscribe(admin_result_channel(rid), on_result)
        try:
            await self.bus.publish(CH_WORKER_ADMIN, json.dumps({
                "op": op, "id": rid, "model": model, "workerId": worker_id,
                # unloads are ALWAYS conditional: the worker is the ground
                # truth for in-flight work and declines when busy
                "if_idle": op == "unload_model",
            }))
            try:
                await asyncio.wait_for(done.wait(), OP_TIMEOUT_S)
            except asyncio.TimeoutError:
                self._swaps.inc(op=op.removesuffix("_model"), outcome="timeout")
                log.warning("placement op timed out", op=op, model=model,
                            workerId=worker_id)
                return "timeout"
        finally:
            await sub.unsubscribe()
        if result.get("ok"):
            outcome = "ok"
        elif "declined" in str(result.get("detail", "")):
            outcome = "declined"
        else:
            outcome = "error"
        self._swaps.inc(op=op.removesuffix("_model"), outcome=outcome)
        log.info("placement op finished", op=op, model=model,
                 workerId=worker_id, outcome=outcome,
                 detail=result.get("detail", ""))
        return outcome
