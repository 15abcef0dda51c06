"""Worker registry: the server-side worker table + liveness machinery.

Reference analogue: server/src/services/WorkerRegistry.ts (516 LoC). Same
behavioral surface:

- in-memory table mirrored to the bus hash ``workers`` (crash-reload on boot,
  WorkerRegistry.ts:76-110)
- subscribes ``worker:registered/unregistered/heartbeat/status_update/
  disconnected`` (WorkerRegistry.ts:17-55)
- three liveness mechanisms (SURVEY.md §3.5): cleanup sweep on heartbeat
  staleness (:182-219), connection monitor with a quick-disconnect window
  probing the worker's ``heartbeat:{id}`` TTL key (:125-180), and the
  fast-path ``worker:disconnected`` publish from the worker's own socket-close
  handler (:352-369)
- unknown-heartbeat healing: reload from bus or request re-registration via
  ``worker:reregister:{id}`` (:261-323, :496-515)
- model→worker queries and job-count/status accounting (:383-494)

Events emitted: ``worker_registered``, ``worker_removed``, ``worker_heartbeat``,
``worker_status_changed`` (WorkerRegistry.ts:244,378,275,342).

Accelerator extension: capability records may carry ``topology`` and
``shardLayouts`` (utils/types.py) — a multi-host slice registers as ONE
logical worker.
"""

from __future__ import annotations

import asyncio
import json
import time

from gridllm_torch.bus.base import (
    CH_HEALTH_STATE,
    CH_WORKER_DISCONNECTED,
    CH_WORKER_HEARTBEAT,
    CH_WORKER_REGISTERED,
    CH_WORKER_STATUS_UPDATE,
    CH_WORKER_UNREGISTERED,
    MessageBus,
    Subscription,
    liveness_suspended,
    worker_reregister_channel,
)
from gridllm_torch.obs import Counter, Gauge, MetricsRegistry, default_flight_recorder
from gridllm_torch.utils.config import SchedulerConfig
from gridllm_torch.utils.events import EventEmitter
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import WorkerInfo

log = get_logger("scheduler.registry")

WORKERS_KEY = "workers"


class WorkerRegistry(EventEmitter):
    def __init__(self, bus: MessageBus, config: SchedulerConfig | None = None,
                 observer: bool = False):
        super().__init__()
        self.bus = bus
        self.config = config or SchedulerConfig()
        # Observer mode: a stateless gateway replica consumes
        # the heartbeat/registration fan-out for routing and health views
        # but issues NO death verdicts — the cleanup sweep and TTL probe
        # stay off, so only scheduler shards (which own the orphan
        # machinery for their partitions) remove silent workers. Explicit
        # announcements (unregistered/disconnected) still apply: they are
        # the worker's own word, not a liveness judgment.
        self.observer = observer
        self.workers: dict[str, WorkerInfo] = {}
        self._subs: list[Subscription] = []
        self._tasks: list[asyncio.Task] = []
        self._running = False
        self.metrics: MetricsRegistry | None = None
        self._workers_gauge: Gauge | None = None
        self._live_gauge: Gauge | None = None
        self._removed_total: Counter | None = None
        # partition-aware liveness: logs the hold transitions
        # exactly once per partition episode
        self._liveness_held = False

    def attach_metrics(self, metrics: MetricsRegistry) -> None:
        """Wire worker-liveness instruments onto a registry (called by
        JobScheduler.__init__ so gateway /metrics sees them): a by-status
        gauge collected at render time plus a removals counter by reason."""
        self.metrics = metrics
        self._workers_gauge = metrics.gauge(
            "gridllm_workers", "Registered workers, by status.", ("status",))
        self._live_gauge = metrics.gauge(
            "gridllm_workers_live",
            "Live (online or busy) workers, by fleet role "
            "(unified/prefill/decode) — the disaggregated-serving pool "
            "sizes.",
            ("role",))
        self._removed_total = metrics.counter(
            "gridllm_workers_removed_total",
            "Workers removed from the registry, by reason "
            "(unregistered/disconnected/heartbeat_timeout/aliveness_probe).",
            ("reason",),
        )
        metrics.add_collector("worker_registry", self._collect)

    def _collect(self) -> None:
        if self._workers_gauge is None:
            return
        for status, n in self.get_worker_count().items():
            if status == "total":  # derivable; exporting it double-counts
                continue           # every worker under sum(gridllm_workers)
            self._workers_gauge.set(n, status=status)
        if self._live_gauge is not None:
            for role, n in self.role_counts().items():
                self._live_gauge.set(n, role=role)

    # -- lifecycle ----------------------------------------------------------
    async def initialize(self) -> None:
        self._running = True
        # The JAX package's shared-state sanitizer hook (analysis/
        # statecheck tracking the worker map) arrives with the port of
        # analysis/, ROADMAP A 11.
        for channel, handler in [
            (CH_WORKER_REGISTERED, self._on_registered),
            (CH_WORKER_UNREGISTERED, self._on_unregistered),
            (CH_WORKER_HEARTBEAT, self._on_heartbeat),
            (CH_WORKER_STATUS_UPDATE, self._on_status_update),
            (CH_WORKER_DISCONNECTED, self._on_disconnected),
            (CH_HEALTH_STATE, self._on_health_state),
        ]:
            self._subs.append(await self.bus.subscribe(channel, handler))
        await self._load_existing_workers()
        if not self.observer:
            self._tasks.append(asyncio.create_task(self._cleanup_loop()))
            self._tasks.append(
                asyncio.create_task(self._connection_monitor_loop()))
        else:
            # observers still age out silently-dead workers LOCALLY —
            # the shards' authoritative removals are not broadcast, so
            # without this a gateway replica's /health/workers would
            # list a SIGKILLed worker forever. Local prune only: no bus
            # hdel, no removal verdict, just this process's view.
            self._tasks.append(
                asyncio.create_task(self._observer_prune_loop()))
        log.info("worker registry initialized", workers=len(self.workers),
                 observer=self.observer)

    async def shutdown(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        for s in self._subs:
            await s.unsubscribe()
        self._subs.clear()

    async def _load_existing_workers(self) -> None:
        """Crash recovery: reload the `workers` hash, dropping stale entries
        (reference: WorkerRegistry.ts:76-110)."""
        stored = await self.bus.hgetall(WORKERS_KEY)
        timeout_s = self.config.worker_heartbeat_timeout_ms / 1000
        for worker_id, raw in stored.items():
            try:
                info = WorkerInfo.model_validate_json(raw)
            except Exception:
                await self.bus.hdel(WORKERS_KEY, worker_id)
                continue
            if time.time() - info.lastHeartbeat > timeout_s:
                log.worker("dropping stale worker on reload", worker_id)
                await self.bus.hdel(WORKERS_KEY, worker_id)
                continue
            self.workers[worker_id] = info

    # -- bus handlers -------------------------------------------------------
    async def _on_registered(self, _ch: str, raw: str) -> None:
        try:
            info = WorkerInfo.model_validate_json(raw)
        except Exception as e:
            log.error("bad registration payload", error=str(e))
            return
        is_new = info.workerId not in self.workers
        info.lastHeartbeat = time.time()
        prev = self.workers.get(info.workerId)
        if prev is not None:
            # a re-registration must not silently clear a health verdict
            #: the health monitor alone moves a quarantined
            # worker to probation (its worker_registered hook), and the
            # verdict replicates to observers over health:state
            info.healthState = prev.healthState
        self.workers[info.workerId] = info
        await self.bus.hset(WORKERS_KEY, info.workerId, info.model_dump_json())
        log.worker("worker registered", info.workerId,
                   models=info.model_names(), new=is_new)
        if is_new:
            default_flight_recorder().record(
                "registry", "worker_registered", worker=info.workerId,
                models=info.model_names())
        self.emit("worker_registered", info)

    async def _on_unregistered(self, _ch: str, raw: str) -> None:
        try:
            worker_id = json.loads(raw).get("workerId", raw)
        except Exception:
            worker_id = raw
        await self.remove_worker(worker_id, reason="unregistered")

    async def _on_heartbeat(self, _ch: str, raw: str) -> None:
        """reference: WorkerRegistry.ts:261-323 — includes the unknown-worker
        healing path (reload from bus, else request re-registration)."""
        try:
            data = json.loads(raw)
            worker_id = data["workerId"]
        except Exception:
            return
        info = self.workers.get(worker_id)
        if info is None:
            stored = await self.bus.hget(WORKERS_KEY, worker_id)
            if stored:
                try:
                    info = WorkerInfo.model_validate_json(stored)
                    self.workers[worker_id] = info
                    log.worker("worker reloaded from bus on heartbeat", worker_id)
                except Exception:
                    info = None
            if info is None:
                await self.request_worker_reregistration(worker_id)
                return
        info.lastHeartbeat = time.time()
        # Divergence from reference (which copied status/currentJobs from the
        # heartbeat): job accounting is registry-authoritative, driven by
        # mark_worker_busy/available on the job lifecycle. A heartbeat emitted
        # just before an assignment landed would otherwise erase the busy
        # mark and allow over-assignment past maxConcurrentTasks. Heartbeats
        # only refresh liveness and surface error states.
        if data.get("status") == "error":
            info.status = "error"
        # Prefix-affinity digest: the worker's recently-served
        # prefix keys ride each heartbeat; bounded here so a misbehaving
        # worker cannot bloat the registry hash
        prefixes = data.get("prefixKeys")
        if isinstance(prefixes, list):
            # keys arrive oldest→newest; keep the newest when truncating
            info.cachedPrefixes = [str(k) for k in prefixes[-64:]]
        # Disaggregated serving: role, decode-slot headroom,
        # and the worker-to-worker transfer address ride every heartbeat
        # so the scheduler's pool split and the KV sender's HTTP fallback
        # both work from live data
        role = data.get("role")
        if role in ("unified", "prefill", "decode"):
            info.role = role
        if "decodeSlotsFree" in data:
            try:
                info.decodeSlotsFree = max(int(data["decodeSlotsFree"]), 0)
            except (TypeError, ValueError):
                pass
        if data.get("httpAddr"):
            info.httpAddr = str(data["httpAddr"])
        # Capacity signals: per-model slot/KV headroom for the
        # demand tracker behind /admin/capacity; bounded (16 models, int
        # values only) so a misbehaving worker cannot bloat the registry
        mc = data.get("modelCapacity")
        if isinstance(mc, dict):
            bounded: dict[str, dict[str, int]] = {}
            for model, caps in list(mc.items())[:16]:
                if not isinstance(caps, dict):
                    continue
                try:
                    # "engine" is the alias-dedup identity token:
                    # copy-model aliases share it, so fleet totals
                    # can count the shared pool once
                    bounded[str(model)] = {
                        k: max(int(caps.get(k, 0)), 0)
                        for k in ("slotsFree", "slotsTotal", "kvPagesFree",
                                  "engine")
                    }
                except (TypeError, ValueError):
                    continue
            info.modelCapacity = bounded
        # Persist so a restarted server doesn't see a stale lastHeartbeat and
        # evict live workers (reference hsets every beat too).
        await self.bus.hset(WORKERS_KEY, worker_id, info.model_dump_json())
        self.emit("worker_heartbeat", worker_id, data)

    async def _on_status_update(self, _ch: str, raw: str) -> None:
        try:
            data = json.loads(raw)
            worker_id = data["workerId"]
        except Exception:
            return
        info = self.workers.get(worker_id)
        if info is None:
            return
        old = info.status
        info.status = data.get("status", info.status)
        info.currentJobs = int(data.get("currentJobs", info.currentJobs))
        if "capabilities" in data:
            try:
                info.capabilities = info.capabilities.model_validate(data["capabilities"])
            except Exception:
                pass
        info.lastHeartbeat = time.time()
        await self.bus.hset(WORKERS_KEY, worker_id, info.model_dump_json())
        if old != info.status:
            self.emit("worker_status_changed", worker_id, old, info.status)

    async def _on_health_state(self, _ch: str, raw: str) -> None:
        """Apply a health-monitor verdict broadcast on ``health:state`` — shards and observer replicas alike, so placement
        and /health/workers agree fleet-wide. The emitting shard already
        applied it locally; re-applying is idempotent."""
        try:
            data = json.loads(raw)
            worker_id = str(data["worker"])
            state = str(data["state"])
        except Exception:
            return
        self.apply_health_state(worker_id, state)

    def apply_health_state(self, worker_id: str, state: str) -> None:
        if state not in ("online", "degraded", "quarantined", "probation"):
            return
        info = self.workers.get(worker_id)
        if info is None or info.healthState == state:
            return
        old = info.healthState
        info.healthState = state
        log.worker("worker health state applied", worker_id,
                   old=old, new=state)
        self.emit("worker_health_changed", worker_id, old, state)

    async def _on_disconnected(self, _ch: str, raw: str) -> None:
        """Fast eviction path: the worker's own socket-close handler publishes
        this best-effort (reference: RedisConnectionManager.ts:158-179)."""
        try:
            worker_id = json.loads(raw).get("workerId", raw)
        except Exception:
            worker_id = raw
        await self.remove_worker(worker_id, reason="disconnected")

    # -- liveness loops -----------------------------------------------------
    def _liveness_suspended(self) -> bool:
        """Partition-aware liveness: while this process's OWN
        bus session is degraded — or within the rejoin grace after it
        recovers — every "worker died" verdict is suspended. Missing
        heartbeats during a partition mean WE were deaf, not that the
        fleet died; pronouncing workers dead then triggers a mass
        orphan-requeue storm of perfectly healthy jobs. Workers silent
        for organic reasons are caught on the first sweep after the
        grace expires — their lastHeartbeat keeps aging through the hold."""
        held = liveness_suspended(self.bus, self.config.bus_rejoin_grace_ms)
        if held and not self._liveness_held:
            log.warning("bus session degraded; suspending worker-death "
                        "verdicts")
            default_flight_recorder().record(
                "registry", "liveness_suspended", workers=len(self.workers))
        elif not held and self._liveness_held:
            log.info("bus session healthy; liveness verdicts resume")
            default_flight_recorder().record(
                "registry", "liveness_resumed", workers=len(self.workers))
        self._liveness_held = held
        return held

    async def _cleanup_loop(self) -> None:
        """Sweep workers whose lastHeartbeat exceeds the timeout
        (reference: WorkerRegistry.ts:112-123, 182-219)."""
        interval = self.config.worker_cleanup_interval_ms / 1000
        timeout_s = self.config.worker_heartbeat_timeout_ms / 1000
        while self._running:
            await asyncio.sleep(interval)
            if self._liveness_suspended():
                continue
            now = time.time()
            for worker_id, info in list(self.workers.items()):
                if now - info.lastHeartbeat > timeout_s:
                    log.worker("worker heartbeat timed out", worker_id,
                               silent_s=round(now - info.lastHeartbeat, 1))
                    await self.remove_worker(worker_id, reason="heartbeat_timeout")

    async def _observer_prune_loop(self) -> None:
        """Observer-mode staleness prune: drop workers whose
        heartbeats stopped from THIS process's table only. The bus hash
        and the death verdict (orphan machinery, removal metrics) belong
        to the scheduler shards; the same partition-aware liveness hold
        applies — a deaf bus session must not read as a fleet die-off."""
        interval = self.config.worker_cleanup_interval_ms / 1000
        timeout_s = self.config.worker_heartbeat_timeout_ms / 1000
        while self._running:
            await asyncio.sleep(interval)
            if self._liveness_suspended():
                continue
            now = time.time()
            for worker_id, info in list(self.workers.items()):
                if now - info.lastHeartbeat > timeout_s:
                    self.workers.pop(worker_id, None)
                    log.worker("stale worker pruned from observer view",
                               worker_id,
                               silent_s=round(now - info.lastHeartbeat, 1))
                    self.emit("worker_removed", worker_id, info,
                              "observer_stale")

    async def _connection_monitor_loop(self) -> None:
        """Quick-disconnect detection: any worker silent beyond the
        quick-disconnect window gets its `heartbeat:{id}` TTL key probed; a
        missing key means abrupt death (reference: WorkerRegistry.ts:125-180)."""
        interval = self.config.connection_monitor_interval_ms / 1000
        window_s = self.config.quick_disconnect_window_ms / 1000
        while self._running:
            await asyncio.sleep(interval)
            if liveness_suspended(self.bus, self.config.bus_rejoin_grace_ms):
                # same hold as the cleanup sweep (which owns the state
                # transition logging): during a partition the TTL probe
                # would ALSO misfire — the key expired because nobody
                # could refresh it through us, not because workers died
                continue
            now = time.time()
            for worker_id, info in list(self.workers.items()):
                if now - info.lastHeartbeat <= window_s:
                    continue
                ttl = await self.bus.ttl(f"heartbeat:{worker_id}")
                if ttl == -2:  # key expired/missing → worker died abruptly
                    log.worker("worker aliveness probe failed", worker_id)
                    await self.remove_worker(worker_id, reason="aliveness_probe")

    # -- mutation -----------------------------------------------------------
    async def remove_worker(self, worker_id: str, reason: str = "") -> None:
        info = self.workers.pop(worker_id, None)
        await self.bus.hdel(WORKERS_KEY, worker_id)
        if info is not None:
            if self._removed_total is not None:
                self._removed_total.inc(reason=reason or "unknown")
            log.worker("worker removed", worker_id, reason=reason)
            default_flight_recorder().record(
                "registry", "worker_removed", worker=worker_id,
                reason=reason or "unknown", currentJobs=info.currentJobs)
            self.emit("worker_removed", worker_id, info, reason)

    async def request_worker_reregistration(self, worker_id: str) -> None:
        """reference: WorkerRegistry.ts:496-515."""
        log.worker("requesting re-registration", worker_id)
        await self.bus.publish(
            worker_reregister_channel(worker_id),
            json.dumps({"type": "reregistration_request", "timestamp": time.time()}),
        )

    async def update_worker_job_count(self, worker_id: str, delta: int) -> None:
        """Busy/online transitions against maxConcurrentTasks
        (reference: WorkerRegistry.ts:421-454)."""
        info = self.workers.get(worker_id)
        if info is None:
            return
        info.currentJobs = max(0, info.currentJobs + delta)
        if delta < 0:  # job finished (reference: WorkerRegistry.ts:441-443)
            info.totalJobsProcessed += 1
        old = info.status
        # Divergence from reference (which used the server-wide
        # maxConcurrentJobsPerWorker config): the worker's own advertised
        # capacity governs, so workers with continuous batching can take
        # maxBatchSlots concurrent jobs.
        cap = max(info.capabilities.maxConcurrentTasks, 1)
        # busy/online transitions only apply to workers that are actually
        # serving: a "draining" worker must never be flipped
        # back into placement by job-count bookkeeping racing its drain —
        # the worker itself is the only authority that clears draining
        # (by restarting)
        if info.status in ("online", "busy"):
            if info.currentJobs >= cap:
                info.status = "busy"
            elif info.currentJobs < cap and info.status == "busy":
                info.status = "online"
        await self.bus.hset(WORKERS_KEY, worker_id, info.model_dump_json())
        if old != info.status:
            self.emit("worker_status_changed", worker_id, old, info.status)

    async def mark_worker_busy(self, worker_id: str) -> None:
        await self.update_worker_job_count(worker_id, +1)

    async def mark_worker_available(self, worker_id: str) -> None:
        await self.update_worker_job_count(worker_id, -1)

    # -- queries ------------------------------------------------------------
    def get_worker(self, worker_id: str) -> WorkerInfo | None:
        return self.workers.get(worker_id)

    def get_all_workers(self) -> list[WorkerInfo]:
        return list(self.workers.values())

    def get_online_workers(self) -> list[WorkerInfo]:
        return [w for w in self.workers.values() if w.status in ("online", "busy")]

    def get_available_workers(self) -> list[WorkerInfo]:
        return [
            w for w in self.workers.values()
            if w.status == "online"
            and w.currentJobs < max(w.capabilities.maxConcurrentTasks, 1)
            # quarantined workers are routed around even
            # while their own status still says online — the health
            # verdict outranks the worker's word; degraded/probation
            # stay placeable (scored down in _select_worker)
            and w.healthState != "quarantined"
        ]

    def get_available_workers_by_model(self, model: str) -> list[WorkerInfo]:
        """reference: WorkerRegistry.ts:413."""
        return [w for w in self.get_available_workers() if model in w.model_names()]

    def get_workers_with_model(self, model: str) -> list[WorkerInfo]:
        return [w for w in self.get_online_workers() if model in w.model_names()]

    def get_all_available_models(self) -> list[dict]:
        """Aggregate model records across workers, annotated with
        num_workers_with_model (reference: WorkerRegistry.ts:484-494 +
        ollama.ts:507-571 gridllm_metadata)."""
        by_name: dict[str, dict] = {}
        for w in self.get_online_workers():
            for m in w.capabilities.availableModels:
                entry = by_name.setdefault(m.name, {**m.model_dump(exclude_none=True), "_workers": 0})
                entry["_workers"] += 1
        out = []
        for entry in by_name.values():
            n = entry.pop("_workers")
            entry["gridllm_metadata"] = {"num_workers_with_model": n}
            out.append(entry)
        return out

    def role_counts(self) -> dict[str, int]:
        """Live (online/busy) workers per fleet role — the one
        source for both the gridllm_workers_live gauge and the
        /health/workers roles block."""
        live = {"unified": 0, "prefill": 0, "decode": 0}
        for w in self.get_online_workers():
            live[w.role] = live.get(w.role, 0) + 1
        return live

    def get_worker_count(self) -> dict[str, int]:
        all_w = list(self.workers.values())
        return {
            "total": len(all_w),
            "online": sum(1 for w in all_w if w.status == "online"),
            "busy": sum(1 for w in all_w if w.status == "busy"),
            "offline": sum(1 for w in all_w if w.status == "offline"),
            # draining: alive but refusing new work — excluded
            # from placement yet never force-removed while heartbeating
            "draining": sum(1 for w in all_w if w.status == "draining"),
        }
