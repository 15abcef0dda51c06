"""Scheduler shard: one leased partition owner in the scaled control
plane.

A ``SchedulerShard`` wires together a full JobScheduler (with a
ShardContext restricting it to leased partitions), the lease manager,
and the ``ctrl:submit``/``ctrl:cancel`` subscriptions. Worker heartbeats
fan out once on the bus and this shard's registry consumes them like
any other — orphan sweeps, retry/backoff budgets, SLO accounting,
deadlines, and the hang watchdog all run here, per shard, exactly as
they ran in the single-box scheduler.

Failover is handled like worker failure already is: when another
shard's lease expires, this member's lease sweep adopts the partition
(epoch bump) and ``adopt_shard`` replays the dead shard's durable job
state from the bus — queued records rejoin the queue, live assignments
re-arm with their remaining timeout, and the jobs' workers never notice
(their streams flow straight to the gateway replicas). A deposed shard
is fenced out of every mutating path by the scheduler's lease checks,
so a partitioned shard can never double-assign a job it no longer owns.
"""

from __future__ import annotations

import asyncio
import json
import time

from gridllm_torch.bus.base import (
    CH_CTRL_CANCEL,
    CH_CTRL_SUBMIT,
    MessageBus,
    Subscription,
)
from gridllm_torch.controlplane.lease import ShardLeaseManager
from gridllm_torch.controlplane.partition import ShardContext
from gridllm_torch.scheduler.registry import WorkerRegistry
from gridllm_torch.scheduler.scheduler import JobScheduler
from gridllm_torch.utils.config import ControlPlaneConfig, SchedulerConfig
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import InferenceRequest

log = get_logger("controlplane.shard")


class SchedulerShard:
    def __init__(self, bus: MessageBus, registry: WorkerRegistry,
                 scheduler_config: SchedulerConfig | None = None,
                 cp: ControlPlaneConfig | None = None,
                 member_id: str = "", settle_s: float | None = None,
                 slo_config=None, watchdog_config=None):
        from gridllm_torch.controlplane.client import make_member_id

        cp = cp or ControlPlaneConfig()
        self.bus = bus
        self.registry = registry
        self.member_id = make_member_id(member_id or cp.member_id, "shard")
        self.lease = ShardLeaseManager(
            bus, self.member_id, cp.num_shards,
            home_shards=(cp.shard_id,),
            ttl_ms=cp.lease_ttl_ms, renew_ms=cp.renew_interval_ms,
            on_acquired=self._on_lease_acquired,
            on_lost=self._on_lease_lost,
            settle_s=settle_s)
        self.ctx = ShardContext(cp.num_shards, self.member_id, self.lease)
        self.scheduler = JobScheduler(
            bus, registry, scheduler_config, shard=self.ctx,
            slo_config=slo_config, watchdog_config=watchdog_config)
        # the lease metrics join the shard scheduler's registry so the
        # shard health port's /metrics serves them
        self.lease.attach_metrics(self.scheduler.metrics)
        self._subs: list[Subscription] = []
        self._started = False

    # -- lease callbacks -----------------------------------------------------
    async def _on_lease_acquired(self, idx: int, adopted: bool) -> None:
        if adopted and self._started:
            await self.scheduler.adopt_shard(idx)

    async def _on_lease_lost(self, idx: int, reason: str) -> None:
        self.scheduler.release_shard(idx)

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        """Order matters: the home lease first (so initialize() loads the
        partition's durable state), then the scheduler's full machinery,
        then the submission fan-in."""
        await self.lease.start()
        await self.scheduler.initialize()
        self._started = True
        self._subs.append(
            await self.bus.subscribe(CH_CTRL_SUBMIT, self._on_submit))
        self._subs.append(
            await self.bus.subscribe(CH_CTRL_CANCEL, self._on_cancel))
        log.info("scheduler shard started", member=self.member_id,
                 shards=self.lease.held_shards(),
                 num_shards=self.ctx.num_shards)

    async def stop(self) -> None:
        for s in self._subs:
            await s.unsubscribe()
        self._subs.clear()
        await self.scheduler.shutdown()
        await self.lease.stop(release=True)

    async def kill(self) -> None:
        """Chaos/test hook: die the way SIGKILL dies — drop every
        subscription and timer with NO handoff, NO lease release, NO
        durable-state cleanup. The fleet only learns from the lease TTL
        running out, exactly like a killed process."""
        self.lease.kill()
        for s in self._subs:
            await s.unsubscribe()
        self._subs.clear()
        sched = self.scheduler
        sched._running = False
        await sched.watchdog.stop()
        if sched._sweep_task is not None:
            sched._sweep_task.cancel()
            sched._sweep_task = None
        for h in (*sched._timeout_handles.values(),
                  *sched._retry_handles.values()):
            h.cancel()
        sched._timeout_handles.clear()
        sched._retry_handles.clear()
        for s in sched._subs:
            await s.unsubscribe()
        sched._subs.clear()

    # -- submission fan-in ---------------------------------------------------
    async def _on_submit(self, _ch: str, raw: str) -> None:
        try:
            data = json.loads(raw)
            request = InferenceRequest.model_validate(data["request"])
        except Exception as e:  # noqa: BLE001 — bad submits are dropped loud
            log.error("bad ctrl:submit payload", error=str(e))
            return
        if not self.ctx.owns(request.id):
            if await self._park_submission(request):
                self.scheduler._ctrl_submits.inc(event="parked")
            else:
                self.scheduler._ctrl_submits.inc(event="ignored")
            return
        self.scheduler._ctrl_submits.inc(event="accepted")
        await self.scheduler.add_job(request)

    async def _park_submission(self, request: InferenceRequest) -> bool:
        """Owner-less-window recovery: a submit whose partition owner is
        dead — whether its lease has visibly expired yet or not — would
        otherwise be dropped by every shard and lost until the client
        times out. Every NON-owner therefore parks the request straight
        into the partition's durable queue record (idempotent across
        shards: same hash field, same content), so whichever member owns
        or adopts the partition replays it. The live owner's normal flow
        subsumes the parked copy: enqueue overwrites the same field and
        dispatch/cancel hdel it. A ghost record left by a park racing
        past the owner's hdel is defused at adoption by the
        actives-first/_recent_done replay checks and, last-ditch, the
        worker-side duplicate-assignment drop. The timestamp-derived seq
        sorts parked jobs after any replayed backlog."""
        from gridllm_torch.scheduler.scheduler import shard_queue_key

        idx = self.ctx.shard_for(request.id)
        try:
            await self.bus.hset(shard_queue_key(idx), request.id,
                                json.dumps({
                                    "seq": int(time.time() * 1000),
                                    "request": request.model_dump(
                                        mode="json"),
                                }))
        except Exception as e:  # noqa: BLE001 — parking is best-effort
            log.warning("submission park failed",
                        job_id=request.id, error=str(e))
            return False
        return True

    async def _on_cancel(self, _ch: str, raw: str) -> None:
        try:
            data = json.loads(raw)
            job_id = str(data["jobId"])
        except Exception:
            return
        if not self.ctx.owns(job_id):
            return
        await self.scheduler.cancel_job(
            job_id, reason=str(data.get("reason") or "cancelled"))


async def wait_for_ownership(shards: list[SchedulerShard],
                             num_shards: int,
                             timeout_s: float = 10.0) -> bool:
    """Test/boot helper: wait until every partition is held by someone."""
    deadline = asyncio.get_running_loop().time() + timeout_s
    while asyncio.get_running_loop().time() < deadline:
        held = {i for sh in shards for i in sh.lease.held_shards()}
        if len(held) >= num_shards:
            return True
        await asyncio.sleep(0.02)
    return False
