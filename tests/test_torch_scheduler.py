"""The port's scheduler against the JAX package's, on one scripted fleet.

Each case runs the same script twice at once: the JAX `WorkerRegistry` and
`JobScheduler` on the JAX `InMemoryBus` with `tests/helpers.py`'s
`FakeWorker`, and the port's on the port's `InMemoryBus` with `TFakeWorker`,
a copy of that fake on the port's bus and wire types. Both sides give the
same worker picks and assignment order, the same `JobResult` and
`StreamChunk` JSON apart from times, the same `get_stats()`, registry
counts and metric series (counters and histogram counts by value, gauges
by name and labels). One case per behaviour of tests/test_scheduler.py,
plus preemption, drain handoff and deadline shedding. The config cases
hold `load_config()`'s scheduler, SLO and watchdog sections equal field by
field under one environment, and refused alike when a value is invalid.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random
import time
from types import SimpleNamespace

import pytest

import gridllm_torch.bus as tbus
import gridllm_torch.scheduler as tsched
import gridllm_torch.scheduler.scheduler as tsched_mod
import gridllm_torch.utils.config as tconfig
import gridllm_torch.utils.types as ttypes
import gridllm_tpu.bus as jbus
import gridllm_tpu.scheduler as jsched
import gridllm_tpu.scheduler.scheduler as jsched_mod
import gridllm_tpu.utils.config as jconfig
import gridllm_tpu.utils.types as jtypes

from .helpers import FakeWorker, fast_config

SEED = 7


class TFakeWorker:
    """tests/helpers.py's FakeWorker on the port's bus and wire types."""

    def __init__(self, bus, worker_id: str, models: list[str],
                 max_concurrent: int = 1, heartbeat_interval_s: float = 0.2,
                 reply: str = "canned response", delay_s: float = 0.0,
                 fail_times: int = 0, stream_tokens: list[str] | None = None,
                 fail_retryable: bool = True, nack_times: int = 0,
                 layouts: list | None = None, stream_delay_s: float = 0.0):
        self.bus = bus
        self.worker_id = worker_id
        self.models = models
        self.max_concurrent = max_concurrent
        self.heartbeat_interval_s = heartbeat_interval_s
        self.reply = reply
        self.delay_s = delay_s
        self.fail_times = fail_times
        self.fail_retryable = fail_retryable
        self.nack_times = nack_times
        self.layouts = layouts or []
        self.stream_tokens = stream_tokens
        self.stream_delay_s = stream_delay_s
        self.current_jobs = 0
        self.processed: list[str] = []
        self.cancelled: list[str] = []
        self.assignments: list[str] = []
        self._subs = []
        self._hb_task: asyncio.Task | None = None
        self._running = False

    def _info(self):
        return ttypes.WorkerInfo(
            workerId=self.worker_id,
            capabilities=ttypes.NodeCapabilities(
                workerId=self.worker_id,
                availableModels=[ttypes.ModelInfo(name=m) for m in self.models],
                maxConcurrentTasks=self.max_concurrent,
                shardLayouts=self.layouts,
            ),
            status="online",
            currentJobs=self.current_jobs,
        )

    async def start(self) -> None:
        self._running = True
        self._subs.append(await self.bus.subscribe(
            f"worker:{self.worker_id}:job", self._on_job_message))
        self._subs.append(await self.bus.subscribe(
            f"worker:reregister:{self.worker_id}", self._on_reregister))
        await self.register()
        self._hb_task = asyncio.create_task(self._heartbeat_loop())

    async def register(self) -> None:
        info = self._info()
        await self.bus.hset("workers", self.worker_id, info.model_dump_json())
        await self.bus.publish("worker:registered", info.model_dump_json())

    async def stop(self, announce: bool = True) -> None:
        self._running = False
        if self._hb_task:
            self._hb_task.cancel()
            self._hb_task = None
        for s in self._subs:
            await s.unsubscribe()
        self._subs.clear()
        if announce:
            await self.bus.publish("worker:unregistered",
                                   json.dumps({"workerId": self.worker_id}))

    async def die(self) -> None:
        await self.stop(announce=False)
        await self.bus.delete(f"heartbeat:{self.worker_id}")

    async def _heartbeat_loop(self) -> None:
        while self._running:
            await self.bus.set_with_expiry(
                f"heartbeat:{self.worker_id}", str(time.time()),
                ttl_s=self.heartbeat_interval_s * 2)
            await self.bus.publish("worker:heartbeat", json.dumps({
                "workerId": self.worker_id,
                "status": "busy" if self.current_jobs >= self.max_concurrent else "online",
                "currentJobs": self.current_jobs,
            }))
            await asyncio.sleep(self.heartbeat_interval_s)

    async def _on_reregister(self, _ch: str, _raw: str) -> None:
        await self.register()

    async def _on_job_message(self, _ch: str, raw: str) -> None:
        msg = json.loads(raw)
        if msg.get("type") == "job_cancellation":
            self.cancelled.append(msg["jobId"])
            return
        if msg.get("type") != "job_assignment":
            return
        assignment = ttypes.JobAssignment.model_validate(msg["job"])
        self.assignments.append(assignment.jobId)
        if self.nack_times > 0:
            self.nack_times -= 1
            result = ttypes.JobResult(jobId=assignment.jobId, workerId=self.worker_id,
                                      success=False, error="worker at capacity", nack=True)
            asyncio.ensure_future(self.bus.publish("job:failed", result.model_dump_json()))
            return
        asyncio.ensure_future(self._execute(assignment))

    async def _execute(self, assignment) -> None:
        self.current_jobs += 1
        start = time.time()
        job_id = assignment.jobId
        try:
            if self.delay_s:
                await asyncio.sleep(self.delay_s)
            if job_id in self.cancelled:
                return
            if self.fail_times > 0:
                self.fail_times -= 1
                result = ttypes.JobResult(jobId=job_id, workerId=self.worker_id,
                                          success=False, error="injected failure",
                                          retryable=self.fail_retryable,
                                          processingTimeMs=(time.time() - start) * 1000)
                await self.bus.publish("job:failed", result.model_dump_json())
                return
            if self.stream_tokens is not None and assignment.request.stream:
                offset = 0
                for i, tok in enumerate(self.stream_tokens):
                    if self.stream_delay_s and i:
                        await asyncio.sleep(self.stream_delay_s)
                    await self.bus.publish(f"job:stream:{job_id}", ttypes.StreamChunk(
                        id=job_id, model=assignment.request.model,
                        created_at=ttypes.iso_now(), response=tok, done=False,
                        offset=offset,
                    ).model_dump_json())
                    offset += len(tok)
                text = "".join(self.stream_tokens)
            else:
                text = self.reply
            self.processed.append(job_id)
            response = ttypes.InferenceResponse(
                id=job_id, model=assignment.request.model, created_at=ttypes.iso_now(),
                response=text, done=True, done_reason="stop",
                eval_count=len(text.split()),
                total_duration=int((time.time() - start) * 1e9),
            )
            result = ttypes.JobResult(jobId=job_id, workerId=self.worker_id,
                                      success=True, response=response,
                                      processingTimeMs=(time.time() - start) * 1000)
            await self.bus.publish("job:completed", result.model_dump_json())
            await self.bus.publish(f"job:result:{job_id}", result.model_dump_json())
        finally:
            self.current_jobs -= 1


class _Extras:
    """What the scheduler's preemption and drain paths need of a worker,
    the same on both sides: a `job_preempt` ask is answered on
    job:preempted with a watermark, `drain_job` reports a suspended job on
    job:drain; either way the running execution is cancelled and publishes
    nothing. Every assignment's metadata is kept."""

    SNAPSHOT = {"tokens": [5, 6, 7], "seed": 11}

    def _extras(self):
        if not hasattr(self, "seen"):
            self.seen = []          # (jobId, metadata) per assignment
            self.preempted = []
            self._runs = {}         # jobId -> its running execution
        return self

    async def _execute(self, assignment) -> None:
        self._extras()._runs[assignment.jobId] = asyncio.current_task()
        try:
            await super()._execute(assignment)
        except asyncio.CancelledError:
            pass   # suspended by _suspend below: the job went elsewhere

    def _suspend(self, job_id: str) -> None:
        run = self._extras()._runs.pop(job_id, None)
        if run is not None:
            run.cancel()

    async def _on_job_message(self, ch: str, raw: str) -> None:
        self._extras()
        msg = json.loads(raw)
        if msg.get("type") == "job_preempt":
            job_id = msg["jobId"]
            self.preempted.append(job_id)
            self._suspend(job_id)
            await self.bus.publish("job:preempted", json.dumps({
                "jobId": job_id, "fromWorker": self.worker_id,
                "snapshot": self.SNAPSHOT, "parkedTokens": 3}))
            return
        if msg.get("type") == "job_assignment":
            job = msg["job"]
            self.seen.append((job["jobId"], _scrub(job["request"]["metadata"])))
        await super()._on_job_message(ch, raw)

    async def announce_draining(self) -> None:
        """Re-register with status "draining", as a worker that starts its
        graceful drain does."""
        info = self._info()
        info.status = "draining"
        await self.bus.hset("workers", self.worker_id, info.model_dump_json())
        await self.bus.publish("worker:registered", info.model_dump_json())

    async def drain_job(self, job_id: str, to_worker: str = "") -> None:
        self._suspend(job_id)
        await self.bus.publish("job:drain", json.dumps({
            "jobId": job_id, "fromWorker": self.worker_id, "migrated": bool(to_worker),
            "toWorker": to_worker, "snapshot": self.SNAPSHOT, "tokens": 3}))


class JFake(_Extras, FakeWorker):
    pass


class TFake(_Extras, TFakeWorker):
    pass


def _side(kind: str):
    if kind == "jax":
        mods = SimpleNamespace(bus=jbus, sched=jsched, sched_mod=jsched_mod, types=jtypes,
                               config=jconfig, Fake=JFake)
        cfg = fast_config()
    else:
        mods = SimpleNamespace(bus=tbus, sched=tsched, sched_mod=tsched_mod, types=ttypes,
                               config=tconfig, Fake=TFake)
        cfg = tconfig.SchedulerConfig(**{f: getattr(fast_config(), f)
                                         for f in type(fast_config()).model_fields})
    mods.cfg = cfg
    return mods


def _with(cfg, **kw):
    if dataclasses.is_dataclass(cfg):
        return dataclasses.replace(cfg, **kw)
    return cfg.model_copy(update=kw)


# keys whose values are times or durations
_TIME_KEYS = {"completedAt", "processingTimeMs", "total_duration", "created_at",
              "assignedAt", "lastHeartbeat", "registeredAt", "lastUpdated", "orphanedAt",
              "enqueuedAt", "firstSubmittedAt", "submittedAt", "deadlineAt"}


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: ("<t>" if k in _TIME_KEYS else _scrub(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _json(model) -> dict:
    return _scrub(json.loads(model.model_dump_json()))


# counters that count sweeps of the clock, not events of the script
_CLOCK_SERIES = ("gridllm_watchdog_sweeps_total",)


def _series(registry) -> dict:
    out = {}
    for line in registry.render().splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name = key.split("{", 1)[0]
        if name.endswith(("_bucket", "_sum")) or name in _CLOCK_SERIES:
            continue
        kind = "value" if name.endswith(("_total", "_count")) else "gauge"
        out[key] = float(value) if kind == "value" else kind
    return out


class Run:
    """One side's bus, registry, scheduler and fake workers."""

    def __init__(self, kind: str, **cfg):
        self.kind = kind
        self.m = _side(kind)
        self.cfg = _with(self.m.cfg, **cfg) if cfg else self.m.cfg
        self.workers: dict[str, object] = {}
        self.order: list[str] = []
        self._n = 0

    async def __aenter__(self):
        m = self.m
        self.bus = m.bus.InMemoryBus(key_prefix="T:")
        await self.bus.connect()
        self.registry = m.sched.WorkerRegistry(self.bus, self.cfg)
        self.scheduler = m.sched.JobScheduler(self.bus, self.registry, self.cfg)
        await self.registry.initialize()
        await self.scheduler.initialize()
        self.scheduler.on("job_assigned", lambda a: self.order.append(
            f"{a.jobId}->{a.workerId}"))
        return self

    async def __aexit__(self, *exc):
        for w in self.workers.values():
            await w.stop(announce=False)
        await self.scheduler.shutdown()
        await self.registry.shutdown()
        await self.bus.disconnect()

    async def worker(self, wid: str, models, **kw):
        w = self.m.Fake(self.bus, wid, models, **kw)
        self.workers[wid] = w
        await w.start()
        return w

    def req(self, model="m1", priority="medium", **kw):
        self._n += 1
        return self.m.types.InferenceRequest(
            id=f"job-{self._n:03d}", model=model, prompt="hi",
            priority=self.m.types.Priority(priority), **kw)

    def layout(self, **kw):
        return self.m.types.ModelShardLayout(**kw)

    def record(self) -> dict:
        stats = dict(self.scheduler.get_stats())
        return {
            "order": list(self.order),
            "stats": stats,
            "workers": self.registry.get_worker_count(),
            "processed": {w: list(f.processed) for w, f in sorted(self.workers.items())},
            "assignments": {w: list(f.assignments) for w, f in sorted(self.workers.items())},
            "cancelled": {w: list(f.cancelled) for w, f in sorted(self.workers.items())},
            "series": _series(self.scheduler.metrics),
            "registry_series": _series(self.registry.metrics)
            if self.registry.metrics is not None else None,
        }


# -- the scripts -------------------------------------------------------------
# Each takes a Run and returns what it observed; the run's record is added.


async def s_register_and_complete(r: Run):
    await r.worker("w1", ["m1"])
    await r.bus.flush()
    res = await r.scheduler.submit_and_wait(r.req(), timeout_ms=3000)
    w = r.registry.get_worker("w1")
    return {"result": _json(res), "currentJobs": w.currentJobs,
            "totalJobsProcessed": w.totalJobsProcessed}


async def s_least_loaded(r: Run):
    await r.worker("w1", ["m1"], max_concurrent=4, delay_s=0.3)
    await r.worker("w2", ["m1"], max_concurrent=4, delay_s=0.3)
    await r.bus.flush()
    results = await asyncio.gather(
        *[r.scheduler.submit_and_wait(r.req(), timeout_ms=4000) for _ in range(4)])
    return {"results": sorted((x.jobId, x.workerId, x.success) for x in results)}


async def s_model_routing(r: Run):
    await r.worker("w1", ["llama"], reply="from-llama")
    await r.worker("w2", ["mixtral"], reply="from-mixtral")
    await r.bus.flush()
    r1 = await r.scheduler.submit_and_wait(r.req(model="llama"), timeout_ms=3000)
    r2 = await r.scheduler.submit_and_wait(r.req(model="mixtral"), timeout_ms=3000)
    return {"results": [_json(r1), _json(r2)]}


async def s_priority_order(r: Run):
    await r.worker("w1", ["m1"], delay_s=0.15)
    await r.bus.flush()
    done = []

    async def submit(q):
        res = await r.scheduler.submit_and_wait(q, timeout_ms=8000)
        done.append(q.id)
        return res

    blocker = asyncio.ensure_future(submit(r.req()))
    await asyncio.sleep(0.05)
    low1, low2, high = r.req(priority="low"), r.req(priority="low"), r.req(priority="high")
    tasks = [asyncio.ensure_future(submit(low1)), asyncio.ensure_future(submit(low2))]
    await asyncio.sleep(0.01)
    tasks.append(asyncio.ensure_future(submit(high)))
    await asyncio.gather(blocker, *tasks)
    return {"done": done}


async def s_queued_until_owner(r: Run):
    fut = asyncio.ensure_future(r.scheduler.submit_and_wait(r.req(model="late"),
                                                            timeout_ms=5000))
    await asyncio.sleep(0.2)
    queued = r.scheduler.get_stats()["queuedJobs"]
    await r.worker("w1", ["late"])
    return {"queued": queued, "result": _json(await fut)}


async def s_retry_then_success(r: Run):
    await r.worker("w1", ["m1"], fail_times=2)
    await r.bus.flush()
    return {"result": _json(await r.scheduler.submit_and_wait(r.req(), timeout_ms=5000))}


async def s_retries_exhausted(r: Run):
    await r.worker("w1", ["m1"], fail_times=99)
    await r.bus.flush()
    res = await r.scheduler.submit_and_wait(r.req(), timeout_ms=5000)
    return {"result": _json(res), "total_failed": r.scheduler.total_failed}


async def s_non_retryable(r: Run):
    w = await r.worker("w1", ["m1"], fail_times=99, fail_retryable=False)
    await r.bus.flush()
    res = await r.scheduler.submit_and_wait(r.req(), timeout_ms=5000)
    return {"result": _json(res), "fail_times": w.fail_times}


async def s_nack(r: Run):
    await r.worker("w1", ["m1"], nack_times=5)
    await r.bus.flush()
    res = await r.scheduler.submit_and_wait(r.req(), timeout_ms=5000)
    return {"result": _json(res), "total_failed": r.scheduler.total_failed}


async def s_orphan_on_death(r: Run):
    doomed = await r.worker("doomed", ["m1"], delay_s=10)
    await r.bus.flush()
    orphaned = []
    r.scheduler.on("job_orphaned", lambda q: orphaned.append(_json(q)))
    fut = asyncio.ensure_future(r.scheduler.submit_and_wait(r.req(), timeout_ms=8000))
    await asyncio.sleep(0.1)
    active = r.scheduler.get_stats()["activeJobs"]
    await doomed.die()
    await r.worker("backup", ["m1"], reply="rescued")
    res = await asyncio.wait_for(fut, 8)
    return {"active": active, "orphaned": orphaned, "result": _json(res)}


async def s_heartbeat_eviction(r: Run):
    w = await r.worker("w1", ["m1"])
    await r.bus.flush()
    before = r.registry.get_worker("w1") is not None
    await w.stop(announce=False)
    await r.bus.delete("heartbeat:w1")
    await asyncio.sleep(1.0)
    return {"before": before, "after": r.registry.get_worker("w1") is not None}


async def s_unregister_and_reregister(r: Run):
    w = await r.worker("w1", ["m1"])
    await r.bus.flush()
    present = r.registry.get_worker("w1") is not None
    await w.stop(announce=True)
    await r.bus.flush()
    gone = r.registry.get_worker("w1") is None
    asks = []

    async def spy(_ch, m):
        asks.append(m)

    await r.bus.subscribe("worker:reregister:ghost", spy)
    await r.bus.publish("worker:heartbeat", json.dumps(
        {"workerId": "ghost", "status": "online", "currentJobs": 0}))
    await r.bus.flush()
    return {"present": present, "gone": gone, "reregister_asks": len(asks) >= 1}


async def s_timeout_and_cancel(r: Run):
    w = await r.worker("w1", ["m1"], delay_s=10)
    await r.bus.flush()
    with pytest.raises(r.m.sched_mod.JobTimeoutError):
        await r.scheduler.submit_and_wait(r.req(), timeout_ms=300)
    await asyncio.sleep(0.05)
    queued = r.req()
    await r.scheduler.add_job(queued)      # queued behind nothing: w1 is busy
    await r.bus.flush()
    cancelled = await r.scheduler.cancel_job(queued.id)
    return {"active": r.scheduler.get_stats()["activeJobs"], "worker_cancels": len(w.cancelled),
            "cancel": cancelled}


async def s_cancel_during_retry(r: Run):
    w = await r.worker("w1", ["m1"], fail_times=99)
    await r.bus.flush()
    q = r.req()
    await r.scheduler.add_job(q)
    await asyncio.sleep(0.2)
    in_window = q.id in r.scheduler._retry_handles
    ok = await r.scheduler.cancel_job(q.id)
    before = w.fail_times
    await asyncio.sleep(1.2)
    return {"in_window": in_window, "cancel": ok, "resurrected": w.fail_times != before}


async def s_stream_chunks(r: Run):
    toks = [f"t{i} " for i in range(10)]
    await r.worker("w1", ["m1"], stream_tokens=toks)
    await r.bus.flush()
    got = []

    async def on_chunk(chunk):
        got.append(_json(chunk))

    res = await r.scheduler.submit_streaming_job(r.req(stream=True), on_chunk, timeout_ms=5000)
    return {"chunks": got, "result": _json(res)}


async def s_crash_recovery(r: Run):
    w = await r.worker("w1", ["m1"], delay_s=0.4)
    await r.bus.flush()
    fut = asyncio.ensure_future(r.scheduler.submit_and_wait(r.req(), timeout_ms=8000))
    await asyncio.sleep(0.1)
    q1, q2 = r.req(), r.req()
    await r.scheduler.add_job(q1)
    await r.scheduler.add_job(q2)
    await r.scheduler.shutdown()
    await r.registry.shutdown()
    r.registry = r.m.sched.WorkerRegistry(r.bus, r.cfg)
    r.scheduler = r.m.sched.JobScheduler(r.bus, r.registry, r.cfg)
    await r.registry.initialize()
    await r.scheduler.initialize()
    recovered = r.registry.get_worker("w1") is not None
    await asyncio.sleep(2.0)
    fut.cancel()
    return {"recovered": recovered, "processed": sorted(w.processed)}


async def s_layout_tiebreak(r: Run):
    await r.worker("small", ["m1"], layouts=[r.layout(name="m1", maxSeqLen=512,
                                                      maxBatchSlots=4)])
    await r.worker("big", ["m1"], layouts=[r.layout(name="m1", strategy="tensor",
                                                    meshAxes={"tp": 8}, maxSeqLen=8192,
                                                    maxBatchSlots=16)])
    await r.bus.flush()
    a = await r.scheduler.submit_and_wait(r.req(options={"num_ctx": 4096}), timeout_ms=3000)
    b = await r.scheduler.submit_and_wait(r.req(), timeout_ms=3000)
    return {"picks": [a.workerId, b.workerId]}


async def s_busy_accounting(r: Run):
    await r.worker("w1", ["m1"], delay_s=0.5)
    await r.bus.flush()
    fut = asyncio.ensure_future(r.scheduler.submit_and_wait(r.req(), timeout_ms=5000))
    await asyncio.sleep(0.1)
    await r.bus.publish("worker:heartbeat", json.dumps(
        {"workerId": "w1", "status": "online", "currentJobs": 0}))
    await r.bus.flush()
    info = r.registry.get_worker("w1")
    out = {"currentJobs": info.currentJobs, "status": info.status,
           "available": len(r.registry.get_available_workers_by_model("m1"))}
    await fut
    return out


async def s_preemption(r: Run):
    w = await r.worker("w1", ["m1"], delay_s=0.4)
    await r.bus.flush()
    done = []

    async def submit(q):
        res = await r.scheduler.submit_and_wait(q, timeout_ms=8000)
        done.append((q.id, res.workerId, res.success))

    low = asyncio.ensure_future(submit(r.req(priority="low")))
    await asyncio.sleep(0.05)
    high = asyncio.ensure_future(submit(r.req(priority="high")))
    await asyncio.gather(low, high)
    return {"done": done, "preempted": list(w.preempted), "seen": list(w.seen)}


async def s_drain_handoff(r: Run):
    w1 = await r.worker("w1", ["m1"], max_concurrent=2, delay_s=0.3)
    await r.bus.flush()
    a, b = r.req(), r.req()
    futs = [asyncio.ensure_future(r.scheduler.submit_and_wait(q, timeout_ms=5000))
            for q in (a, b)]
    await asyncio.sleep(0.1)
    w2 = await r.worker("w2", ["m1"], max_concurrent=2, delay_s=0.05)
    await w1.announce_draining()
    await r.bus.flush()
    status = r.registry.get_worker("w1").status
    # one job moves to w2 with its pages, the other is requeued
    await w1.drain_job(a.id, to_worker="w2")
    await w1.drain_job(b.id)
    results = await asyncio.gather(*futs)
    return {"on_w1": list(w1.assignments), "status": status,
            "results": [_json(x) for x in results], "seen_w2": list(w2._extras().seen)}


async def s_deadline_shedding(r: Run):
    fut = asyncio.ensure_future(r.scheduler.submit_and_wait(r.req(model="nobody"),
                                                            timeout_ms=3000))
    res = await asyncio.wait_for(fut, 3)
    return {"result": _json(res)}


SCRIPTS = {
    "register_and_complete": (s_register_and_complete, {}),
    "least_loaded": (s_least_loaded, {}),
    "model_routing": (s_model_routing, {}),
    "priority_order": (s_priority_order, {}),
    "queued_until_owner": (s_queued_until_owner, {}),
    "retry_then_success": (s_retry_then_success, {}),
    "retries_exhausted": (s_retries_exhausted, {}),
    "non_retryable": (s_non_retryable, {}),
    "nack": (s_nack, {}),
    "orphan_on_death": (s_orphan_on_death, {}),
    "heartbeat_eviction": (s_heartbeat_eviction, {}),
    "unregister_and_reregister": (s_unregister_and_reregister, {}),
    "timeout_and_cancel": (s_timeout_and_cancel, {}),
    "cancel_during_retry": (s_cancel_during_retry, {"retry_delay_ms": 1_000}),
    "stream_chunks": (s_stream_chunks, {}),
    "crash_recovery": (s_crash_recovery, {}),
    "layout_tiebreak": (s_layout_tiebreak, {}),
    "busy_accounting": (s_busy_accounting, {}),
    "preemption": (s_preemption, {"preempt_after_ms": 100}),
    "drain_handoff": (s_drain_handoff, {}),
    "deadline_shedding": (s_deadline_shedding, {"request_deadline_ms": 200}),
}


async def _play(kind: str, script, cfg) -> dict:
    async with Run(kind, **cfg) as r:
        seen = await script(r)
        await r.bus.flush()
        return {"seen": seen, **r.record()}


@pytest.mark.parametrize("name", list(SCRIPTS))
async def test_port_scheduler_matches_jax(name, monkeypatch):
    script, cfg = SCRIPTS[name]
    # the retry ladder's full jitter: one stream of draws a side, the same
    # on both, so both ladders wait alike
    monkeypatch.setattr(jsched_mod, "random", random.Random(SEED))
    monkeypatch.setattr(tsched_mod, "random", random.Random(SEED))
    want, got = await asyncio.gather(_play("jax", script, cfg), _play("torch", script, cfg))
    assert got == want


# -- load_config ---------------------------------------------------------------

ENVS = {
    "defaults": {},
    "tuned": {"GRIDLLM_PREFIX_AFFINITY_WEIGHT": "0.5", "GRIDLLM_DISAGG": "0",
              "GRIDLLM_RETRY_BACKOFF_MAX_MS": "9000", "GRIDLLM_RETRY_BUDGET_PER_MIN": "7.5",
              "GRIDLLM_REQUEST_DEADLINE_MS": "1500", "GRIDLLM_BUS_REJOIN_GRACE_MS": "0",
              "GRIDLLM_REQUEST_DEADLINE_CLASSES": '{"interactive": 3000, "batch": 60000}',
              "GRIDLLM_PREEMPT_AFTER_MS": "250", "JOB_RETRY_ATTEMPTS": "5",
              "WORKER_HEARTBEAT_TIMEOUT": "900",
              "GRIDLLM_SLO_ENABLED": "0", "GRIDLLM_SLO_WINDOWS": "60,600",
              "GRIDLLM_SLO_CLASSES": '{"interactive": {"ttft_ms": 500, "itl_ms": 50, '
                                     '"target": 0.9, "note": "ignored"}}',
              "GRIDLLM_WATCHDOG_ENABLED": "off", "GRIDLLM_WATCHDOG_INTERVAL": "250",
              "GRIDLLM_WATCHDOG_DECODE_STALL": "5000", "GRIDLLM_WATCHDOG_REQUEUE": "no",
              "GRIDLLM_WATCHDOG_PROFILE_S": "1.5"},
    "bad_slo_target": {"GRIDLLM_SLO_CLASSES": '{"batch": {"target": 1.5}}'},
    "bad_retry_attempts": {"JOB_RETRY_ATTEMPTS": "-1"},
    "bad_watchdog_interval": {"GRIDLLM_WATCHDOG_INTERVAL": "0"},
    "bad_affinity": {"GRIDLLM_PREFIX_AFFINITY_WEIGHT": "-0.1"},
    "bad_bool": {"GRIDLLM_DISAGG": "maybe"},
    "bad_int": {"GRIDLLM_PREEMPT_AFTER_MS": "soon"},
}


def _sections(cfg) -> dict:
    def plain(x):
        if dataclasses.is_dataclass(x):
            x = dataclasses.asdict(x)
        elif hasattr(x, "model_dump"):
            x = x.model_dump()
        return x
    return {"scheduler": plain(cfg.scheduler), "slo": plain(cfg.obs.slo),
            "watchdog": plain(cfg.obs.watchdog)}


@pytest.mark.parametrize("env", list(ENVS))
def test_load_config_sections_match_jax(env, monkeypatch):
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    if env.startswith("bad_"):
        with pytest.raises(SystemExit):
            jconfig.load_config()
        with pytest.raises(SystemExit):
            tconfig.load_config()
        return
    want, got = _sections(jconfig.load_config()), _sections(tconfig.load_config())
    assert got == want
    assert list(got["scheduler"]) == list(jconfig.SchedulerConfig.model_fields)
