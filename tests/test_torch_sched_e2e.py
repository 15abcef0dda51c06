"""The port's scheduler driving torch workers end to end on the CPU.

- The port's `JobScheduler` on the port's `InMemoryBus` and the JAX
  package's on the JAX `InMemoryBus`, each driving the same torch
  `WorkerService` (tiny-llama, float32): the same greedy texts, eval counts
  and done reasons through `submit_and_wait` and `submit_streaming_job`
  (the gateway's generate, chat and streamed requests).
- A torch worker killed mid-decode (its bus goes silent, as a SIGKILL
  looks to the cluster): the port's registry evicts it, the port's
  scheduler orphans the job with its resume watermark and a second torch
  worker finishes it exactly once, byte-identical to the undisturbed run.
- A process in which `jax`, `jaxlib` and `gridllm_tpu` cannot be imported
  serves jobs through port scheduler → port bus → port worker → port
  engine.
- A mixed fleet over RESP: the port's scheduler and a torch worker on the
  port's RESP client, a JAX worker on the JAX RESP client, all against
  `gridllm_tpu.bus.broker.GridBusBroker`; the port's scheduler places jobs
  on both workers.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import uuid
from pathlib import Path

import pytest

import gridllm_torch.bus as tbus
import gridllm_torch.scheduler as tsched
import gridllm_torch.utils.config as tconfig
import gridllm_torch.utils.types as ttypes
import gridllm_tpu.bus as jbus
import gridllm_tpu.scheduler as jsched
import gridllm_tpu.utils.types as jtypes
from gridllm_torch.bus.resp import RespBus as TResp
from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.utils.config import WorkerConfig as TWorkerConfig
from gridllm_torch.worker.service import WorkerService as TWorker
from tests.helpers import fast_config

REPO = Path(__file__).resolve().parents[1]
MODEL = "tiny-llama"
TINY = dict(model=MODEL, max_slots=4, page_size=8, num_pages=128, max_pages_per_slot=16,
            prefill_buckets=(16, 64, 128), prefill_chunk=16, dtype="float32", seed=42)
LONG = "the quick brown fox jumps over the lazy dog " * 2   # > prefill_chunk
GREEDY = {"temperature": 0, "num_predict": 12}
N_PREDICT = 48      # long enough that a kill lands mid-decode
CHAOS_TOKENS = 4    # snapshot watermark reached before the kill


def t_sched_config(**kw) -> tconfig.SchedulerConfig:
    base = {f: getattr(fast_config(), f) for f in type(fast_config()).model_fields}
    base.update(kw)
    return tconfig.SchedulerConfig(**base)


@pytest.fixture(scope="module")
def engines():
    """Two torch engines on the same random weights (seed 0)."""
    return [TEngine(TConfig(**TINY), device="cpu") for _ in range(2)]


async def _until(cond, what, timeout=30.0):
    for _ in range(int(timeout / 0.01)):
        if cond():
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"{what} never happened")


async def _idle(engine):
    await _until(lambda: not engine.active_requests and not engine.queued_requests,
                 "engine idle")


def _requests(types):
    """The gateway's generate, chat and streamed requests, as InferenceRequests."""
    chat = [{"role": "user", "content": "hi, how are you?"}]
    return [
        ("generate", types.InferenceRequest(
            id=f"g-{uuid.uuid4().hex[:8]}", model=MODEL, prompt="hello there", stream=False,
            options=dict(GREEDY), metadata={"requestType": "inference"})),
        ("long", types.InferenceRequest(
            id=f"l-{uuid.uuid4().hex[:8]}", model=MODEL, prompt=LONG, stream=False,
            options=dict(GREEDY), metadata={"requestType": "inference"})),
        ("chat", types.InferenceRequest(
            id=f"c-{uuid.uuid4().hex[:8]}", model=MODEL, messages=chat, stream=False,
            options=dict(GREEDY), metadata={"requestType": "chat"})),
        ("generate_stream", types.InferenceRequest(
            id=f"gs-{uuid.uuid4().hex[:8]}", model=MODEL, prompt="stream me", stream=True,
            options=dict(GREEDY), metadata={"requestType": "inference"})),
        ("chat_stream", types.InferenceRequest(
            id=f"cs-{uuid.uuid4().hex[:8]}", model=MODEL, stream=True,
            messages=[{"role": "user", "content": "stream a chat"}],
            options=dict(GREEDY), metadata={"requestType": "chat"})),
    ]


async def _serve(kind, engine):
    """generate, long and chat through submit_and_wait, the streams through
    submit_streaming_job: (text, eval_count, done_reason) per request."""
    bus_mod, sched_mod, types = ((tbus, tsched, ttypes) if kind == "torch"
                                 else (jbus, jsched, jtypes))
    cfg = t_sched_config() if kind == "torch" else fast_config()
    bus = bus_mod.InMemoryBus()
    await bus.connect()
    registry = sched_mod.WorkerRegistry(bus, cfg)
    scheduler = sched_mod.JobScheduler(bus, registry, cfg)
    await registry.initialize()
    await scheduler.initialize()
    worker = TWorker(bus, {MODEL: engine}, TWorkerConfig(
        worker_id=f"{kind}-w", heartbeat_interval_ms=150, resource_monitor_interval_ms=500),
        stream_flush_ms=5)
    await worker.start()
    await _until(lambda: registry.get_worker(f"{kind}-w") is not None, "registration")
    out = {}
    try:
        for name, req in _requests(types):
            if req.stream:
                chunks = []

                async def on_chunk(c, chunks=chunks):
                    chunks.append(c.response or (c.message or {}).get("content", ""))

                res = await scheduler.submit_streaming_job(req, on_chunk, timeout_ms=60_000)
                assert "".join(chunks)
            else:
                res = await scheduler.submit_and_wait(req, timeout_ms=60_000)
            assert res.success, res.error
            r = res.response
            text = r.response if r.response is not None else (r.message or {}).get("content")
            out[name] = (text, r.eval_count, r.done_reason)
        out["stats"] = {k: v for k, v in scheduler.get_stats().items() if k != "shard"}
    finally:
        await _idle(engine)
        await worker.stop(announce=False)
        await scheduler.shutdown()
        await registry.shutdown()
        await bus.disconnect()
    return out


async def test_port_scheduler_serves_a_torch_worker_like_the_jax_scheduler(engines):
    want = await _serve("jax", engines[0])
    got = await _serve("torch", engines[0])
    assert got == want
    assert got["generate"][1] == GREEDY["num_predict"]
    assert got["stats"]["totalJobsCompleted"] == 5


class PartitionableBus:
    """Per-worker facade over the port's in-memory bus (tests/
    test_fault_tolerance.py's): with `dead` set every outbound publish,
    hset and heartbeat-key refresh vanishes, as a SIGKILLed worker looks
    to the cluster, while its tasks and engine thread run on."""

    def __init__(self, inner):
        self._inner = inner
        self.dead = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def publish(self, channel, message):
        return 0 if self.dead else await self._inner.publish(channel, message)

    async def hset(self, key, field, value):
        if not self.dead:
            return await self._inner.hset(key, field, value)

    async def set_with_expiry(self, key, value, ttl_s):
        if not self.dead:
            return await self._inner.set_with_expiry(key, value, ttl_s)


async def _kill_run(engines, kill: bool):
    cfg = t_sched_config(job_timeout_ms=180_000, retry_attempts=3)
    bus = tbus.InMemoryBus()
    await bus.connect()
    registry = tsched.WorkerRegistry(bus, cfg)
    scheduler = tsched.JobScheduler(bus, registry, cfg)
    await registry.initialize()
    await scheduler.initialize()
    workers = []

    async def add(engine, wid):
        svc = TWorker(PartitionableBus(bus), {MODEL: engine},
                      TWorkerConfig(worker_id=wid, heartbeat_interval_ms=150), stream_flush_ms=5)
        svc._snap_every = 2
        await svc.start()
        workers.append((svc, engine))
        await _until(lambda: registry.get_worker(wid) is not None, f"{wid} registered")
        return svc

    try:
        victim = await add(engines[0], "victim")
        chunks = []

        async def on_chunk(c):
            chunks.append(c.response)

        req = ttypes.InferenceRequest(
            id=f"kill-{uuid.uuid4().hex[:8]}", model=MODEL, prompt=LONG, stream=True,
            options={"temperature": 0, "num_predict": N_PREDICT},
            metadata={"requestType": "inference"})
        task = asyncio.create_task(scheduler.submit_streaming_job(req, on_chunk,
                                                                  timeout_ms=120_000))
        if kill:
            await _until(lambda: len((scheduler._resume_snap.get(req.id) or {"tokens": []})
                                     ["tokens"]) >= CHAOS_TOKENS, "decode progress", 90.0)
            # the survivor joins now, so the job could only start on the victim
            await add(engines[1], "survivor")
            victim.bus.dead = True
        res = await task
        assert res.success, res.error
        text = "".join(chunks)
        assert text == res.response.response
        return {"text": text, "evals": res.response.eval_count, "by": res.workerId,
                "orphaned": scheduler._jobs_total.value(event="orphaned"),
                "stamped": scheduler._resume_total.value(event="stamped"),
                "completed": scheduler.total_completed,
                "evicted": registry.get_worker("victim") is None,
                "active_traces": scheduler.tracer.active_count()}
    finally:
        for svc, engine in workers:
            await _idle(engine)
            await svc.stop(announce=False)
        await scheduler.shutdown()
        await registry.shutdown()
        await bus.disconnect()


async def test_kill_mid_decode_resumes_exactly_once(engines):
    ref = await _kill_run(engines, kill=False)
    got = await _kill_run(engines, kill=True)
    assert (got["text"], got["evals"]) == (ref["text"], ref["evals"])
    assert got["by"] == "survivor" and got["evicted"]
    assert got["orphaned"] >= 1 and got["stamped"] >= 1
    assert got["completed"] == 1 and got["active_traces"] == 0


_NO_JAX = """
import asyncio, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "gridllm_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
from gridllm_torch.bus import InMemoryBus
from gridllm_torch.engine import EngineConfig, InferenceEngine
from gridllm_torch.scheduler import JobScheduler, WorkerRegistry
from gridllm_torch.utils.config import SchedulerConfig, WorkerConfig
from gridllm_torch.utils.types import InferenceRequest
from gridllm_torch.worker.service import WorkerService

async def main():
    cfg = SchedulerConfig(worker_heartbeat_timeout_ms=600, worker_cleanup_interval_ms=100,
                          sweep_interval_ms=100)
    bus = InMemoryBus()
    await bus.connect()
    registry = WorkerRegistry(bus, cfg)
    scheduler = JobScheduler(bus, registry, cfg)
    await registry.initialize()
    await scheduler.initialize()
    engine = InferenceEngine(EngineConfig(model="tiny-llama", max_slots=2, page_size=8,
                                          num_pages=64, max_pages_per_slot=16,
                                          prefill_buckets=(16, 64), dtype="float32"),
                             device="cpu")
    worker = WorkerService(bus, {"tiny-llama": engine},
                           WorkerConfig(worker_id="w", heartbeat_interval_ms=150))
    await worker.start()
    while registry.get_worker("w") is None:
        await asyncio.sleep(0.01)
    results = await asyncio.gather(*[scheduler.submit_and_wait(InferenceRequest(
        id=f"j{i}", model="tiny-llama", prompt=f"job {i}",
        options={"temperature": 0, "num_predict": 4},
        metadata={"requestType": "inference"}), timeout_ms=60000) for i in range(3)])
    assert all(r.success and r.response.eval_count == 4 for r in results), results
    while engine.active_requests or engine.queued_requests:
        await asyncio.sleep(0.01)
    await worker.stop(announce=False)
    await scheduler.shutdown()
    await registry.shutdown()
    await bus.disconnect()
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("SERVED", len(results), scheduler.total_completed)

asyncio.run(main())
"""


def test_serves_in_a_process_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SERVED 3 3" in proc.stdout


async def test_mixed_fleet_over_resp(engines):
    from gridllm_tpu.bus.broker import GridBusBroker
    from gridllm_tpu.bus.resp import RespBus as JResp
    from gridllm_tpu.engine import EngineConfig as JConfig
    from gridllm_tpu.engine import InferenceEngine as JEngine
    from gridllm_tpu.utils.config import WorkerConfig as JWorkerConfig
    from gridllm_tpu.worker.service import WorkerService as JWorker

    broker = GridBusBroker()
    await broker.start("127.0.0.1", 0)
    sbus = TResp(host="127.0.0.1", port=broker.port)
    tw_bus = TResp(host="127.0.0.1", port=broker.port)
    jw_bus = JResp(host="127.0.0.1", port=broker.port)
    je = JEngine(JConfig(**{**TINY, "max_slots": 2}))
    for b in (sbus, tw_bus, jw_bus):
        await b.connect()
    # the JAX engine's first compiles hold its worker's loop for seconds:
    # liveness at the defaults, so that is not read as a death
    cfg = tconfig.SchedulerConfig(sweep_interval_ms=100)
    registry = tsched.WorkerRegistry(sbus, cfg)
    scheduler = tsched.JobScheduler(sbus, registry, cfg)
    await registry.initialize()
    await scheduler.initialize()
    tw = TWorker(tw_bus, {MODEL: engines[1]}, TWorkerConfig(
        worker_id="torch-w", heartbeat_interval_ms=150), stream_flush_ms=5)
    jw = JWorker(jw_bus, {MODEL: je}, JWorkerConfig(
        worker_id="jax-w", heartbeat_interval_ms=150), stream_flush_ms=5)
    try:
        await tw.start()
        await jw.start()
        await _until(lambda: {w.workerId for w in registry.get_all_workers()}
                     == {"torch-w", "jax-w"}, "both workers registered")
        reqs = [ttypes.InferenceRequest(
            id=f"mix-{i}", model=MODEL, prompt=f"mixed fleet {i}",
            options={"temperature": 0, "num_predict": 4},
            metadata={"requestType": "inference"}) for i in range(6)]
        results = await asyncio.gather(*[scheduler.submit_and_wait(r, timeout_ms=90_000)
                                         for r in reqs])
        assert all(r.success and r.response.eval_count == 4 for r in results), results
        assert {r.workerId for r in results} == {"torch-w", "jax-w"}
    finally:
        await _idle(engines[1])
        await _idle(je)
        await tw.stop(announce=False)
        await jw.stop(announce=False)
        await scheduler.shutdown()
        await registry.shutdown()
        for b in (sbus, tw_bus, jw_bus):
            await b.disconnect()
        await broker.stop()
