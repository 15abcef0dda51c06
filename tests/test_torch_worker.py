"""The port's WorkerService behind the JAX package's gateway and scheduler.

The JAX gateway, `WorkerRegistry` and `JobScheduler` drive a torch worker
(`gridllm_torch.worker.WorkerService` on the port's engine, tiny-llama at
float32 on the CPU) over one JAX `InMemoryBus`, wired as tests/test_e2e.py
wires a JAX worker. Both packages' engines serve the same weights (the
JAX engine's parameters carried across as numpy), with both packages'
defaults: n-gram speculation, ragged attention and the prefix cache on.

- generate, chat and streams through the gateway equal a JAX worker's;
- an assignment over capacity is NACKed and a cancel mid-stream resolves;
- images and embeddings fail loudly, naming the slice that ports them; a
  disaggregated prefill with no decode peer falls back to local serving;
- a fleet of one JAX and one torch worker serves greedy requests with
  either worker's text;
- a worker killed mid-decode (its bus goes silent, as a SIGKILL looks to
  the cluster) is resumed exactly once from its last snapshot, torch →
  JAX, JAX → torch and from a torch tree-speculation engine: the client's
  stream is byte-identical to the undisturbed run, with the same
  eval_count (greedy; the seeded sampled resume across the two packages
  is held in tests/test_torch_sampling_rng.py).
"""

import asyncio
import json
import uuid

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.utils.config import WorkerConfig as TWorkerConfig
from gridllm_torch.worker import service as tservice
from gridllm_torch.worker.service import WorkerService as TWorker
from gridllm_tpu.bus.base import CH_JOB_COMPLETED, CH_JOB_HANDOFF, worker_job_channel
from gridllm_tpu.bus.memory import InMemoryBus
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.gateway.app import create_app
from gridllm_tpu.scheduler import JobScheduler, WorkerRegistry
from gridllm_tpu.utils.config import Config
from gridllm_tpu.utils.config import WorkerConfig as JWorkerConfig
from gridllm_tpu.utils.types import InferenceRequest, JobAssignment
from gridllm_tpu.worker.service import WorkerService as JWorker
from tests.helpers import fast_config
from tests.test_fault_tolerance import PartitionableBus, ft_config

MODEL = "tiny-llama"
TINY = dict(model=MODEL, max_slots=4, page_size=8, num_pages=128, max_pages_per_slot=16,
            prefill_buckets=(16, 64, 128), prefill_chunk=16, dtype="float32", seed=42)
LONG = "the quick brown fox jumps over the lazy dog " * 2   # > prefill_chunk
GREEDY = {"temperature": 0, "num_predict": 12}
N_PREDICT = 48      # long enough that a kill lands mid-decode
CHAOS_TOKENS = 4    # snapshot watermark reached before the kill


@pytest.fixture(scope="module")
def engines():
    """A JAX engine, a torch engine on its weights, and a torch engine with
    draft-model tree speculation (its draft on weights of its own)."""
    je = JEngine(JConfig(**TINY))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = TEngine(TConfig(**TINY), device="cpu", params=params)
    tree = TEngine(TConfig(draft_model=MODEL, **TINY), device="cpu", params=params)
    return {"jax": je, "torch": te, "torch-tree": tree}


def _worker(kind, engine, bus, wid, **cfg):
    cls, wcfg = (JWorker, JWorkerConfig) if kind == "jax" else (TWorker, TWorkerConfig)
    return cls(bus, {MODEL: engine}, wcfg(worker_id=wid, **cfg), stream_flush_ms=5)


async def _settle(engine, timeout=30.0):
    """Wait until a worker's engine holds no request (a killed worker's
    engine finishes the job it had) before its engine serves elsewhere."""
    for _ in range(int(timeout / 0.01)):
        if not engine.active_requests and not engine.queued_requests:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("engine never went idle")


class Stack:
    """Gateway + registry + scheduler on one JAX InMemoryBus, with one
    worker (test_e2e.py's `_stack`)."""

    def __init__(self, kind, engine, sched_cfg=None):
        self.kind, self.engine = kind, engine
        self.sched_cfg = sched_cfg or fast_config()

    async def __aenter__(self):
        self.bus = InMemoryBus()
        await self.bus.connect()
        self.registry = WorkerRegistry(self.bus, self.sched_cfg)
        self.scheduler = JobScheduler(self.bus, self.registry, self.sched_cfg)
        await self.registry.initialize()
        await self.scheduler.initialize()
        config = Config()
        config.scheduler = self.sched_cfg
        self.worker = _worker(self.kind, self.engine, self.bus, f"{self.kind}-w",
                              heartbeat_interval_ms=150, resource_monitor_interval_ms=500)
        await self.worker.start()
        await asyncio.sleep(0.05)
        self.client = TestClient(TestServer(create_app(self.bus, self.registry,
                                                       self.scheduler, config)))
        await self.client.start_server()
        return self

    async def __aexit__(self, *exc):
        await self.client.close()
        await self.worker.stop()
        await self.scheduler.shutdown()
        await self.registry.shutdown()
        await self.bus.disconnect()

    async def post(self, path, body):
        resp = await self.client.post(path, json=body)
        return resp.status, await resp.text()


async def _serve_api(stack):
    """Generate, chat and their streams through the gateway: the texts and
    eval counts a client sees."""
    out = {}
    for name, path, body in (
        ("generate", "/ollama/api/generate",
         {"model": MODEL, "prompt": "hello there", "stream": False, "options": GREEDY}),
        ("long", "/ollama/api/generate",
         {"model": MODEL, "prompt": LONG, "stream": False, "options": GREEDY}),
        ("chat", "/ollama/api/chat",
         {"model": MODEL, "stream": False, "options": GREEDY,
          "messages": [{"role": "user", "content": "hi, how are you?"}]}),
    ):
        status, text = await stack.post(path, body)
        assert status == 200, text
        body_out = json.loads(text)
        msg = body_out.get("message") or {}
        out[name] = (body_out.get("response") or msg.get("content"), body_out["eval_count"],
                     body_out["done_reason"])
    for name, path, body, key in (
        ("generate_stream", "/ollama/api/generate",
         {"model": MODEL, "prompt": "stream me", "options": GREEDY}, "response"),
        ("chat_stream", "/ollama/api/chat",
         {"model": MODEL, "options": GREEDY,
          "messages": [{"role": "user", "content": "stream a chat"}]}, "message"),
    ):
        status, text = await stack.post(path, body)
        assert status == 200, text
        lines = [json.loads(line) for line in text.strip().splitlines()]
        assert lines[-1]["done"] is True
        parts = [(ln.get(key) or "") if key == "response" else (ln.get(key) or {}).get("content", "")
                 for ln in lines[:-1]]
        out[name] = ("".join(parts), lines[-1]["eval_count"], lines[-1]["done_reason"])
    status, text = await stack.post("/v1/chat/completions", {
        "model": MODEL, "stream": False, "max_tokens": 6, "temperature": 0,
        "messages": [{"role": "user", "content": "openai facade"}]})
    assert status == 200, text
    body_out = json.loads(text)
    out["openai"] = (body_out["choices"][0]["message"]["content"],
                     body_out["usage"]["completion_tokens"], None)
    return out


async def test_gateway_serves_generate_chat_and_streams_like_a_jax_worker(engines):
    async with Stack("torch", engines["torch"]) as st:
        (info,) = st.registry.get_all_workers()
        assert info.capabilities.topology.platform == "cpu"
        assert info.capabilities.maxConcurrentTasks == TINY["max_slots"]
        t_hash = info.capabilities.availableModels[0].details["engineConfigHash"]
        got = await _serve_api(st)
        assert st.worker.total_processed == len(got)
    async with Stack("jax", engines["jax"]) as st:
        (info,) = st.registry.get_all_workers()
        j_hash = info.capabilities.availableModels[0].details["engineConfigHash"]
        want = await _serve_api(st)
    assert got == want
    assert got["generate"][1] == GREEDY["num_predict"]
    assert got["generate_stream"][0] and got["chat_stream"][0]
    # torch workers seal canary goldens of their own
    assert t_hash != j_hash


async def test_nack_over_capacity_and_cancel_mid_stream(engines):
    async with Stack("torch", engines["torch"]) as st:
        nacked = tservice._JOBS_TOTAL.value(event="nacked")
        st.worker.max_concurrent = 0       # every assignment is over capacity
        status, _ = await st.post("/ollama/api/generate", {
            "model": MODEL, "prompt": "x", "stream": False,
            "options": {"temperature": 0, "num_predict": 2}})
        assert status >= 500               # requeued, then failed by the scheduler
        assert tservice._JOBS_TOTAL.value(event="nacked") > nacked
        assert st.scheduler._jobs_total.value(event="nacked") >= 1
        st.worker.max_concurrent = TINY["max_slots"]

        cancelled = tservice._JOBS_TOTAL.value(event="cancelled")
        async with st.client.post("/ollama/api/generate", json={
            "model": MODEL, "prompt": "cancel me",
            "options": {"temperature": 0, "num_predict": 100}}) as resp:
            await resp.content.readline()
            (job,) = st.scheduler.get_active_jobs()
            cancel = await st.client.delete(f"/inference/{job.jobId}")
            assert cancel.status == 200
        for _ in range(500):
            if tservice._JOBS_TOTAL.value(event="cancelled") > cancelled:
                break
            await asyncio.sleep(0.01)
        assert tservice._JOBS_TOTAL.value(event="cancelled") > cancelled
        assert st.scheduler.get_active_jobs() == []
        await _settle(engines["torch"])


async def test_unported_requests_fail_loudly(engines):
    """Images and embeddings (ROADMAP A 8): a non-retryable failure that
    names the slice, never a request served some other way. The
    disaggregated prefill phase and the prefill/decode roles are served
    since KV transfer was ported: a disaggregated job whose planned decode
    worker is this worker itself hands off nothing (ok=False,
    "unsupported") and is served here, and a worker takes either role."""
    async with Stack("torch", engines["torch"]) as st:
        for path, body in (
            ("/ollama/api/generate", {"model": MODEL, "prompt": "what is this?",
                                      "stream": False, "images": ["aGVsbG8="]}),
            ("/ollama/api/chat", {"model": MODEL, "stream": False, "messages": [
                {"role": "user", "content": "describe", "images": ["aGVsbG8="]}]}),
            ("/ollama/api/embed", {"model": MODEL, "input": ["alpha", "beta"]}),
        ):
            status, text = await st.post(path, body)
            assert status >= 400 and "ROADMAP A 8" in text, text
        assert st.scheduler._jobs_total.value(event="retried") == 0

        seen = {CH_JOB_COMPLETED: [], CH_JOB_HANDOFF: []}

        async def on_msg(ch, raw):
            seen[ch].append(json.loads(raw))

        for ch in seen:
            await st.bus.subscribe(ch, on_msg)
        wid = st.worker.worker_id
        req = InferenceRequest(id="disagg-1", model=MODEL, prompt="hi",
                               options=dict(GREEDY),
                               metadata={"disagg": {"decodeWorkerId": wid}})
        assignment = JobAssignment(jobId=req.id, workerId=wid, request=req)
        await st.bus.publish(worker_job_channel(wid), json.dumps(
            {"type": "job_assignment", "job": json.loads(assignment.model_dump_json())}))
        for _ in range(3000):
            if seen[CH_JOB_COMPLETED]:
                break
            await asyncio.sleep(0.01)
        (handoff,) = seen[CH_JOB_HANDOFF]
        assert handoff["jobId"] == "disagg-1" and not handoff["ok"]
        assert handoff["reason"] == "unsupported"
        (done,) = seen[CH_JOB_COMPLETED]
        assert done["jobId"] == "disagg-1" and done["success"] and done["workerId"] == wid
        # the worker still serves
        status, _ = await st.post("/ollama/api/generate", {
            "model": MODEL, "prompt": "still here", "stream": False, "options": GREEDY})
        assert status == 200
    for role in ("prefill", "decode"):
        assert TWorker(InMemoryBus(), {MODEL: engines["torch"]},
                       TWorkerConfig(role=role)).role == role


async def test_mixed_fleet_of_a_jax_and_a_torch_worker(engines):
    """One JAX and one torch worker on one bus: the scheduler spreads
    concurrent jobs over both, and every text is the same whichever worker
    served it."""
    cfg = fast_config()
    bus = InMemoryBus()
    await bus.connect()
    registry = WorkerRegistry(bus, cfg)
    scheduler = JobScheduler(bus, registry, cfg)
    await registry.initialize()
    await scheduler.initialize()
    workers = [_worker(kind, engines[kind], bus, f"mixed-{kind}", heartbeat_interval_ms=150)
               for kind in ("jax", "torch")]
    try:
        for w in workers:
            await w.start()
        await asyncio.sleep(0.1)
        assert len(registry.get_all_workers()) == 2
        prompts = ["alpha beta", "gamma", LONG, "delta epsilon zeta"]

        async def one(prompt, tag):
            return await scheduler.submit_and_wait(InferenceRequest(
                id=f"{tag}-{uuid.uuid4().hex[:6]}", model=MODEL, prompt=prompt,
                stream=False, options=dict(GREEDY)), timeout_ms=60_000)

        results = await asyncio.gather(*[one(p, f"m{i}") for i in range(3)
                                         for p in prompts])
        assert all(r.success for r in results), [r.error for r in results]
        served = {r.workerId for r in results}
        assert served == {w.worker_id for w in workers}
        by_prompt: dict[str, set] = {}
        for k, r in enumerate(results):
            by_prompt.setdefault(prompts[k % len(prompts)], set()).add(
                (r.response.response, r.response.eval_count))
        assert all(len(v) == 1 for v in by_prompt.values()), by_prompt
    finally:
        for w in workers:
            await w.stop(announce=False)
        await scheduler.shutdown()
        await registry.shutdown()
        await bus.disconnect()


class KillFleet:
    """Scheduler on one bus; workers behind PartitionableBus facades so one
    can be silenced mid-decode (tests/test_fault_tolerance.py's Fleet)."""

    async def __aenter__(self):
        self.cfg = ft_config()
        self.bus = InMemoryBus()
        await self.bus.connect()
        self.registry = WorkerRegistry(self.bus, self.cfg)
        self.scheduler = JobScheduler(self.bus, self.registry, self.cfg)
        await self.registry.initialize()
        await self.scheduler.initialize()
        self.workers = []
        return self

    async def add(self, kind, engine, wid):
        svc = _worker(kind, engine, PartitionableBus(self.bus), wid, heartbeat_interval_ms=150)
        svc._snap_every = 2
        await svc.start()
        self.workers.append((svc, engine))
        for _ in range(500):
            if any(w.workerId == wid for w in self.registry.get_all_workers()):
                return svc
            await asyncio.sleep(0.01)
        raise AssertionError(f"{wid} never registered")

    async def __aexit__(self, *exc):
        for svc, engine in self.workers:
            await _settle(engine)
            await svc.stop(announce=False)
        await self.scheduler.shutdown()
        await self.registry.shutdown()
        await self.bus.disconnect()

    async def run(self, chaos=None):
        """One streaming greedy request; `chaos(job_id)` fires once the
        job's snapshot watermark shows decode progress."""
        chunks = []

        async def on_chunk(c):
            chunks.append(c.response)

        req = InferenceRequest(
            id=f"kill-{uuid.uuid4().hex[:8]}", model=MODEL, prompt=LONG, stream=True,
            options={"temperature": 0, "num_predict": N_PREDICT},
            metadata={"requestType": "inference"})
        task = asyncio.create_task(self.scheduler.submit_streaming_job(
            req, on_chunk, timeout_ms=120_000))
        if chaos is not None:
            for _ in range(9000):
                snap = self.scheduler._resume_snap.get(req.id)
                if snap is not None and len(snap["tokens"]) >= CHAOS_TOKENS:
                    break
                await asyncio.sleep(0.01)
            else:
                raise AssertionError("decode never reached the chaos point")
            await chaos(req.id)
        result = await task
        text = "".join(chunks)
        assert result.success, result.error
        assert text == result.response.response
        self.served_by = result.workerId
        return text, int(result.response.eval_count)


@pytest.fixture(scope="module")
def undisturbed(engines):
    """The undisturbed greedy run every resumed stream must equal."""
    async def run():
        async with KillFleet() as f:
            await f.add("jax", engines["jax"], "ref-w")
            return await f.run()
    return asyncio.run(run())


@pytest.mark.parametrize("victim,survivor", [
    ("torch", "jax"), ("jax", "torch"), ("torch-tree", "jax")])
async def test_kill_mid_decode_resumes_exactly_once(engines, undisturbed, victim, survivor):
    text_ref, evals_ref = undisturbed
    async with KillFleet() as f:
        dead = await f.add("torch" if victim != "jax" else "jax", engines[victim], "victim")

        async def kill(job_id):
            # the survivor joins now, so the job could only start on the victim
            await f.add(survivor, engines[survivor], "survivor")
            dead.bus.dead = True

        text, evals = await f.run(chaos=kill)
        assert (text, evals) == (text_ref, evals_ref)
        assert f.served_by == "survivor"
        assert f.scheduler._jobs_total.value(event="orphaned") >= 1
        assert int(f.scheduler._resume_total.value(event="stamped")) >= 1
        assert f.scheduler.tracer.active_count() == 0


async def test_drain_mid_decode_hands_off_by_resume(engines, undisturbed):
    """A graceful drain of a torch worker mid-decode: the engine suspends
    the generation, the worker publishes job:drain with its snapshot (and
    live-migrates its pages to the peer, tests/test_torch_kv_migration.py),
    and the scheduler resumes the job on a JAX worker: the stream is
    byte-identical to the undisturbed run."""
    text_ref, evals_ref = undisturbed
    async with KillFleet() as f:
        victim = await f.add("torch", engines["torch"], "victim")

        async def drain(job_id):
            await f.add("jax", engines["jax"], "survivor")
            report = await victim.drain(budget_ms=0)
            assert report["suspended"] == 1 and report["remaining"] == 0

        text, evals = await f.run(chaos=drain)
        assert (text, evals) == (text_ref, evals_ref)
        assert f.served_by == "survivor"
        assert tservice._JOBS_TOTAL.value(event="drained") >= 1


async def test_worker_process_refusals_and_health_port(engines, tmp_path, monkeypatch):
    """`python -m gridllm_torch.worker`'s pieces: the environment the JAX
    worker reads, the refusals that name their slice (and an empty
    checkpoint directory that fails its load), and the health port
    (health, metrics, dump, memory, drain validation and an on-demand
    profile through InferenceEngine.profile())."""
    from aiohttp import ClientSession

    from gridllm_torch.utils.config import load_config
    from gridllm_torch.worker import main as wmain

    monkeypatch.setenv("GRIDLLM_MODELS", "tiny-llama")
    monkeypatch.setenv("WORKER_ID", "torch-proc")
    monkeypatch.setenv("GRIDLLM_KV_PAGE_SIZE", "8")
    cfg = load_config()
    assert (cfg.worker.worker_id, cfg.engine.models, cfg.engine.kv_page_size) == \
        ("torch-proc", "tiny-llama", 8)
    wmain.check_single_device(cfg)
    for key, value in (("GRIDLLM_MESH_SHAPE", "tp:2"), ("GRIDLLM_NUM_PROCS", "2")):
        with monkeypatch.context() as mp:
            mp.setenv(key, value)
            with pytest.raises(SystemExit, match="ROADMAP A 9"):
                wmain.check_single_device(load_config())
    # a checkpoint directory that resolves is served from, never replaced by
    # random weights: an empty one fails the load (served checkpoints are
    # in tests/test_torch_worker_checkpoint.py)
    (tmp_path / "tiny-llama").mkdir()
    cfg.engine.checkpoint_dir = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="safetensors"):
        wmain.build_one_engine(cfg, MODEL, device="cpu")
    monkeypatch.delenv("GRIDLLM_ALLOW_SYNTHETIC_WEIGHTS", raising=False)
    with pytest.raises(ValueError, match="random weights"):
        wmain.pull_engine_factory(cfg)("other-model")

    bus = InMemoryBus()
    await bus.connect()
    svc = _worker("torch", engines["torch"], bus, "torch-health")
    await svc.start()
    runner = await wmain.start_health_port(svc, "127.0.0.1", 0)
    port = runner.addresses[0][1]
    try:
        async with ClientSession() as http:
            url = f"http://127.0.0.1:{port}"
            async with http.get(f"{url}/health") as r:
                assert (await r.json())["worker"] == "torch-health"
            async with http.get(f"{url}/metrics") as r:
                assert "gridllm_worker_jobs_total" in await r.text()
            async with http.get(f"{url}/admin/dump") as r:
                assert (await r.json())["worker"]["models"] == [MODEL]
            async with http.get(f"{url}/admin/memory") as r:
                assert (await r.json())["models"][MODEL]["weightsBytes"] > 0
            async with http.post(f"{url}/admin/profile?seconds=zero") as r:
                assert r.status == 400
            async with http.post(f"{url}/admin/profile?seconds=0.2") as r:
                body = await r.json()
                assert r.status == 200 and body["model"] == MODEL
            async with http.post(f"{url}/admin/drain?budget_ms=x") as r:
                assert r.status == 400
    finally:
        await runner.cleanup()
        await svc.stop(announce=False)
        await bus.disconnect()
