"""KV migration between JAX and torch engines and workers.

Tiny-llama at float32 on the CPU, the torch engines on the JAX engines'
weights, the workers behind the JAX package's scheduler on one JAX
`InMemoryBus` (tests/test_torch_worker.py's `_worker`):

- export → import JAX → torch → JAX on fp and int8 pools: the wire's pages
  land bit-exact in an fp pool, an int8 pool holds the bytes the JAX
  package's requantization gives, and the importer's warm stream equals
  the exporter's unified one;
- disaggregated serving, prefill on a JAX worker and decode on a torch one
  and the reverse, over bus chunks and over HTTP to the torch worker's
  `/kvx/` route: the client's stream equals unified serving, the decode
  worker imported the pages and served the job (the JAX package's
  tests/test_disagg.py differential);
- a failed import NACKs the transfer and the prefill worker serves the
  request itself, with the same stream;
- a torch worker's graceful drain mid-decode live-migrates the decode's
  pages to a JAX peer, and the stream is the undisturbed one, exactly once
  (the JAX package's tests/test_fault_tolerance.py drain).
"""

import asyncio
import json
import uuid

import jax
import numpy as np
import pytest

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.ops import kvtier as TT
from gridllm_torch.transfer import wire as TW
from gridllm_torch.worker.main import start_health_port
from gridllm_tpu.bus.base import CH_JOB_DRAIN, CH_JOB_HANDOFF
from gridllm_tpu.bus.memory import InMemoryBus
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.ops import kvtier as JT
from gridllm_tpu.scheduler import JobScheduler, WorkerRegistry
from gridllm_tpu.transfer import wire as JW
from gridllm_tpu.utils.config import SchedulerConfig
from gridllm_tpu.utils.types import InferenceRequest
from tests.test_torch_worker import MODEL, TINY, _settle, _worker

GREEDY = {"temperature": 0, "num_predict": 16}
PROMPTS = {
    "jax-torch-bus": "the quick brown fox jumps over the lazy dog " * 2,
    "torch-jax-bus": "pack my box with five dozen liquor jugs, then " * 2,
    "jax-torch-http": "jackdaws love my big sphinx of quartz, they say " * 2,
    "fallback": "sphinx of black quartz, judge my vow and go home " * 2,
    "drain": "how vexingly quick daft zebras jump over the fence " * 2,
}


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a torch engine on its weights, for fp and int8 pools."""
    out = {}
    for pool, extra in (("fp", {}), ("int8", {"kv_int8": True})):
        je = JEngine(JConfig(**TINY, **extra))
        params = jax.tree_util.tree_map(np.asarray, je.params)
        out[pool] = (je, TEngine(TConfig(**TINY, **extra), device="cpu", params=params))
    return out


def _evict(engine, token_ids):
    """Drop the cached pages of `token_ids` from an engine's prefix cache,
    so a later import installs them afresh."""
    with engine._alloc_lock:
        pages, _ = engine.alloc.pin_prefix(token_ids)
        engine.alloc.unpin_pages(pages)
        engine.alloc.evict_cached(pages)


def _pool_pages(engine, token_ids):
    """The pool bytes (values, and scales on an int8 pool) of the cached
    pages of `token_ids`, as numpy."""
    with engine._alloc_lock:
        pages, _ = engine.alloc.pin_prefix(token_ids)
        engine.alloc.unpin_pages(pages)
    idx = np.asarray(pages)
    out = []
    for pool in (engine.cache.k, engine.cache.v):
        parts = (pool.data, pool.scale) if hasattr(pool, "scale") else (pool,)
        out += [np.asarray(p)[:, idx] for p in parts]
    return out


@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_export_import_round_trip_jax_torch_jax(engines, pool):
    je, te = engines[pool]
    prompt = "round trip of the paged kv state " * 3 + pool
    unified = je.generate(JRequest(id="u", prompt=prompt, options=dict(GREEDY)))
    ctx = unified.context[:len(unified.context) - len(unified.token_ids)]
    # JAX → torch: the JAX package's header and chunk frames into the port
    jx = je.export_prefix_pages(ctx[:-1])
    jh, jp = JW.build_header("rt", MODEL, jx["tokens"], jx["k"], jx["v"],
                             kv_layout=jx["kvLayout"], chunk_bytes=4096)
    asm = TW.Assembler(dict(jh))
    for _, frame in JW.iter_chunks(jh, jp):
        asm.feed(frame)
    tokens, k, v = asm.arrays()
    n = len(tokens)
    assert te.import_prefix_pages(tokens, k, v, jh) == n and n > TINY["page_size"]
    got = _pool_pages(te, tokens + [0])
    if pool == "fp":
        assert np.array_equal(got[0], k) and np.array_equal(got[1], v)
    else:   # the bytes a JAX int8 importer holds for the same wire pages
        for g, w in zip(got, JT.quantize_rows_np(k) + JT.quantize_rows_np(v)):
            assert np.array_equal(g, w)
    warm = te.generate(TRequest(id="w", prompt=prompt, options=dict(GREEDY)))
    assert warm.cached_tokens == n and warm.token_ids == unified.token_ids
    # torch → JAX: the port's header and frames into the JAX package
    tx = te.export_prefix_pages(ctx[:-1])
    assert tx["kvLayout"] == jx["kvLayout"] == "ragged" and tx["dtype"] == "float32"
    if pool == "fp":
        assert np.array_equal(tx["k"], jx["k"]) and np.array_equal(tx["v"], jx["v"])
    th, tp = TW.build_header("rt", MODEL, tx["tokens"], tx["k"], tx["v"], dtype=tx["dtype"],
                             kv_layout=tx["kvLayout"], chunk_bytes=4096)
    j_asm = JW.Assembler(dict(th))
    for _, frame in TW.iter_chunks(th, tp):
        j_asm.feed(frame)
    _evict(je, tokens + [0])
    assert je.alloc.pin_prefix(tokens + [0])[0] == []
    assert je.import_prefix_pages(*j_asm.arrays(), th) == n
    back = je.export_prefix_pages(ctx[:-1])
    if pool == "fp":
        assert np.array_equal(back["k"], jx["k"]) and np.array_equal(back["v"], jx["v"])
    else:
        # the JAX int8 pool now holds the requantized torch export
        want = TT.quantize_rows_np(tx["k"], "float32") + TT.quantize_rows_np(tx["v"], "float32")
        for g, w in zip(_pool_pages(je, tokens + [0]), want):
            assert np.array_equal(g, w)
    again = je.generate(JRequest(id="a", prompt=prompt, options=dict(GREEDY)))
    assert again.cached_tokens == n and again.token_ids == unified.token_ids


def test_import_refuses_a_foreign_geometry(engines):
    _, te = engines["fp"]
    k = np.zeros((1, 1, TINY["page_size"], 2, 4), np.float32)
    header, _ = TW.build_header("g", MODEL, list(range(TINY["page_size"])), k, k)
    with pytest.raises(ValueError, match="geometry"):
        te.import_prefix_pages(list(range(TINY["page_size"])), k, k, header)
    bad = dict(header, numLayers=te.cfg.num_layers, kvHeads=te.cfg.num_kv_heads,
               headDim=te.cfg.head_dim_, dtype="bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        te.import_prefix_pages(list(range(TINY["page_size"])), k, k, bad)


class Fleet:
    """The JAX scheduler and registry on one JAX InMemoryBus, with workers
    of either package in given roles."""

    def __init__(self, workers, http=()):
        self.specs = workers   # [(kind, engine, worker id, role)]
        self.http = set(http)  # torch workers whose health port serves /kvx/
        self.ports = []

    async def __aenter__(self):
        self.bus = InMemoryBus()
        await self.bus.connect()
        cfg = SchedulerConfig(worker_heartbeat_timeout_ms=60_000, job_timeout_ms=180_000,
                              sweep_interval_ms=200)
        self.registry = WorkerRegistry(self.bus, cfg)
        self.scheduler = JobScheduler(self.bus, self.registry, cfg)
        await self.registry.initialize()
        await self.scheduler.initialize()
        self.workers = {}
        for kind, engine, wid, role in self.specs:
            svc = _worker(kind, engine, self.bus, wid, role=role, heartbeat_interval_ms=150)
            svc._snap_every = 2
            if wid in self.http:
                # port 0: the bound port is advertised as the worker's
                # httpAddr, which the scheduler plans as decodeAddr
                runner = await start_health_port(svc, "127.0.0.1", 0)
                self.ports.append(runner)
                svc.config.advertise_addr = "127.0.0.1:%d" % runner.addresses[0][1]
            await svc.start()
            self.workers[wid] = (svc, engine)
        await self.until(lambda: all(
            (w := self.registry.get_worker(wid)) is not None and w.role == role
            and (role != "decode" or w.decodeSlotsFree > 0)
            for _, _, wid, role in self.specs))
        self.drains = []

        async def on_drain(_ch, raw):
            self.drains.append(json.loads(raw))

        await self.bus.subscribe(CH_JOB_DRAIN, on_drain)
        return self

    async def __aexit__(self, *exc):
        for runner in self.ports:
            await runner.cleanup()
        for svc, engine in self.workers.values():
            await _settle(engine)
            await svc.stop(announce=False)
        await self.scheduler.shutdown()
        await self.registry.shutdown()
        await self.bus.disconnect()

    @staticmethod
    async def until(cond, timeout=60.0):
        for _ in range(int(timeout / 0.01)):
            if cond():
                return
            await asyncio.sleep(0.01)
        raise AssertionError("condition never held")

    def count(self, event):
        return int(self.scheduler._disagg_total.value(event=event))

    async def run(self, prompt, n=16, chaos=None):
        """One streaming greedy request: (client text, result); `chaos(job
        id)` fires once the job's snapshot shows decode progress."""
        chunks = []

        async def on_chunk(c):
            chunks.append(c.response)

        req = InferenceRequest(id=f"job-{uuid.uuid4().hex[:8]}", model=MODEL, prompt=prompt,
                               stream=True, options={"temperature": 0, "num_predict": n},
                               metadata={"requestType": "inference"})
        task = asyncio.create_task(self.scheduler.submit_streaming_job(
            req, on_chunk, timeout_ms=120_000))
        if chaos is not None:
            await self.until(lambda: len((self.scheduler._resume_snap.get(req.id)
                                          or {"tokens": []})["tokens"]) >= 4)
            await chaos(req.id)
        result = await task
        assert result.success, result.error
        text = "".join(chunks)
        assert text == result.response.response
        return text, result


async def _unified(kind, engine, prompt, n=16):
    async with Fleet([(kind, engine, f"uni-{kind}", "unified")]) as f:
        return await f.run(prompt, n)


@pytest.mark.parametrize("prefill,decode,path", [
    ("jax", "torch", "bus"), ("torch", "jax", "bus"), ("jax", "torch", "http")])
async def test_disagg_stream_equals_unified(engines, monkeypatch, prefill, decode, path):
    """The HTTP case: the JAX sender POSTs the payload to the torch decode
    worker's health port (`/kvx/{id}`) instead of streaming bus chunks."""
    je, te = engines["fp"]
    eng = {"jax": je, "torch": te}
    prompt = PROMPTS[f"{prefill}-{decode}-{path}"]
    monkeypatch.setenv("GRIDLLM_KVX_HTTP_BYTES", "1" if path == "http" else "0")
    ref, ref_res = await _unified(prefill, eng[prefill], prompt)
    async with Fleet([(prefill, eng[prefill], "w-prefill", "prefill"),
                      (decode, eng[decode], "w-decode", "decode")],
                     http=["w-decode"] if path == "http" else []) as f:
        handoffs = []

        async def on_handoff(_ch, raw):
            handoffs.append(json.loads(raw))

        await f.bus.subscribe(CH_JOB_HANDOFF, on_handoff)
        text, res = await f.run(prompt)
        assert [h["path"] for h in handoffs] == [path] and handoffs[0]["ok"]
        assert text == ref and text
        assert res.response.eval_count == ref_res.response.eval_count
        assert res.workerId == "w-decode"
        assert (f.count("planned"), f.count("handoff"), f.count("fallback")) == (1, 1, 0)
        decoder = f.workers["w-decode"][0]
        assert decoder.kvx.imported[res.jobId] > 0
        if decode == "torch":
            assert res.usage["migratedBytes"] > 0


async def test_failed_transfer_falls_back_to_local_serving(engines, monkeypatch):
    je, te = engines["fp"]
    prompt = PROMPTS["fallback"]
    ref, _ = await _unified("jax", je, prompt)

    def boom(*_a, **_k):
        raise RuntimeError("injected import failure")

    monkeypatch.setattr(te, "import_prefix_pages", boom)
    async with Fleet([("jax", je, "w-prefill", "prefill"),
                      ("torch", te, "w-decode", "decode")]) as f:
        text, res = await f.run(prompt)
        assert text == ref and res.workerId == "w-prefill"
        assert (f.count("planned"), f.count("handoff"), f.count("fallback")) == (1, 0, 1)


async def test_graceful_drain_live_migrates_mid_decode(engines):
    je, te = engines["fp"]
    victim, survivor = "torch", "jax"
    eng = {"jax": je, "torch": te}
    prompt, n = PROMPTS["drain"], 48
    ref, ref_res = await _unified(survivor, eng[survivor], prompt, n)
    async with Fleet([(victim, eng[victim], "victim", "unified")]) as f:
        async def drain(_job_id):
            svc = _worker(survivor, eng[survivor], f.bus, "survivor", heartbeat_interval_ms=150)
            await svc.start()
            f.workers["survivor"] = (svc, eng[survivor])
            await f.until(lambda: f.registry.get_worker("survivor") is not None)
            report = await f.workers["victim"][0].drain(budget_ms=0)
            assert report["suspended"] == 1

        text, res = await f.run(prompt, n, chaos=drain)
        assert (text, res.response.eval_count) == (ref, ref_res.response.eval_count)
        assert res.workerId == "survivor"
        (msg,) = f.drains
        assert msg["migrated"] and msg["toWorker"] == "survivor" and msg["bytes"] > 0
        assert f.workers["survivor"][0].kvx.imported[res.jobId] > 0
        assert int(f.scheduler._jobs_total.value(event="orphaned")) == 0
