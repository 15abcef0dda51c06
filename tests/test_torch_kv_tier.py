"""The port's host KV tier in the engine and the worker, against the JAX
package's.

Tiny-llama at float32 on the CPU, the torch engines on the JAX engine's
weights, with a pool small enough that one long request evicts the prefix
cache (the JAX package's tests/test_kv_tier.py setting):

- spill on eviction and restore on the next match: greedy streams equal
  with the tier on (raw spill) and off, and equal the JAX engine's, whose
  tier spills, restores and misses as many pages under the same requests;
- the int8 spill completes warm; an int8 pool spills its rows and scales
  verbatim and restores its own stream exactly;
- injected spill and restore faults degrade to a cold prefill;
- park_to_host raises the pool's free pages by the parked pages and the
  resume restores them exactly; a page shared with a live request is
  never freed;
- a preemption behind the JAX scheduler parks the victim's pages in the
  host tier and resumes it exactly once.
"""

import asyncio
import threading
import uuid

import jax
import numpy as np
import pytest

from gridllm_torch import faults as tfaults
from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import GenerationRequest as TRequest
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.utils.config import WorkerConfig as TWorkerConfig
from gridllm_torch.worker.service import WorkerService as TWorker
from gridllm_tpu.bus.memory import InMemoryBus
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import GenerationRequest as JRequest
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.scheduler import JobScheduler, WorkerRegistry
from gridllm_tpu.utils.config import Config
from gridllm_tpu.utils.types import InferenceRequest, Priority

TIER = dict(model="tiny-llama", max_slots=2, page_size=16, num_pages=16,
            max_pages_per_slot=12, prefill_buckets=(32, 64), prefill_chunk=16,
            dtype="float32", seed=7)
SHARED = "Policy clause: the quick brown fox jumps over the lazy dog. " * 3
LONG = ("X" * 150) + " overflow tail"
RAW = dict(kv_host_bytes=1 << 22, kv_spill_int8=False)


def _gen(cls, prompt, rid, n=8):
    return cls(id=rid, prompt=prompt, options={"temperature": 0, "num_predict": n})


def _drive_pressure(engine, cls=TRequest):
    """A warm request, a long request that evicts it, the warm one again."""
    warm = engine.generate(_gen(cls, SHARED + "Q:", "warm"))
    engine.generate(_gen(cls, LONG, "long"))
    post = engine.generate(_gen(cls, SHARED + "Q:", "post"))
    return warm, post


@pytest.fixture(scope="module")
def jax_tier():
    """A JAX engine with a raw-spill tier, driven through the pressure run:
    (engine, warm, post, tier stats), and its weights for the port."""
    je = JEngine(JConfig(**TIER, **RAW))
    warm, post = _drive_pressure(je, JRequest)
    params = jax.tree_util.tree_map(np.asarray, je.params)
    return je, warm, post, je.host_tier.stats(), params


def _engine(params, **kw):
    return TEngine(TConfig(**{**TIER, **kw}), device="cpu", params=params)


def test_spill_restore_streams_equal_tier_on_off_and_jax(jax_tier):
    je, j_warm, j_post, j_stats, params = jax_tier
    on = _engine(params, **RAW)
    warm_on, post_on = _drive_pressure(on)
    st = on.host_tier.stats()
    assert on.alloc.evictions > 0 and st["spills"] > 0 and st["restores"] > 0
    assert post_on.cached_tokens > 0   # warm again after the eviction storm
    off = _engine(params, kv_host_bytes=0)
    warm_off, post_off = _drive_pressure(off)
    assert off.host_tier is None and post_off.cached_tokens == 0
    assert post_on.token_ids == post_off.token_ids == warm_on.token_ids == warm_off.token_ids
    assert post_on.token_ids == j_post.token_ids == j_warm.token_ids
    assert post_on.text == j_post.text
    # the same allocator and the same requests: the same tier traffic
    for k in ("spills", "restores", "misses", "evictions", "pages", "bytes"):
        assert st[k] == j_stats[k], k
    assert post_on.cached_tokens == j_post.cached_tokens
    assert on.memory_arrays()["alloc"]["hostTier"]["spillDtype"] == "raw"


def test_int8_spill_and_int8_pool_round_trips(jax_tier):
    *_, params = jax_tier
    e = _engine(params, kv_host_bytes=1 << 22, kv_spill_int8=True)
    _, post = _drive_pressure(e)
    assert e.host_tier.stats()["restores"] > 0 and e.host_tier.stats()["spillDtype"] == "int8-page"
    assert post.cached_tokens > 0 and post.done_reason in ("stop", "length")
    # an int8 pool spills rows and scales verbatim: the restored stream is
    # the warm one
    q8 = _engine(params, kv_int8=True, kv_host_bytes=1 << 22)
    warm, post = _drive_pressure(q8)
    assert q8.host_tier.stats()["restores"] > 0 and post.cached_tokens > 0
    assert post.token_ids == warm.token_ids


@pytest.mark.parametrize("site", ["kvtier.restore", "kvtier.spill"])
def test_injected_faults_degrade_to_a_cold_prefill(jax_tier, site):
    _, j_warm, *_, params = jax_tier
    e = _engine(params, **RAW)
    try:
        if site == "kvtier.spill":
            tfaults.configure("kvtier.spill=1.0")
            _, post = _drive_pressure(e)
            st = e.host_tier.stats()
            assert st["spills"] == 0 and st["restores"] == 0 and st["misses"] > 0
        else:
            _drive_pressure(e)
            e.generate(_gen(TRequest, LONG + " again", "evict2"))
            tfaults.configure("kvtier.restore=1.0")
            post = e.generate(_gen(TRequest, SHARED + "Q:", "cold"))
            assert e.host_tier.stats()["restoreFailures"] > 0
        assert post.cached_tokens == 0 and post.token_ids == j_warm.token_ids
    finally:
        tfaults.reset()


def test_park_frees_pages_and_resumes_exactly(jax_tier):
    *_, params = jax_tier
    e = _engine(params, **RAW, num_pages=32)
    r1 = e.generate(_gen(TRequest, SHARED + "Park:", "p1", n=10))
    assert e.alloc.cached_pages > 0
    free = e.alloc.free_pages
    parked = e.park_to_host(r1.context[:-1])
    ps = TIER["page_size"]
    assert parked > 0 and parked % ps == 0
    assert e.alloc.free_pages == free + parked // ps and e.alloc.cached_pages == 0
    assert e.host_tier.stats()["pages"] >= parked // ps
    r2 = e.generate(_gen(TRequest, SHARED + "Park:", "p2", n=10))
    assert r2.cached_tokens > 0 and r2.token_ids == r1.token_ids
    assert e.park_to_host([1]) == 0


def test_park_never_frees_a_pinned_shared_page(jax_tier):
    """Park while a live request shares the prefix: its pages are copied to
    the host tier but stay on the device, and the live stream is the one
    the undisturbed run gives."""
    *_, params = jax_tier
    e = _engine(params, **RAW, num_pages=32)
    r1 = e.generate(_gen(TRequest, SHARED + "A:", "sh1", n=6))
    admitted, done, box = threading.Event(), threading.Event(), []

    def cb(_delta, fin, res):
        admitted.set()
        if fin:
            box.append(res)
            done.set()

    e.submit(TRequest(id="sh2", prompt=SHARED + "A:", on_chunk=cb,
                      options={"temperature": 0, "num_predict": 40}))
    e.step()   # admitted: the shared prefix pages are pinned by sh2
    held = set(e.alloc._owned[next(iter(e._slots))])
    parked = e.park_to_host(r1.context[:-1])
    assert parked > 0
    assert held.isdisjoint(e.alloc._free)   # pinned pages never freed
    while not done.is_set():
        e.step()
    assert box[0].token_ids[:6] == r1.token_ids


async def _until(cond, timeout=60.0):
    for _ in range(int(timeout / 0.01)):
        if cond():
            return
        await asyncio.sleep(0.01)
    raise AssertionError("condition never held")


async def test_preemption_round_trip(jax_tier):
    """A queued high-priority job preempts a running low-priority one on a
    torch worker behind the JAX scheduler: the victim's pages park in the
    host tier, the interactive job runs, and the victim resumes exactly
    once with its full token count."""
    *_, params = jax_tier
    eng = _engine(params, max_slots=1, num_pages=48, max_pages_per_slot=16, seed=3, **RAW)
    ref = _engine(params, max_slots=1, num_pages=48, max_pages_per_slot=16, seed=3)
    bus = InMemoryBus()
    await bus.connect()
    sched_cfg = Config().scheduler.model_copy(
        update={"preempt_after_ms": 100, "sweep_interval_ms": 100})
    registry = WorkerRegistry(bus, sched_cfg)
    scheduler = JobScheduler(bus, registry, sched_cfg)
    await registry.initialize()
    await scheduler.initialize()
    worker = TWorker(bus, {"tiny-llama": eng}, TWorkerConfig(worker_id="pre-w"),
                     stream_flush_ms=5)
    await worker.start()
    await _until(lambda: registry.get_worker("pre-w") is not None)

    def req(prompt, prio, n):
        return InferenceRequest(id=uuid.uuid4().hex, model="tiny-llama", prompt=prompt,
                                request_type="generate", priority=prio, stream=False,
                                options={"temperature": 0, "num_predict": n})

    try:
        batch = req("count: one two three four", Priority.low, 400)
        t_batch = asyncio.ensure_future(scheduler.submit_and_wait(batch, timeout_ms=180_000))
        await _until(lambda: eng.active_requests == 1)
        r_inter = await scheduler.submit_and_wait(req("hello there", Priority.high, 8),
                                                  timeout_ms=120_000)
        r_batch = await asyncio.wait_for(t_batch, 240)
        assert r_inter.success and r_batch.success
        jt = scheduler._jobs_total
        assert int(jt.value(event="preempt_requested")) >= 1
        assert int(jt.value(event="preempted")) >= 1
        st = eng.host_tier.stats()
        assert st["spills"] >= 1 and st["restores"] >= 1
        # exactly once: the resumed stream is the undisturbed one
        want = ref.generate(_gen(TRequest, "count: one two three four", "ref", n=400))
        assert r_batch.response.eval_count == len(want.token_ids)
        assert r_batch.response.response == want.text
    finally:
        await worker.stop()
        await scheduler.shutdown()
        await registry.shutdown()
        await bus.disconnect()
