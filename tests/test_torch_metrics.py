"""A torch worker's Prometheus series against a JAX worker's, on the CPU.

One JAX worker and one torch worker, each behind the JAX gateway and
scheduler on an in-memory bus (tests/test_torch_worker.py's `Stack`), serve
the same greedy jobs on the same weights. Both registries are scraped in
Prometheus text:

- the engine, prefix-cache, kernel-dispatch, step-phase, device-memory,
  weight-snapshot, host KV tier and KV migration families carry the same
  series names, help, types, label names and histogram buckets in both,
  less the documented exceptions (`UNPORTED`);
- the token counts, speculation proposals and acceptances, prefix-cache
  hits and misses, and the KV page and per-tier gauges the jobs leave are
  equal (same allocator, same greedy drafts);
- on the CPU every dispatch takes the plain path (`path="jnp"`), counted
  once per op and shape.
"""

import asyncio
import json
import re

import jax
import numpy as np
import pytest

from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.obs import default_registry as t_registry
from gridllm_torch.ops import kvcache as TC
from gridllm_tpu.engine import EngineConfig as JConfig
from gridllm_tpu.engine import InferenceEngine as JEngine
from gridllm_tpu.obs import default_registry as j_registry
from tests.test_torch_worker import LONG, MODEL, TINY, Stack

FAMILIES = ("gridllm_engine_", "gridllm_prefix_cache_", "gridllm_model_load_seconds",
            "gridllm_spec_", "gridllm_kernel_dispatch_total", "gridllm_device_memory_",
            "gridllm_weight_snapshot_", "gridllm_recompile", "gridllm_kv_tier_",
            "gridllm_kv_migration", "gridllm_worker_")
# JAX series the torch worker does not define: the jit recompile tripwire
# (no jit, nothing compiles per shape)
UNPORTED = {"gridllm_recompiles_total", "gridllm_recompile_storms_total"}
UNPORTED_PREFIXES = ()
GREEDY = {"temperature": 0, "num_predict": 12}
_SAMPLE = re.compile(r"^([a-z_]+?)(_bucket|_sum|_count)?(\{(.*)\})? (\S+)$")


def _in_scope(name):
    return name.startswith(FAMILIES)


def _parse(text):
    """{name: {"help", "type", "series": {labels-tuple: value}}} of the
    in-scope families (histogram samples under their base name, `le`
    kept)."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            _, kind, name, rest = line.split(" ", 3)
            if _in_scope(name):
                out.setdefault(name, {"series": {}})[kind.lower()] = rest
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        base = m.group(1) if m.group(1) in out else m.group(1) + (m.group(2) or "")
        if base not in out:
            continue
        labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', m.group(4) or "")))
        out[base]["series"][(m.group(2) or "",) + labels] = float(m.group(5))
    return out


def _value(parsed, name, **labels):
    want = ("",) + tuple(sorted(labels.items()))
    return parsed.get(name, {"series": {}})["series"].get(want, 0.0)


def _label_names(entry):
    return {tuple(k for k, _ in key[1:] if k != "le") for key in entry["series"]}


def _buckets(entry):
    return sorted({float(v) if v != "+Inf" else float("inf") for key in entry["series"]
                   for k, v in key[1:] if k == "le"})


COUNTED = [("gridllm_engine_tokens_total", dict(kind="prefill")),
           ("gridllm_engine_tokens_total", dict(kind="prefill_cached")),
           ("gridllm_engine_tokens_total", dict(kind="decode")),
           ("gridllm_spec_proposed_tokens_total", dict(drafter="ngram")),
           ("gridllm_spec_accepted_tokens_total", dict(drafter="ngram")),
           ("gridllm_spec_rejected_tokens_total", dict(drafter="ngram")),
           ("gridllm_prefix_cache_hits_total", {}),
           ("gridllm_prefix_cache_misses_total", {})]
GAUGES = ["gridllm_engine_kv_pages_used", "gridllm_engine_kv_pages_free",
          "gridllm_engine_kv_pages_cached", "gridllm_prefix_cache_hit_rate"]


def _runner_idle(engine):
    """No slot, no pending request, no block in flight and no control entry
    queued: the runner state both packages' engines keep (`_slots`,
    `_pending`, `_inflight`, `_ctl`)."""
    return not (engine._slots or engine._pending or engine._inflight or engine._ctl)


async def _until_idle(engine, timeout=60.0):
    """Wait until the engine is idle and its runner has finished the
    iteration that emptied it. A slot leaves `_slots` inside the ingest
    loop, before that iteration adds its decode tokens to the counter, so
    an empty engine alone does not say the counts are in: a cancel for no
    request, queued on the runner's control deque, is taken off only at the
    start of the runner's next iteration, after the last one has ended."""
    async def until(cond):
        for _ in range(int(timeout / 0.005)):
            if cond():
                return
            await asyncio.sleep(0.005)
        raise AssertionError("engine never went idle")

    await until(lambda: _runner_idle(engine))
    with engine._work:
        engine._ctl.append(("cancel", ""))
        engine._work.notify_all()
    await until(lambda: _runner_idle(engine))


async def _serve(kind, engine, registry):
    """Two identical greedy jobs (the second hits the prefix cache) and a
    short one: the counters' growth and the gauges after. Each job starts
    only once the engine is idle after the previous one (the result reaches
    the client before the runner has fetched its last block), so each
    admission meets the same runner state in both packages: whether a
    prefill sample rides row 0 of a block, and so counts as a decode token,
    depends on it."""
    before = _parse(registry.render())
    texts = []
    async with Stack(kind, engine) as st:
        for prompt in (LONG, LONG, "hello there"):
            await _until_idle(engine)
            status, text = await st.post("/ollama/api/generate", {
                "model": MODEL, "prompt": prompt, "stream": False, "options": GREEDY})
            assert status == 200, text
            body = json.loads(text)
            texts.append((body["response"], body["eval_count"], body["prompt_eval_count"]))
        # the finish's gauge update lands after the result
        await _until_idle(engine)
        # scraped while the worker's memory probe is registered
        after = _parse(registry.render())
    grown = {(n, tuple(sorted(lb.items()))): _value(after, n, model=MODEL, **lb)
             - _value(before, n, model=MODEL, **lb) for n, lb in COUNTED}
    gauges = {n: _value(after, n, model=MODEL) for n in GAUGES}
    gauges.update({(n, t): _value(after, n, model=MODEL, tier=t)
                   for n in ("gridllm_kv_tier_pages", "gridllm_kv_tier_bytes")
                   for t in ("hbm", "host")})
    return after, grown, gauges, texts


@pytest.fixture(scope="module")
def scraped():
    je = JEngine(JConfig(**TINY))
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = TEngine(TConfig(**TINY), device="cpu", params=params)
    j = asyncio.run(_serve("jax", je, j_registry()))
    t = asyncio.run(_serve("torch", te, t_registry()))
    return j, t


def test_series_names_help_labels_and_buckets_equal_jax(scraped):
    (jp, *_), (tp, *_) = scraped
    j_names = {n for n in jp if n not in UNPORTED and not n.startswith(UNPORTED_PREFIXES)}
    assert set(tp) == j_names
    for name in sorted(j_names):
        j, t = jp[name], tp[name]
        assert (t["help"], t["type"]) == (j["help"], j["type"]), name
        if j["series"] and t["series"]:
            assert _label_names(t) == _label_names(j), name
            if j["type"] == "histogram":
                assert _buckets(t) == _buckets(j), name
    # every family the jobs exercise has samples on the torch side
    for name in ("gridllm_engine_tokens_total", "gridllm_engine_step_duration_seconds",
                 "gridllm_engine_batch_occupancy", "gridllm_engine_kv_pages_used",
                 "gridllm_prefix_cache_hit_rate", "gridllm_model_load_seconds",
                 "gridllm_spec_proposed_tokens_total", "gridllm_spec_acceptance_rate",
                 "gridllm_prefix_cache_hits_total", "gridllm_kernel_dispatch_total",
                 "gridllm_engine_host_sched_seconds", "gridllm_engine_dispatch_seconds",
                 "gridllm_engine_device_step_seconds", "gridllm_device_memory_bytes"):
        assert tp[name]["series"], name
    kinds = {dict(k[1:])["kind"] for k in tp["gridllm_device_memory_bytes"]["series"]}
    assert kinds == {"weights", "kv_pool", "workspace"}
    # the CPU reports no allocator limit, in either package
    assert not tp["gridllm_device_memory_limit_bytes"]["series"]
    assert not tp["gridllm_device_memory_headroom_bytes"]["series"]


def test_counts_and_page_gauges_equal_jax(scraped):
    (_, j_grown, j_gauges, j_texts), (_, t_grown, t_gauges, t_texts) = scraped
    assert t_texts == j_texts
    assert t_grown == j_grown
    assert t_grown[("gridllm_engine_tokens_total", (("kind", "decode"),))] > 0
    assert t_grown[("gridllm_prefix_cache_hits_total", ())] > 0
    assert t_grown[("gridllm_spec_proposed_tokens_total", (("drafter", "ngram"),))] > 0
    assert t_gauges == j_gauges
    assert t_gauges["gridllm_engine_kv_pages_cached"] > 0
    assert t_gauges[("gridllm_kv_tier_pages", "hbm")] == t_gauges["gridllm_engine_kv_pages_cached"]


def test_cpu_dispatch_takes_the_plain_path_once_per_shape(scraped):
    _, (tp, *_) = scraped
    paths = {dict(k[1:])["path"] for k in tp["gridllm_kernel_dispatch_total"]["series"]}
    assert paths == {"jnp"}
    ops = {dict(k[1:])["op"] for k in tp["gridllm_kernel_dispatch_total"]["series"]}
    assert {"attention_prefill", "attention_ragged", "write_decode", "write_multi",
            "write_prefill"} <= ops
    n = t_registry().get("gridllm_kernel_dispatch_total").total()
    q = __import__("torch").zeros((1, 16, 4, 16))
    TC.record_kernel_path("attention_prefill", False, q.shape)
    TC.record_kernel_path("attention_prefill", False, q.shape)
    assert t_registry().get("gridllm_kernel_dispatch_total").total() - n <= 1
