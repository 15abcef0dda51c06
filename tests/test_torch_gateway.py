"""The port's gateway against the JAX package's, on the CPU.

Each case drives two stacks with the same requests: the JAX bus, registry,
scheduler and `create_app` with tests/helpers.py's `FakeWorker`, and the
port's with `TFakeWorker` (tests/test_torch_scheduler.py's copy of that
fake on the port's types). A small admin responder answers the model
management broadcasts on each bus as a worker does. Both stacks give the
same status, content type and body apart from the fields named in
`VOLATILE` (ids, times, durations, process readings):

- one parametrised table over every route: the Ollama surface under /api
  and /ollama/api, /v1, /inference, /health*, /metrics, /admin/* and /,
  and the error cases (missing and unknown model, malformed JSON, a field
  of the wrong type, a body over max_body_bytes, a rate-limit window of 2,
  /api/push, POST /admin/profile in a process with no engine);
- the NDJSON and SSE frame sequences of the streamed routes;
- the /metrics series names and labels after the same request sequence,
  and the span names of /admin/trace/{id};
- a tiny-llama float32 port engine behind both gateways: byte-identical
  texts and eval counts for generate, chat, their streams and the two
  OpenAI routes;
- load_config's gateway names and refusals, the refusal of
  GRIDLLM_CONTROLPLANE=gateway, and a process in which jax, jaxlib,
  gridllm_tpu and pydantic cannot be imported serving /health and a greedy
  /api/generate through the port's GatewayServer on port 0.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

import gridllm_torch.bus as tbus
import gridllm_torch.bus.base as tbase
import gridllm_torch.gateway.app as tapp
import gridllm_torch.obs as tobs
import gridllm_torch.scheduler as tsched
import gridllm_torch.utils.config as tconfig
import gridllm_tpu.bus as jbus
import gridllm_tpu.bus.base as jbase
import gridllm_tpu.gateway.app as japp
import gridllm_tpu.obs as jobs
import gridllm_tpu.obs.perf as jperf
import gridllm_tpu.scheduler as jsched
import gridllm_tpu.utils.config as jconfig
from gridllm_torch.engine import EngineConfig as TConfig
from gridllm_torch.engine import InferenceEngine as TEngine
from gridllm_torch.utils.config import WorkerConfig as TWorkerConfig
from gridllm_torch.worker.service import WorkerService as TWorker

from .helpers import FakeWorker, fast_config
from .test_torch_scheduler import TFakeWorker

REPO = Path(__file__).resolve().parents[1]
MODEL = "tiny-llama"
TINY = dict(model=MODEL, max_slots=4, page_size=8, num_pages=128, max_pages_per_slot=16,
            prefill_buckets=(16, 64, 128), prefill_chunk=16, dtype="float32", seed=42)
GREEDY = {"temperature": 0, "num_predict": 8}
TOKENS = ["a", "b", "c"]
MAX_BODY = 64 * 1024

# values that differ between any two runs: request ids, clocks, durations
# and readings of the process (memory, load, uptime, flight-recorder rings)
VOLATILE = frozenset({
    "id", "created", "created_at", "timestamp", "uptime", "total_duration",
    "processingTimeMs", "lastHeartbeat", "assignedAt", "expires_at", "modified_at",
    "generatedAt", "maxRssMB", "loadAvg", "rings", "evicted", "member", "events",
})


def scrub(obj):
    if isinstance(obj, dict):
        return {k: ("<v>" if k in VOLATILE else scrub(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def sched_config(kind: str):
    """fast_config()'s timers, with liveness windows and job timeouts a
    slowed process cannot trip (no case here tests a failure path of the
    scheduler, and the job counters are in the bodies compared)."""
    kw = dict(worker_heartbeat_timeout_ms=60_000, quick_disconnect_window_ms=60_000,
              orphan_assign_threshold_ms=60_000, job_timeout_ms=60_000)
    if kind == "jax":
        return fast_config().model_copy(update=kw)
    base = {f: getattr(fast_config(), f) for f in type(fast_config()).model_fields}
    return tconfig.SchedulerConfig(**{**base, **kw})


class AdminResponder:
    """Answers the gateway's model-management broadcasts (worker:admin) as
    a worker does: an ack, then ok for a model it serves (a copy to any
    name), not-loaded otherwise."""

    def __init__(self, bus, base, worker_id: str, models: list[str]):
        self.bus, self.base, self.worker_id, self.models = bus, base, worker_id, models

    async def start(self):
        self.sub = await self.bus.subscribe(self.base.CH_WORKER_ADMIN, self._on_admin)

    async def _on_admin(self, _ch, raw):
        msg = json.loads(raw)
        op, rid = msg["op"], msg["id"]
        channel = self.base.admin_result_channel(rid)
        await self.bus.publish(channel, json.dumps(
            {"workerId": self.worker_id, "op": op, "ack": True}))
        model = msg.get("model") or msg.get("source")
        ok = model in self.models
        await self.bus.publish(channel, json.dumps({
            "workerId": self.worker_id, "op": op, "ok": ok,
            "detail": "done" if ok else f"model {model!r} not loaded here"}))


class GatewayStack:
    """One package's bus, registry, scheduler and gateway app behind a test
    client, with a fake worker (or a given worker factory)."""

    def __init__(self, kind: str, rate_limit: int = 10_000, worker=None,
                 timeline: bool = False, scope: str = "replica"):
        self.kind, self.rate_limit, self.make_worker = kind, rate_limit, worker
        self.timeline, self.scope = timeline, scope

    async def __aenter__(self):
        jax = self.kind == "jax"
        bus_mod, sched_mod, cfg_mod = (jbus, jsched, jconfig) if jax else (tbus, tsched, tconfig)
        self.bus = bus_mod.InMemoryBus(key_prefix="G:")
        await self.bus.connect()
        cfg = sched_config(self.kind)
        self.registry = sched_mod.WorkerRegistry(self.bus, cfg)
        self.scheduler = sched_mod.JobScheduler(self.bus, self.registry, cfg)
        await self.registry.initialize()
        await self.scheduler.initialize()
        config = cfg_mod.Config()
        config.scheduler = cfg
        config.gateway.rate_limit_max_requests = self.rate_limit
        config.gateway.rate_limit_scope = self.scope
        config.gateway.max_body_bytes = MAX_BODY
        store = incidents = self.publisher = None
        if self.timeline:
            # the GatewayServer's timeline wiring: publisher, store, collector
            obs = jobs if jax else tobs
            self.publisher = obs.TimelinePublisher("local", flush_ms=20)
            self.publisher.install()
            await self.publisher.start(self.bus)
            store = self.store = obs.TimelineStore(capacity=256, max_requests=16)
            await store.attach(self.bus)
            incidents = obs.IncidentCollector(store, member="local")
        app = (japp if jax else tapp).create_app(self.bus, self.registry, self.scheduler,
                                                 config, timeline=store, incidents=incidents)
        if self.make_worker is None:
            fake = FakeWorker if jax else TFakeWorker
            self.worker = fake(self.bus, "w1", ["m1"], max_concurrent=4, stream_tokens=TOKENS)
            self.admin = AdminResponder(self.bus, jbase if jax else tbase, "w1", ["m1"])
            await self.admin.start()
        else:
            self.worker = self.make_worker(self.bus)
        await self.worker.start()
        for _ in range(1000):
            await self.bus.flush()
            if self.registry.get_online_workers():
                break
            await asyncio.sleep(0.01)
        self.client = TestClient(TestServer(app))
        await self.client.start_server()
        return self

    async def __aexit__(self, *exc):
        await self.client.close()
        await self.worker.stop(announce=False)
        await self.scheduler.shutdown()
        await self.registry.shutdown()
        if self.publisher is not None:
            await self.publisher.stop()
            await self.store.detach()
        await self.bus.disconnect()

    async def call(self, method: str, path: str, body=None, raw: bytes | None = None):
        """(status, content type, body): JSON parsed, NDJSON as a list of
        objects, SSE as a list of data payloads, anything else as text."""
        kw = {"data": raw} if raw is not None else ({"json": body} if body is not None else {})
        async with self.client.request(method, path, **kw) as resp:
            text = await resp.text()
            ctype = resp.headers.get("Content-Type", "")
        if ctype.startswith("application/json"):
            return resp.status, ctype, json.loads(text)
        if ctype.startswith("application/x-ndjson"):
            return resp.status, ctype, [json.loads(ln) for ln in text.splitlines() if ln]
        if ctype.startswith("text/event-stream"):
            frames = [ln[len("data: "):] for ln in text.split("\n\n") if ln]
            return resp.status, ctype, [f if f == "[DONE]" else json.loads(f) for f in frames]
        return resp.status, ctype, text


async def _both(fn, **kw):
    out = {}
    for kind in ("jax", "torch"):
        async with GatewayStack(kind, **kw) as st:
            out[kind] = await fn(st)
    return out["jax"], out["torch"]


GEN = {"model": "m1", "prompt": "hi", "stream": False}
CHAT = {"model": "m1", "stream": False, "messages": [{"role": "user", "content": "hi"}]}
OAI_CHAT = {"model": "m1", "messages": [{"role": "user", "content": "hi"}]}
OAI_COMP = {"model": "m1", "prompt": "hi"}

_OLLAMA = [
    ("POST", "generate", "/api/generate", GEN),
    ("POST", "generate_stream", "/api/generate", {**GEN, "stream": True}),
    ("POST", "generate_load", "/api/generate", {"model": "m1", "prompt": "", "stream": False}),
    ("POST", "generate_unload", "/api/generate", {"model": "m1", "keep_alive": 0}),
    ("POST", "generate_missing_model", "/api/generate", {"prompt": "hi"}),
    ("POST", "generate_unknown_model", "/api/generate", {**GEN, "model": "nope"}),
    ("POST", "generate_bad_options", "/api/generate", {**GEN, "options": "fast"}),
    ("POST", "chat", "/api/chat", CHAT),
    ("POST", "chat_stream", "/api/chat", {**CHAT, "stream": True}),
    ("POST", "chat_no_messages", "/api/chat", {"model": "m1"}),
    ("POST", "chat_bad_message", "/api/chat", {**CHAT, "messages": ["hi"]}),
    ("GET", "tags", "/api/tags", None),
    ("GET", "ps", "/api/ps", None),
    ("GET", "version", "/api/version", None),
    ("POST", "show", "/api/show", {"model": "m1"}),
    ("POST", "show_unknown", "/api/show", {"model": "nope"}),
    ("POST", "pull", "/api/pull", {"model": "m1", "stream": False}),
    ("POST", "pull_stream", "/api/pull", {"model": "m1"}),
    ("POST", "pull_unknown", "/api/pull", {"model": "nope", "stream": False}),
    ("POST", "copy", "/api/copy", {"source": "m1", "destination": "m2"}),
    ("POST", "copy_missing", "/api/copy", {"source": "m1"}),
    ("DELETE", "delete", "/api/delete", {"model": "m1"}),
    ("DELETE", "delete_unknown", "/api/delete", {"model": "nope"}),
    ("POST", "embed", "/api/embed", {"model": "m1", "input": ["alpha"]}),
    ("POST", "embed_no_input", "/api/embed", {"model": "m1"}),
    ("POST", "embeddings", "/api/embeddings", {"model": "m1", "prompt": "alpha"}),
    ("POST", "push", "/api/push", {"model": "m1"}),
]
CASES = [(m, f"{'ollama' if prefix else 'api'}_{name}", prefix + path, body)
         for prefix in ("", "/ollama") for m, name, path, body in _OLLAMA] + [
    ("POST", "v1_chat", "/v1/chat/completions", OAI_CHAT),
    ("POST", "v1_chat_stream", "/v1/chat/completions",
     {**OAI_CHAT, "stream": True, "stream_options": {"include_usage": True}}),
    ("POST", "v1_chat_missing_model", "/v1/chat/completions", {"messages": []}),
    ("POST", "v1_chat_unknown_model", "/v1/chat/completions", {**OAI_CHAT, "model": "nope"}),
    ("POST", "v1_chat_no_messages", "/v1/chat/completions", {"model": "m1"}),
    ("POST", "v1_completions", "/v1/completions", {**OAI_COMP, "echo": True, "max_tokens": 4}),
    ("POST", "v1_completions_stream", "/v1/completions", {**OAI_COMP, "stream": True}),
    ("POST", "v1_completions_no_prompt", "/v1/completions", {"model": "m1"}),
    ("GET", "v1_models", "/v1/models", None),
    ("POST", "inference", "/inference", {"model": "m1", "prompt": "hi", "priority": "high"}),
    ("POST", "inference_bad_priority", "/inference",
     {"model": "m1", "prompt": "hi", "priority": "urgent"}),
    ("POST", "inference_unknown_model", "/inference", {"model": "nope", "prompt": "hi"}),
    ("GET", "inference_models", "/inference/models", None),
    ("GET", "inference_queue", "/inference/queue", None),
    ("GET", "inference_status_unknown", "/inference/nope/status", None),
    ("DELETE", "inference_cancel_unknown", "/inference/nope", None),
    ("GET", "health", "/health", None),
    ("GET", "health_live", "/health/live", None),
    ("GET", "health_ready", "/health/ready", None),
    ("GET", "health_system", "/health/system", None),
    ("GET", "health_workers", "/health/workers", None),
    ("GET", "health_jobs", "/health/jobs", None),
    ("GET", "metrics", "/metrics", None),
    ("GET", "admin_slo", "/admin/slo", None),
    ("GET", "admin_capacity", "/admin/capacity", None),
    ("GET", "admin_health_fleet", "/admin/health/fleet", None),
    ("GET", "admin_dump", "/admin/dump", None),
    ("GET", "admin_memory", "/admin/memory", None),
    ("GET", "admin_timeline", "/admin/timeline", None),
    ("GET", "admin_timeline_unknown", "/admin/timeline/nope", None),
    ("GET", "admin_incidents", "/admin/incidents", None),
    ("GET", "admin_trace_unknown", "/admin/trace/nope", None),
    ("GET", "root", "/", None),
    ("GET", "unknown_route", "/nope", None),
]
# /admin/memory reads each runtime's own devices; /metrics is compared by
# series in test_metrics_series_match; the rest of each body is held equal
_BODY_KEYS_ONLY = {"admin_memory", "metrics"}


@pytest.mark.parametrize("method,name,path,body", CASES, ids=[c[1] for c in CASES])
async def test_route_matches_the_jax_gateway(method, name, path, body):
    async def run(st):
        return await st.call(method, path, body)

    (js, jt, jb), (ts, tt, tb) = await _both(run)
    assert (ts, tt) == (js, jt), (tb, jb)
    if name in _BODY_KEYS_ONLY:
        assert type(tb) is type(jb)
        if isinstance(tb, dict):
            assert sorted(tb) == sorted(jb)
        return
    assert scrub(tb) == scrub(jb)


@pytest.mark.parametrize("case", ["malformed_json", "body_too_large", "rate_limited",
                                  "rate_limited_fleet", "profile_without_engine"])
async def test_error_case_matches_the_jax_gateway(case, monkeypatch):
    """The error answers that need a request the table cannot send."""
    # a JAX gateway in a process without a device runtime refuses captures;
    # the port's gateway never holds an engine
    monkeypatch.setattr(jperf, "jax_loaded", lambda: False)
    limit = 2 if case.startswith("rate_limited") else 10_000
    scope = "fleet" if case == "rate_limited_fleet" else "replica"

    async def run(st):
        if case == "malformed_json":
            return [await st.call("POST", "/api/generate", raw=b"{not json")]
        if case == "body_too_large":
            return [await st.call("POST", "/api/generate",
                                  {**GEN, "prompt": "x" * (MAX_BODY + 1)})]
        if case.startswith("rate_limited"):
            out = [await st.call("GET", "/api/tags") for _ in range(3)]
            _, _, metrics = await st.call("GET", "/metrics")
            return out + [(200, "", [ln for ln in metrics.splitlines()
                                     if ln.startswith("gridllm_ratelimit_rejections_total{")])]
        return [await st.call("POST", "/admin/profile?seconds=1")]

    jax_out, torch_out = await _both(run, rate_limit=limit, scope=scope)
    expect = {"malformed_json": [400], "body_too_large": [413],
              "rate_limited": [200, 200, 429, 200], "rate_limited_fleet": [200, 200, 429, 200],
              "profile_without_engine": [501]}[case]
    assert [s for s, _, _ in torch_out] == [s for s, _, _ in jax_out] == expect
    for (ts, tt, tb), (js, jt, jb) in zip(torch_out, jax_out):
        assert tt == jt
        if case == "profile_without_engine":
            # the same refusal, worded for the port's runtime: both name the
            # worker health port, whose route takes the capture
            assert tb == {"code": "NO_ENGINE", "error": "no engine in this process — POST "
                          "the worker health port's /admin/profile for an engine-side capture"}
            assert jb["code"] == "NO_JAX_RUNTIME" and "worker health port" in jb["error"]
        else:
            assert scrub(tb) == scrub(jb)
    if case.startswith("rate_limited"):
        assert any(f'scope="{scope}"' in ln for ln in torch_out[-1][2])


async def test_metrics_series_match():
    """The scheduler registry's series on /metrics (names, labels and the
    counters' values) after the same requests, gateway request counts by
    route and status among them."""

    async def run(st):
        for method, _, path, body in CASES[:12] + CASES[-8:]:
            if path != "/metrics":
                await st.call(method, path, body)
        _, _, text = await st.call("GET", "/metrics")
        own = {ln.split(" ")[2] for ln in st.scheduler.metrics.render().splitlines()
               if ln.startswith("# TYPE")}
        series = {}
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            key, value = line.rsplit(" ", 1)
            name = key.split("{", 1)[0]
            family = name.removesuffix("_bucket").removesuffix("_sum").removesuffix("_count")
            if family not in own and name not in own:
                continue
            if name.endswith(("_bucket", "_sum")) or name == "gridllm_watchdog_sweeps_total":
                continue
            series[key] = float(value) if name.endswith(("_total", "_count")) else "gauge"
        return series

    jax_series, torch_series = await _both(run)
    assert torch_series == jax_series
    assert any(k.startswith("gridllm_gateway_requests_total{") and 'status="404"' in k
               for k in torch_series)


async def test_trace_and_streams_match():
    """/admin/trace/{id} span names and sources of one /inference request,
    and the NDJSON and SSE frames of the streamed routes."""

    async def run(st):
        _, _, res = await st.call("POST", "/inference", {"model": "m1", "prompt": "trace me"})
        await st.bus.flush()
        _, _, trace = await st.call("GET", f"/admin/trace/{res['id']}")
        streams = [await st.call("POST", path, body) for path, body in (
            ("/api/generate", {**GEN, "stream": True}), ("/api/chat", {**CHAT, "stream": True}),
            ("/v1/chat/completions", {**OAI_CHAT, "stream": True}),
            ("/v1/completions", {**OAI_COMP, "stream": True, "echo": True}))]
        return (sorted(s["name"] for s in trace["spans"]), trace["sources"],
                [(s, t, scrub(b)) for s, t, b in streams])

    (j_spans, j_src, j_streams), (t_spans, t_src, t_streams) = await _both(run)
    assert (t_spans, t_src) == (j_spans, j_src)
    assert "gateway.request" in t_spans and "scheduler.dispatch" in t_spans
    assert t_streams == j_streams
    assert [len(b) for _, _, b in t_streams] == [4, 4, 5, 5]
    assert t_streams[2][2][-1] == "[DONE]"


async def test_timeline_and_incidents_match():
    """With the timeline armed (as GatewayServer arms it): the event names
    of one request's /admin/timeline/{id} slice in causal order, the
    window's members, and the incident reports."""

    async def run(st):
        _, _, res = await st.call("POST", "/inference", {"model": "m1", "prompt": "when"})
        _, _, one = await st.call("GET", f"/admin/timeline/{res['id']}")
        _, _, window = await st.call("GET", "/admin/timeline?limit=0")
        _, _, inc = await st.call("GET", "/admin/incidents")
        return ([e["name"] for e in one["events"]], one["members"], window["members"],
                inc["incidents"])

    want, got = await _both(run, timeline=True)
    assert got == want
    assert "bus.send" in got[0] and got[1] == ["local"]


@pytest.fixture(scope="module")
def engine():
    return TEngine(TConfig(**TINY), device="cpu")


async def test_tiny_engine_texts_match_through_both_gateways(engine):
    """A port worker on one tiny-llama float32 engine behind each gateway:
    the same texts and eval counts on every generation route."""

    def worker(bus):
        return TWorker(bus, {MODEL: engine}, TWorkerConfig(
            worker_id="tw", heartbeat_interval_ms=150, resource_monitor_interval_ms=500),
            stream_flush_ms=5)

    async def run(st):
        out = {}
        for name, path, body in (
            ("generate", "/api/generate",
             {"model": MODEL, "prompt": "hello there", "stream": False, "options": GREEDY}),
            ("chat", "/api/chat", {"model": MODEL, "stream": False, "options": GREEDY,
                                   "messages": [{"role": "user", "content": "hi there"}]}),
            ("generate_stream", "/api/generate",
             {"model": MODEL, "prompt": "stream me", "options": GREEDY}),
            ("chat_stream", "/api/chat", {"model": MODEL, "options": GREEDY,
                                          "messages": [{"role": "user", "content": "a chat"}]}),
            ("v1_chat", "/v1/chat/completions",
             {"model": MODEL, "max_tokens": 8, "temperature": 0,
              "messages": [{"role": "user", "content": "openai facade"}]}),
            ("v1_completions", "/v1/completions",
             {"model": MODEL, "prompt": "complete this", "max_tokens": 8, "temperature": 0}),
        ):
            status, _, b = await st.call("POST", path, body)
            assert status == 200, b
            if name.endswith("_stream"):
                key = "response" if name.startswith("generate") else "message"
                parts = [(f.get(key) or "") if key == "response"
                         else (f.get(key) or {}).get("content", "") for f in b[:-1]]
                out[name] = ("".join(parts), b[-1]["eval_count"])
            elif name == "v1_chat":
                out[name] = (b["choices"][0]["message"]["content"],
                             b["usage"]["completion_tokens"])
            elif name == "v1_completions":
                out[name] = (b["choices"][0]["text"], b["usage"]["completion_tokens"])
            else:
                out[name] = (b.get("response") or b["message"]["content"], b["eval_count"])
        for _ in range(3000):
            if not engine.active_requests and not engine.queued_requests:
                break
            await asyncio.sleep(0.01)
        return out

    want, got = await _both(run, worker=worker)
    assert got == want
    assert got["generate"][1] == GREEDY["num_predict"] and all(t for t, _ in got.values())


_GATEWAY_ENV = {
    "HOST": "127.0.0.1", "PORT": "4123", "RATE_LIMIT_WINDOW_MS": "60000",
    "RATE_LIMIT_MAX_REQUESTS": "7", "RATE_LIMIT_ENABLED": "false",
    "GRIDLLM_RATELIMIT_SCOPE": "fleet", "GRIDLLM_ENFORCE_KEEP_ALIVE": "1",
    "GRIDLLM_TIMELINE_STORE": "99", "GRIDLLM_TIMELINE_REQUESTS": "12",
    "GRIDLLM_TIMELINE_INCIDENT_WINDOW_MS": "2500", "GRIDLLM_TIMELINE_INCIDENTS": "5",
    "GRIDLLM_CONTROLPLANE": "gateway", "NODE_ENV": "production",
}


@pytest.mark.parametrize("env", [{}, _GATEWAY_ENV], ids=["defaults", "set"])
def test_load_config_gateway_names_match(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = jconfig.load_config(), tconfig.load_config()
    assert dataclasses.asdict(t.gateway) == j.gateway.model_dump()
    assert dataclasses.asdict(t.obs.timeline) == j.obs.timeline.model_dump()
    assert (t.controlplane.mode, t.env) == (j.controlplane.mode, j.env)


@pytest.mark.parametrize("name,value", [
    ("PORT", "http"), ("RATE_LIMIT_MAX_REQUESTS", "1.5"), ("GRIDLLM_RATELIMIT_SCOPE", "global"),
    ("GRIDLLM_TIMELINE_STORE", "0"), ("GRIDLLM_TIMELINE_INCIDENT_WINDOW_MS", "-1"),
    ("GRIDLLM_ENFORCE_KEEP_ALIVE", "maybe"), ("GRIDLLM_CONTROLPLANE", "mesh"),
])
def test_load_config_refuses_what_jax_refuses(name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    with pytest.raises(SystemExit):
        jconfig.load_config()
    with pytest.raises(SystemExit):
        tconfig.load_config()


def test_gateway_controlplane_mode_is_refused(monkeypatch):
    monkeypatch.setenv("GRIDLLM_CONTROLPLANE", "gateway")
    with pytest.raises(NotImplementedError, match="ROADMAP A 10 3"):
        tapp.GatewayServer(bus=tbus.InMemoryBus())


_NO_JAX = """
import asyncio, importlib.abc, json, sys
BLOCKED = ("jax", "jaxlib", "gridllm_tpu", "pydantic")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import aiohttp
from gridllm_torch.bus import InMemoryBus
from gridllm_torch.engine import EngineConfig, InferenceEngine
from gridllm_torch.gateway import GatewayServer
from gridllm_torch.utils.config import Config, WorkerConfig
from gridllm_torch.worker.service import WorkerService

async def main():
    config = Config()
    config.gateway.host = "127.0.0.1"
    server = GatewayServer(config, bus=InMemoryBus())
    port = await server.start(0)
    engine = InferenceEngine(EngineConfig(model="tiny-llama", max_slots=2, page_size=8,
                                          num_pages=64, max_pages_per_slot=16,
                                          prefill_buckets=(16, 64), dtype="float32"),
                             device="cpu")
    worker = WorkerService(server.bus, {"tiny-llama": engine},
                           WorkerConfig(worker_id="w", heartbeat_interval_ms=150))
    await worker.start()
    while server.registry.get_worker("w") is None:
        await asyncio.sleep(0.01)
    base = f"http://127.0.0.1:{port}"
    async with aiohttp.ClientSession() as session:
        async with session.get(base + "/health") as r:
            assert r.status == 200 and (await r.json())["status"] == "healthy"
        async with session.post(base + "/api/generate", json={
                "model": "tiny-llama", "prompt": "hello", "stream": False,
                "options": {"temperature": 0, "num_predict": 4}}) as r:
            body = await r.json()
            assert r.status == 200 and body["eval_count"] == 4, body
    while engine.active_requests or engine.queued_requests:
        await asyncio.sleep(0.01)
    await worker.stop(announce=False)
    await server.shutdown()
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("SERVED", json.dumps(body["response"]))

asyncio.run(main())
"""


def test_gateway_serves_in_a_process_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SERVED" in proc.stdout
