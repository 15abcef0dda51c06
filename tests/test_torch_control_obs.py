"""The control plane's obs modules and placement controller of the port
against the JAX package's, on the same inputs.

Every module that reads the clock gets one fake clock (its module's `time`
replaced by `FakeTime`), so both sides see the same instants. Outputs are
compared exactly, apart from floating-point EWMAs, z-scores and rates,
which are held at 1e-12 relative:

- `classify_request`; `SLOEngine` attainment, burn rates and goodput over
  one outcome stream, and its metric series;
- `HangWatchdog` verdicts over one phase timeline of a stub scheduler;
- `HealthMonitor` state transitions over one series of ITL, heartbeat and
  canary samples, with the `health.baseline` fault site dropping one;
- `CanaryProber` golden-hash verdicts (seal, pass, drift, fail, the
  `probe.issue` fault site) and the health verdicts they drive;
- `DemandTracker` snapshots and scale hints, `aggregate_worker_capacity`,
  `dedup_capacity_totals` and `merge_capacity`;
- `UsageAccountant` ledgers, `resolve_tenant` and `TenantLRU`;
- `critical_path`;
- `ModelPlacementController` plans over one demand and fleet script.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import math
from types import SimpleNamespace

import pytest

import gridllm_torch.bus.base as tbase
import gridllm_torch.bus.memory as tmemory
import gridllm_torch.faults as tfaults
import gridllm_torch.obs as tobs
import gridllm_torch.obs.capacity as tcapacity
import gridllm_torch.obs.flightrec as tflightrec
import gridllm_torch.obs.health as thealth
import gridllm_torch.obs.probe as tprobe
import gridllm_torch.obs.slo as tslo
import gridllm_torch.obs.timeline as ttimeline
import gridllm_torch.obs.tracer as ttracer
import gridllm_torch.obs.usage as tusage
import gridllm_torch.obs.watchdog as twatchdog
import gridllm_torch.scheduler.placement as tplacement
import gridllm_torch.utils.config as tconfig
import gridllm_torch.utils.types as ttypes
import gridllm_tpu.bus.base as jbase
import gridllm_tpu.bus.memory as jmemory
import gridllm_tpu.faults as jfaults
import gridllm_tpu.obs as jobs
import gridllm_tpu.obs.capacity as jcapacity
import gridllm_tpu.obs.flightrec as jflightrec
import gridllm_tpu.obs.health as jhealth
import gridllm_tpu.obs.probe as jprobe
import gridllm_tpu.obs.slo as jslo
import gridllm_tpu.obs.timeline as jtimeline
import gridllm_tpu.obs.tracer as jtracer
import gridllm_tpu.obs.usage as jusage
import gridllm_tpu.obs.watchdog as jwatchdog
import gridllm_tpu.scheduler.placement as jplacement
import gridllm_tpu.utils.config as jconfig
import gridllm_tpu.utils.types as jtypes

RTOL = 1e-12   # floating-point EWMAs, z-scores and rates

SIDES = {
    "jax": SimpleNamespace(obs=jobs, slo=jslo, watchdog=jwatchdog, health=jhealth,
                           probe=jprobe, capacity=jcapacity, usage=jusage,
                           timeline=jtimeline, tracer=jtracer, flightrec=jflightrec,
                           placement=jplacement, config=jconfig, types=jtypes,
                           faults=jfaults, base=jbase, memory=jmemory),
    "torch": SimpleNamespace(obs=tobs, slo=tslo, watchdog=twatchdog, health=thealth,
                             probe=tprobe, capacity=tcapacity, usage=tusage,
                             timeline=ttimeline, tracer=ttracer, flightrec=tflightrec,
                             placement=tplacement, config=tconfig, types=ttypes,
                             faults=tfaults, base=tbase, memory=tmemory),
}


class FakeTime:
    """Stands in for a module's `time`: every clock reads `now`."""

    def __init__(self, now: float = 1_000.0):
        self.now = now

    def time(self) -> float:
        return self.now

    monotonic = perf_counter = time

    def perf_counter_ns(self) -> int:
        return int(self.now * 1e9)


@pytest.fixture
def clock(monkeypatch):
    fake = FakeTime()
    for side in SIDES.values():
        for mod in (side.slo, side.watchdog, side.health, side.probe, side.capacity,
                    side.tracer, side.flightrec, side.placement):
            monkeypatch.setattr(mod, "time", fake)
    return fake


def close(got, want, path="$"):
    """Equal, with floats at RTOL relative."""
    if isinstance(want, float) and isinstance(got, (int, float)) and not isinstance(got, bool):
        assert math.isclose(got, want, rel_tol=RTOL, abs_tol=1e-300), (path, got, want)
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, got, want)
        for k in want:
            close(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, f"{path}[{i}]")
        return
    assert got == want, (path, got, want)


def series(registry) -> dict:
    """A registry's Prometheus text as {series: value}."""
    out = {}
    for line in registry.render().splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


# -- classify_request and the SLO engine ---------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"stream": True}, {"stream": False}, {"input": "embed me"},
    {"stream": True, "metadata": {"requestType": "embedding"}},
    {"metadata": {"requestType": "chat"}, "stream": True},
])
def test_classify_request(kw):
    got = tslo.classify_request(ttypes.InferenceRequest(id="r", model="m", **kw))
    want = jslo.classify_request(jtypes.InferenceRequest(id="r", model="m", **kw))
    assert got == want


# (dt, class, ok, ttft_s, itl_s, e2e_s, tokens, model)
OUTCOMES = [
    (0.0, "interactive", True, 0.5, 0.05, 3.0, 40, "a"),
    (1.0, "interactive", True, 2.5, 0.05, 3.0, 40, "a"),
    (1.0, "interactive", True, 0.4, 0.30, 9.0, 12, "b"),
    (5.0, "batch", True, None, None, 100.0, 90, "a"),
    (5.0, "batch", True, None, None, 400.0, 90, None),
    (30.0, "batch", False, None, None, None, 0, "b"),
    (200.0, "interactive", True, 1.0, None, 2.0, 1, "a"),
    (250.0, "embedding", True, None, None, 0.5, 0, "e"),
    (1000.0, "unknown", True, 1.0, 1.0, 1.0, 7, "a"),
    (3000.0, "interactive", False, None, None, None, 0, "a"),
]


def _slo_run(side, clock, cfg_kw) -> list:
    config = side.config.SLOConfig(**cfg_kw)
    eng = side.slo.SLOEngine(config, side.obs.MetricsRegistry())
    out = []
    for dt, cls, ok, ttft, itl, e2e, toks, model in OUTCOMES:
        clock.now += dt
        out.append(eng.record(cls, ok=ok, ttft_s=ttft, itl_s=itl, e2e_s=e2e,
                              tokens=toks, model=model))
        out.append(eng.snapshot())
    eng.record_waste(17, "duplicate")
    eng.record_waste(0, "cancelled")
    out.append(eng.record("batch", ok=True, e2e_s=1.0, tokens=3, now=clock.now - 10.0))
    clock.now += 100.0
    out.append(eng.snapshot())
    out.append(series(eng.metrics))
    return out


@pytest.mark.parametrize("cfg", ["defaults", "windows", "disabled"])
def test_slo_engine(cfg, clock):
    cfg_kw = {"defaults": {}, "windows": {"windows_s": [3600, 60, 600]},
              "disabled": {"enabled": False}}[cfg]
    start = clock.now
    want = _slo_run(SIDES["jax"], clock, cfg_kw)
    clock.now = start
    got = _slo_run(SIDES["torch"], clock, cfg_kw)
    close(got, want)


# -- the hang watchdog ----------------------------------------------------------

class _StubRegistry:
    def __init__(self):
        self.handlers = {}

    def on(self, event, fn):
        self.handlers.setdefault(event, []).append(fn)

    def off(self, event, fn):
        self.handlers.get(event, []).remove(fn) if fn in self.handlers.get(event, []) else None

    def get_worker_count(self):
        return {"total": 0}

    def get_all_workers(self):
        return []


class _StubScheduler:
    """What the watchdog reads of a scheduler: queue spans, active jobs,
    stream progress, the tracer and metrics; and what it calls."""

    def __init__(self, side):
        self.side = side
        self.metrics = side.obs.MetricsRegistry()
        self.tracer = side.tracer.Tracer(source="gateway")
        self.registry = _StubRegistry()
        self.slo = side.slo.SLOEngine(side.config.SLOConfig(), self.metrics)
        self._queue_spans = {}
        self.active_jobs = {}
        self._stream_progress = {}
        self.job_queue = []
        self.calls = []

    def get_stats(self):
        return {"activeJobs": len(self.active_jobs)}

    async def publish_cancellation(self, worker_id, job_id, reason):
        self.calls.append(("cancel", worker_id, job_id, reason))

    async def _orphan_job(self, assignment, reason):
        self.calls.append(("orphan", assignment.jobId, reason))
        self.active_jobs.pop(assignment.jobId, None)

    def request_dispatch(self):
        self.calls.append(("dispatch",))


def _assignment(side, job_id, at, **req):
    t = side.types
    return t.JobAssignment(jobId=job_id, workerId=f"w-{job_id}", assignedAt=at,
                           request=t.InferenceRequest(id=job_id, model="m", **req))


async def _watchdog_run(side, clock, requeue):
    t0 = clock.now
    sched = _StubScheduler(side)
    rec = side.flightrec.FlightRecorder(capacity=64)
    cfg = side.config.WatchdogConfig(requeue=requeue, profile_on_hang_s=0.0)
    wd = side.watchdog.HangWatchdog(sched, cfg, recorder=rec)
    sched._queue_spans["q1"] = sched.tracer.begin("q1", "queue.wait")
    sched.tracer.event("q1", "gateway.received")
    sched.active_jobs["plain"] = _assignment(side, "plain", t0)          # never streams
    sched.active_jobs["silent"] = _assignment(side, "silent", t0, stream=True)
    sched.active_jobs["stalled"] = _assignment(side, "stalled", t0, stream=True)
    sched.active_jobs["forced"] = _assignment(side, "forced", t0, stream=True,
                                              format="json")
    sched._stream_progress["stalled"] = (t0 + 1.0, t0 + 2.0)
    out = []
    for at in (30.0, 61.0, 62.0, 63.5, 121.0, 241.0, 242.0):
        clock.now = t0 + at
        acted = await wd.sweep()
        out.append([{k: v for k, v in h.items() if k != "diagnosis"} for h in acted])
        out.append([(h["diagnosis"]["lastSpan"] or {}).get("name") for h in acted])
    out.append(sched.calls)
    out.append(list(wd.hangs and [h["phase"] for h in wd.hangs]))
    out.append(series(sched.metrics)["gridllm_hangs_total{phase=\"decode-step\"}"])
    out.append([{k: v for k, v in e.items()} for e in rec.snapshot()["rings"]["scheduler"]])
    return out


@pytest.mark.parametrize("requeue", [True, False])
async def test_hang_watchdog(requeue, clock):
    start = clock.now
    want = await _watchdog_run(SIDES["jax"], clock, requeue)
    clock.now = start
    got = await _watchdog_run(SIDES["torch"], clock, requeue)
    close(got, want)


def test_watchdog_hang_capture_declines_without_a_capture():
    """A decode-step hang's profiler capture goes through the `capture`
    callable that a process hosting an engine gives; a control-plane
    process gives none and the capture is skipped, as the JAX watchdog
    skips it in an engine-less process."""
    sched = _StubScheduler(SIDES["torch"])
    wd = twatchdog.HangWatchdog(sched, tconfig.WatchdogConfig(profile_on_hang_s=1.0))
    assert asyncio.run(wd._profile_hang("decode-step")) is None


def _stalled_job(sched, clock):
    sched.active_jobs["stalled"] = _assignment(SIDES["torch"], "stalled", clock.now,
                                               stream=True)
    sched._stream_progress["stalled"] = (clock.now + 1.0, clock.now + 2.0)
    clock.now += 200.0   # past the decode-stall deadline


@pytest.mark.parametrize("stuck", ["runner", "other-runner", "capture"])
async def test_watchdog_requeues_past_a_stuck_capture(stuck, clock):
    """A decode-step hang whose capture cannot be taken (a runner of the
    process held inside a step, or a capture callable that never returns)
    is still requeued, its diagnosis without a profile; the capture gives
    up within its bounds and the held runners serve on."""
    import threading

    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine
    from gridllm_torch.engine import engine as engine_mod
    from gridllm_torch.obs.perf import capture_profile

    release = threading.Event()
    engines = []
    if stuck == "capture":
        def capture(_seconds, _reason):
            release.wait(30)
            return {"late": True}
    else:
        cfg = EngineConfig(model="tiny-llama", max_slots=2, page_size=8, num_pages=32,
                           max_pages_per_slot=8, prefill_buckets=(16,), prefill_chunk=16,
                           dtype="float32", seed=1)
        held = InferenceEngine(cfg, device="cpu")
        engines.append(held)
        if stuck == "other-runner":
            engines.append(InferenceEngine(cfg, device="cpu"))
        inside = threading.Event()
        pump = held._pump_once

        def held_pump():
            inside.set()
            release.wait(30)
            pump()

        held._pump_once = held_pump
        for e in engines:
            e.start()
        done = threading.Event()
        held.submit(GenerationRequest(id="held", prompt="ab ab", options={"num_predict": 2},
                                      on_chunk=lambda _d, fin, _r: fin and done.set()))
        assert inside.wait(10)

        def capture(seconds, reason):
            return capture_profile(engines[-1], seconds, reason, start_timeout_s=0.5)

    sched = _StubScheduler(SIDES["torch"])
    wd = twatchdog.HangWatchdog(sched, tconfig.WatchdogConfig(profile_on_hang_s=0.1),
                                recorder=tflightrec.FlightRecorder(capacity=8),
                                capture=capture)
    wd.capture_grace_s = 2.0
    _stalled_job(sched, clock)
    try:
        acted = await asyncio.wait_for(wd.sweep(), 10)
        assert [h["phase"] for h in acted] == ["decode-step"]
        assert "profile" not in acted[0]["diagnosis"]
        assert ("orphan", "stalled", "hang") in sched.calls
        assert not engine_mod._GATE._switching
    finally:
        release.set()
    if engines:
        assert done.wait(30)     # the held runner serves on
        for e in engines:
            e.stop()


# -- health monitor and canary prober -------------------------------------------

class _RecBus:
    def __init__(self):
        self.sent = []

    async def publish(self, channel, message):
        self.sent.append((channel, json.loads(message)))


class _RecRegistry:
    def __init__(self, workers=()):
        self.applied = []
        self.workers = list(workers)

    def apply_health_state(self, worker_id, state):
        self.applied.append((worker_id, state))

    def get_all_workers(self):
        return self.workers


async def _settle():
    for _ in range(5):
        await asyncio.sleep(0)


async def _health_run(side, clock):
    bus, reg = _RecBus(), _RecRegistry()
    metrics = side.obs.MetricsRegistry()
    mon = side.health.HealthMonitor(bus, reg, metrics, member="m0")
    side.faults.configure("health.baseline=@9", seed=0)
    out = []
    try:
        for i in range(8):                       # steady heartbeats, then a gap
            clock.now += 1.0 if i < 7 else 9.0
            mon.note_heartbeat("w1")
        for itl in (0.02, 0.021, 0.019, 0.02, 0.022, 0.02, 0.5):
            clock.now += 0.5
            mon.note_itl("w2", itl)
        out.append(mon.snapshot())
        for wid, ok, e2e, drift in [
            ("w1", True, 1.0, False), ("w1", True, 1.1, False), ("w1", True, 0.9, False),
            ("w1", True, 1.0, False), ("w1", True, 1.05, False), ("w1", True, 1.0, False),
            ("w1", True, 0.95, False), ("w1", True, 1.45, False), ("w1", True, 9.0, False),
            ("w1", False, 2.0, False), ("w1", True, 1.0, False), ("w1", True, 1.0, False),
            ("w2", True, 1.0, False), ("w2", False, 1.0, False), ("w2", False, 1.0, False),
            ("w2", False, 1.0, False), ("w3", True, 1.0, True),
        ]:
            clock.now += 2.0
            mon.note_canary(wid, ok=ok, e2e_s=e2e, drift=drift)
            w = mon.snapshot()["workers"][wid]
            out.append((wid, w["state"], w["strikes"], w["passes"], w["reason"]))
        mon.note_registered("w3", status="draining")
        out.append(mon.state_of("w3"))
        mon.note_registered("w3")
        out.append(mon.state_of("w3"))
        for ok in (True, True, False, True, True):
            clock.now += 2.0
            mon.note_canary("w3", ok=ok, e2e_s=1.0)
            out.append(mon.state_of("w3"))
        await _settle()
    finally:
        side.faults.configure(None)
    out.append(mon.snapshot())
    out.append(mon.counts())
    out.append(reg.applied)
    out.append(bus.sent)
    out.append(series(metrics))
    return out


async def test_health_monitor(clock):
    start = clock.now
    want = await _health_run(SIDES["jax"], clock)
    clock.now = start
    got = await _health_run(SIDES["torch"], clock)
    close(got, want)


def _worker(side, wid, models, *, status="online", capacity=None, cfg_hash="h1"):
    t = side.types
    return t.WorkerInfo(
        workerId=wid, status=status,
        capabilities=t.NodeCapabilities(
            workerId=wid, availableModels=[
                t.ModelInfo(name=m, details={"engineConfigHash": cfg_hash}) for m in models]),
        modelCapacity=capacity or {})


class _ScriptedScheduler:
    """submit_and_wait answers from a script: a text, a failure or an
    exception, each after `e2e` seconds of the fake clock."""

    def __init__(self, side, clock, script):
        self.side, self.clock, self.script = side, clock, list(script)
        self.requests = []

    async def submit_and_wait(self, request, timeout_ms):
        self.requests.append({k: v for k, v in json.loads(request.model_dump_json()).items()
                              if k != "id"})
        kind, value, e2e = self.script.pop(0)
        self.clock.now += e2e
        if kind == "raise":
            raise TimeoutError("scripted")
        t = self.side.types
        if kind == "fail":
            return t.JobResult(jobId=request.id, workerId="x", success=False, error=value)
        return t.JobResult(jobId=request.id, workerId="x", success=True,
                           response=t.InferenceResponse(id=request.id, response=value))


async def _probe_run(side, clock, monkeypatch):
    monkeypatch.setenv("GRIDLLM_HEALTH_MIN_SAMPLES", "2")
    w1 = _worker(side, "w1", ["m", "e"], capacity={"m": {"slotsFree": 1}})
    w2 = _worker(side, "w2", ["m"], cfg_hash="h2")
    w3 = _worker(side, "w3", ["m"], status="draining")
    reg = _RecRegistry([w1, w2, w3])
    metrics = side.obs.MetricsRegistry()
    health = side.health.HealthMonitor(_RecBus(), reg, metrics, member="m0")
    script = [("ok", "song", 1.0), ("ok", "song", 1.0), ("ok", "song", 1.1),
              ("ok", "other", 1.0), ("fail", "boom", 0.5), ("raise", None, 3.0),
              ("ok", "song", 1.0), ("ok", "tune", 1.0), ("ok", "song", 50.0)]
    sched = _ScriptedScheduler(side, clock, script)
    prober = side.probe.CanaryProber(sched, reg, health, metrics)
    side.faults.configure("probe.issue=@6", seed=0)
    out = [[(w.workerId, m) for w, m in prober._targets()]]
    try:
        for wid in ("w1", "w1", "w1", "w1", "w1", "w1", "w1", "w2", "w2", "w1"):
            w = {"w1": w1, "w2": w2}[wid]
            out.append(await prober.probe_once(w, "m"))
            out.append(health.state_of(wid))
        await _settle()
    finally:
        side.faults.configure(None)
    out.append(sorted(prober.goldens.items()))
    out.append(prober.summary())
    out.append(sched.requests)
    out.append(health.snapshot())
    out.append(series(metrics))
    return out


async def test_canary_prober(clock, monkeypatch):
    start = clock.now
    want = await _probe_run(SIDES["jax"], clock, monkeypatch)
    clock.now = start
    got = await _probe_run(SIDES["torch"], clock, monkeypatch)
    close(got, want)


# -- capacity -------------------------------------------------------------------

def _fleet(side):
    workers = [
        _worker(side, "w1", ["a", "b"], capacity={
            "a": {"slotsFree": 2, "slotsTotal": 8, "kvPagesFree": 100, "engine": 7},
            "b": {"slotsFree": 2, "slotsTotal": 8, "kvPagesFree": 100, "engine": 7}}),
        _worker(side, "w2", ["a"], capacity={
            "a": {"slotsFree": 0, "slotsTotal": 4, "kvPagesFree": 3}}),
        _worker(side, "w3", ["c"], capacity={"c": {"slotsFree": 4, "slotsTotal": 4}}),
    ]
    workers[2].modelCapacity["bad"] = "not a block"   # skipped by both
    return workers


def _capacity_run(side, clock):
    workers = _fleet(side)
    queues = {"a": 3, "d": 2}
    metrics = side.obs.MetricsRegistry()
    tracker = side.capacity.DemandTracker(
        metrics, halflife_s=30.0, queue_depths=lambda: queues,
        worker_capacity=lambda: side.capacity.aggregate_worker_capacity(workers),
        pool_totals=lambda: side.capacity.dedup_capacity_totals(workers))
    out = [side.capacity.aggregate_worker_capacity(workers),
           side.capacity.dedup_capacity_totals(workers)]
    snaps = []
    for dt, model, what, value in [
        (0.0, "a", "arrival", 0), (0.5, "a", "arrival", 0), (1.0, "a", "dispatch", 0.4),
        (2.0, "b", "arrival", 0), (2.0, "a", "completion", 3.0), (10.0, "c", "arrival", 0),
        (45.0, "a", "arrival", 0), (0.1, "b", "dispatch", 12.0), (0.1, "b", "completion", 8.0),
    ]:
        clock.now += dt
        getattr(tracker, f"note_{what}")(model, *([value] if what != "arrival" else []))
        snaps.append(tracker.snapshot())
    clock.now += 120.0
    snaps.append(tracker.snapshot())
    out += snaps
    out.append(side.capacity.merge_capacity([snaps[4], snaps[-1], {}]))
    out.append(series(metrics))
    return out


def test_demand_tracker_and_merge(clock):
    start = clock.now
    want = _capacity_run(SIDES["jax"], clock)
    clock.now = start
    got = _capacity_run(SIDES["torch"], clock)
    close(got, want)


# -- usage ----------------------------------------------------------------------

HEADERS = [
    {}, {"X-GridLLM-Tenant": "acme corp!"}, {"x-gridllm-tenant": "lower"},
    {"Authorization": "Bearer k1"}, {"authorization": "Bearer k2"},
    {"X-Team": "t9", "Authorization": "Bearer k1"}, {"X-GridLLM-Tenant": "  "},
    {"X-GridLLM-Tenant": "x" * 100},
]


@pytest.mark.parametrize("header", ["", "X-Team"])
def test_resolve_tenant(header, monkeypatch):
    if header:
        monkeypatch.setenv("GRIDLLM_TENANT_HEADER", header)
    assert ([tusage.resolve_tenant(h) for h in HEADERS]
            == [jusage.resolve_tenant(h) for h in HEADERS])


def _usage_run(side):
    lru = side.usage.TenantLRU(3)
    labels = [lru.label(t) for t in ("a", "b", "", "c", "a", "d", "b")]
    metrics = side.obs.MetricsRegistry()
    acct = side.usage.UsageAccountant(metrics, lru_cap=2)
    for tenant, model, outcome, kw in [
        ("t1", "m1", "completed", dict(prompt_tokens=10, output_tokens=5,
                                       prefix_saved_tokens=4, decode_device_s=0.25)),
        ("t2", "m1", "completed", dict(prompt_tokens=3, output_tokens=9, kv_page_s=1.5,
                                       migrated_bytes=4096)),
        ("t3", "m2", "duplicate", dict(prompt_tokens=1, output_tokens=1,
                                       spec_wasted_tokens=2)),
        ("canary", "m1", "completed", dict(prompt_tokens=8, output_tokens=8)),
        ("", "m2", "completed", dict(prompt_tokens=2, output_tokens=0)),
    ]:
        acct.account(side.usage.build_usage(tenant=tenant, model=model, **kw), outcome)
    acct.account(None, "completed")
    acct.note_outcome("t1", "m1", "failed")
    acct.note_outcome("canary", "m1", "failed")
    acct.note_outcome("t9", "", "shed")
    return [labels, acct.snapshot(), acct.token_totals(), series(metrics)]


def test_usage_accountant():
    close(_usage_run(SIDES["torch"]), _usage_run(SIDES["jax"]))


# -- critical path --------------------------------------------------------------

def _span(name, start, end, **meta):
    return {"name": name, "source": "x", "start": start, "end": end, "meta": meta}


PATHS = {
    "unsealed": [_span("gateway.request", 0.0, None)],
    "empty": [_span("gateway.request", 5.0, 5.0)],
    "plain": [_span("gateway.request", 0.0, 10.0), _span("queue.wait", 0.0, 1.5),
              _span("worker.execute", 2.0, 9.5), _span("engine.prefill", 2.1, 3.0),
              _span("engine.decode", 3.0, 9.4, engineNs=4.2e9)],
    "migration": [_span("gateway.request", 0.0, 20.0), _span("queue.wait", 0.0, 2.0),
                  _span("worker.execute", 2.5, 8.0), _span("engine.prefill", 2.5, 6.0),
                  _span("engine.prefill_export", 5.0, 7.0), _span("kvx.send", 6.5, 8.5),
                  _span("kvx.import", 8.0, 9.0), _span("worker.execute", 9.5, 19.0),
                  _span("engine.decode", 9.5, 18.7, engineNs=1.2e10),
                  _span("queue.wait", 30.0, 31.0), _span("engine.decode", 1.0, None)],
    "resumed": [_span("gateway.request", 100.0, 130.0), _span("worker.execute", 101.0, 110.0),
                _span("engine.decode", 101.0, 110.0, engineNs=3e9),
                _span("queue.wait", 112.0, 115.0), _span("worker.execute", 116.0, 129.0),
                _span("engine.decode", 116.0, 128.0, engineNs=1e9)],
}


@pytest.mark.parametrize("name", list(PATHS))
def test_critical_path(name):
    assert tobs.CRITICAL_PATH_SEGMENTS == jobs.CRITICAL_PATH_SEGMENTS
    want = jobs.critical_path(PATHS[name])
    got = tobs.critical_path(PATHS[name])
    if want is None:
        assert got is None
    else:
        close(got, want)


# -- the model placement controller ----------------------------------------------

class _Capacity:
    def __init__(self):
        self.models = {}

    def snapshot(self):
        return {"models": self.models}


class _PlacementRegistry:
    def __init__(self, workers):
        self.workers = workers

    def get_workers_with_model(self, model):
        return [w for w in self.workers if model in w.model_names()]

    def get_online_workers(self):
        return [w for w in self.workers if w.status in ("online", "busy")]


async def _placement_run(side, clock, monkeypatch):
    for k, v in {"GRIDLLM_PLACEMENT_INTERVAL_MS": "1000", "GRIDLLM_MODEL_IDLE_TTL_MS": "5000",
                 "GRIDLLM_SWAP_COOLDOWN_MS": "2000",
                 "GRIDLLM_MODEL_FLOORS": "f=1,bad,g=x"}.items():
        monkeypatch.setenv(k, v)
    bus = side.memory.InMemoryBus(key_prefix="P:")
    await bus.connect()
    workers = [_worker(side, "w1", ["a", "b"]), _worker(side, "w2", ["a"]),
               _worker(side, "w3", [])]
    workers[1].decodeSlotsFree = 4
    registry = _PlacementRegistry(workers)
    ops = []
    answers = itertools.chain(["ok", "declined", "ok", "error"], itertools.repeat("ok"))
    monkeypatch.setattr(side.placement, "OP_TIMEOUT_S", 5.0)

    async def admin(_ch, raw):
        msg = json.loads(raw)
        ops.append({k: v for k, v in msg.items() if k != "id"})
        answer = next(answers)
        await bus.publish(side.base.admin_result_channel(msg["id"]), json.dumps(
            {"workerId": msg["workerId"], "ok": answer == "ok",
             "detail": "declined: busy" if answer == "declined" else answer}))

    await bus.subscribe(side.base.CH_WORKER_ADMIN, admin)
    cap = _Capacity()
    dispatches = []
    sched = SimpleNamespace(capacity=cap, request_dispatch=lambda: dispatches.append(clock.now))
    metrics = side.obs.MetricsRegistry()
    ctl = side.placement.ModelPlacementController(sched, registry, bus, metrics)
    out = [ctl.enabled, ctl.floors]
    for dt, models, unserved in [
        (0.0, {"a": {"queueDepth": 0, "arrivalRate": 0.5, "utilization": 0.5},
               "b": {"queueDepth": 0}}, None),
        (1.0, {"a": {"queueDepth": 4, "scaleHint": 1}, "c": {"queueDepth": 2}}, "e"),
        (1.0, {"a": {"queueDepth": 4, "scaleHint": 1}, "c": {"queueDepth": 2}}, None),
        (3.0, {"a": {"queueDepth": 4, "scaleHint": 2}, "b": {}}, None),
        (6.0, {"a": {}, "b": {}}, None),
        (6.0, {"a": {}, "b": {}}, None),
    ]:
        clock.now += dt
        cap.models = models
        if unserved:
            ctl.note_unserved(unserved)
        await ctl.tick()
        await bus.flush()
        out.append(list(ops))
    out.append(len(dispatches))
    out.append(series(metrics))
    await bus.disconnect()
    return out


async def test_placement_controller(clock, monkeypatch):
    start = clock.now
    want = await _placement_run(SIDES["jax"], clock, monkeypatch)
    clock.now = start
    got = await _placement_run(SIDES["torch"], clock, monkeypatch)
    close(got, want)
    assert len(want[-3]) >= 4   # the script issued loads and unloads
