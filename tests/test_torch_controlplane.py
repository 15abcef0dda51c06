"""The port's scaled control plane against the JAX package's.

Each scenario of tests/test_controlplane.py runs twice at once: on a JAX
fleet (the JAX shards, gateway submitters, leases and fleet view on the
JAX InMemoryBus, with tests/helpers.py's `FakeWorker`) and on a port
fleet (the same on the port's bus, with tests/test_torch_scheduler.py's
`TFakeWorker`). Job ids come from one seeded generator per scenario, so
both fleets partition the same ids the same way. Each side returns what a
client and an operator see (streams, results, `get_stats()` shard
identity, lease epochs and records, orphan, assignment and submit
counts), and the two are held equal; the JAX test's own assertions hold
on both.

Beyond those: `shard_of` bit-equal to the JAX mapping for 10,000 ids at
M = 1..8; a mixed fleet over the port's broker in which a port shard and a
JAX shard share `shard_leases` and each adopts the other's partition
after a kill, the epoch bumped; and the port's broker, one shard and one
gateway replica started through their `python -m` entry points with jax,
jaxlib, gridllm_tpu and pydantic blocked, in front of a port worker on
tiny-llama on the CPU, serving one request.

Lease timers are the JAX tests' 400/80 ms. Where a scenario must not see
an adoption (the lost-lease view), both sides run it under a TTL that
cannot run out inside it, and the scenarios wait on conditions, not on
fixed sleeps, wherever a timer races the check.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from .helpers import FakeWorker, fast_config
from .test_torch_guard import _RUN_MODULE, BLOCKED
from .test_torch_scheduler import TFakeWorker

REPO = Path(__file__).resolve().parents[1]
TOKENS = [f"tok{i} " for i in range(40)]


def _side(pkg: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    cfg = imp("utils.config")
    torch_side = pkg == "gridllm_torch"

    def fast():
        c = fast_config()
        if not torch_side:
            return c
        return cfg.SchedulerConfig(**{f: getattr(c, f) for f in type(c).model_fields})

    client, lease, part = imp("controlplane.client"), imp("controlplane.lease"), \
        imp("controlplane.partition")
    shard, status, smod = imp("controlplane.shard"), imp("controlplane.status"), \
        imp("scheduler.scheduler")
    return SimpleNamespace(
        pkg=pkg, InMemoryBus=imp("bus").InMemoryBus, GatewaySubmitter=client.GatewaySubmitter,
        LEASES_KEY=lease.LEASES_KEY, ShardLeaseManager=lease.ShardLeaseManager,
        ShardContext=part.ShardContext, shard_of=part.shard_of,
        SchedulerShard=shard.SchedulerShard, wait_for_ownership=shard.wait_for_ownership,
        FleetView=status.FleetView, StatusPublisher=status.StatusPublisher,
        WorkerRegistry=imp("scheduler").WorkerRegistry, JobScheduler=smod.JobScheduler,
        shard_queue_key=smod.shard_queue_key, shard_active_key=smod.shard_active_key,
        cfg=cfg, types=imp("utils.types"), obs=imp("obs"),
        FakeWorker=TFakeWorker if torch_side else FakeWorker, fast=fast)


JAX, TORCH = _side("gridllm_tpu"), _side("gridllm_torch")


async def _both(scenario, **kw):
    """(JAX observables, port observables), both fleets run at once."""
    return await asyncio.gather(scenario(JAX, **kw), scenario(TORCH, **kw))


async def _until(cond, timeout_s: float = 10.0, interval: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return cond()


class _Ids:
    """Job ids from a seeded generator: both sides draw the same ids."""

    def __init__(self, S, seed: int):
        self.S, self.rng = S, random.Random(seed)

    def __call__(self, idx: int, num_shards: int = 2) -> str:
        while True:
            jid = f"job-{self.rng.getrandbits(40):010x}"
            if self.S.shard_of(jid, num_shards) == idx:
                return jid


def req(S, job_id: str, model: str = "m1", **kw):
    return S.types.InferenceRequest(id=job_id, model=model, prompt="hi",
                                    priority=S.types.Priority.medium, **kw)


def cp_config(S, shard_id: int, num_shards: int = 2, ttl_ms: int = 400, renew_ms: int = 80):
    return S.cfg.ControlPlaneConfig(mode="gateway", num_shards=num_shards, shard_id=shard_id,
                                    lease_ttl_ms=ttl_ms, renew_interval_ms=renew_ms,
                                    status_interval_ms=100)


async def make_fleet(S, bus, num_shards: int = 2, gateways: int = 2, ttl_ms: int = 400,
                     renew_ms: int = 80):
    """tests/test_controlplane.py's make_fleet on side S: each member its
    own registry, as in the per-process layout."""
    shards = []
    for i in range(num_shards):
        reg = S.WorkerRegistry(bus, S.fast())
        sh = S.SchedulerShard(bus, reg, S.fast(), cp_config(S, i, num_shards, ttl_ms, renew_ms),
                              member_id=f"shard-{i}", settle_s=0.01 + 0.005 * i)
        await reg.initialize()
        await sh.start()
        shards.append(sh)
    assert await S.wait_for_ownership(shards, num_shards, timeout_s=5.0)
    gws = []
    for i in range(gateways):
        reg = S.WorkerRegistry(bus, S.fast(), observer=True)
        gw = S.GatewaySubmitter(bus, reg, S.fast(), member_id=f"gw-{i}")
        await reg.initialize()
        await gw.initialize()
        gws.append(gw)
    return shards, gws


async def stop_fleet(shards, gws, *workers):
    for w in workers:
        await w.stop(announce=False)
    for gw in gws:
        await gw.shutdown()
        await gw.registry.shutdown()
    for sh in shards:
        await sh.stop()
        await sh.registry.shutdown()


async def _bus(S):
    bus = S.InMemoryBus(key_prefix="T:")
    await bus.connect()
    return bus


async def _worker(S, bus, members, wid="w1", **kw):
    """A fake worker, once every member's registry holds it."""
    w = S.FakeWorker(bus, wid, ["m1"], **kw)
    await w.start()
    await bus.flush()
    assert await _until(lambda: all(m.registry.get_worker(wid) for m in members), 5)
    return w


async def _stream_run(S, gw, jid: str, kill_cb=None, kill_after_chunks=0):
    chunks: list[str] = []

    async def on_chunk(chunk) -> None:
        chunks.append(chunk.response or "")
        if kill_cb is not None and len(chunks) == kill_after_chunks:
            await kill_cb()

    result = await gw.submit_streaming_job(req(S, jid, stream=True), on_chunk,
                                           timeout_ms=20000)
    return result, "".join(chunks)


def _ident(sh) -> dict:
    return sh.scheduler.get_stats()["shard"]


async def _lease_records(S, bus) -> dict:
    recs = {k: json.loads(v) for k, v in (await bus.hgetall(S.LEASES_KEY)).items()}
    return {k: (r["owner"], r["epoch"], r["ttlMs"]) for k, r in sorted(recs.items())}


# -- deterministic partition mapping ----------------------------------------

@pytest.mark.parametrize("m", range(1, 9))
def test_shard_of_bit_equal_to_jax(m):
    rng = random.Random(m)
    ids = [f"job-{rng.getrandbits(64):016x}" for _ in range(5_000)] + \
          [f"{rng.choice(['req', 'chatcmpl', 'x'])}-{i}" for i in range(5_000)]
    got = [TORCH.shard_of(i, m) for i in ids]
    assert got == [JAX.shard_of(i, m) for i in ids]
    assert set(got) == set(range(m))
    assert TORCH.shard_of("job-pinned", 4) == JAX.shard_of("job-pinned", 4) == 0


def test_shard_context_and_identity_match():
    class Lease:
        def held_shards(self):
            return [1]

        def holds(self, idx):
            return idx == 1

        def fenced(self, idx):
            return idx == 1

        def epochs(self):
            return {"1": 3}

    ids = [f"job-{i}" for i in range(64)]
    views = []
    for S in (JAX, TORCH):
        ctx = S.ShardContext(3, "m", Lease())
        views.append((ctx.identity(), [ctx.owns(i) for i in ids],
                      [ctx.fenced_job(i) for i in ids], [ctx.shard_for(i) for i in ids]))
        with pytest.raises(ValueError, match="num_shards must be >= 1"):
            S.ShardContext(0, "m", Lease())
    assert views[0] == views[1]


# -- lease acquire / renew / fence ------------------------------------------

async def _lease_acquire_and_renew(S):
    bus = await _bus(S)
    lm = S.ShardLeaseManager(bus, "m1", 2, home_shards=(0,), ttl_ms=400, renew_ms=60,
                             settle_s=0.01)
    await lm.start()
    out = {"home": (lm.holds(0), lm.fenced(0)), "record": await _lease_records(S, bus)}
    assert await _until(lambda: lm.holds(1), 3)   # the sweep adopts partition 1
    out["adopted"] = (lm.held_shards(), lm.epochs(), await _lease_records(S, bus))
    await lm.stop()
    out["released"] = await _lease_records(S, bus)
    await bus.disconnect()
    return out


async def test_lease_acquire_and_renew():
    want, got = await _both(_lease_acquire_and_renew)
    assert got == want
    assert got["home"] == (True, True) and got["record"] == {"0": ("m1", 1, 400.0)}
    assert got["adopted"][:2] == ([0, 1], {"0": 1, "1": 1}) and got["released"] == {}


async def _lease_adoption(S):
    bus = await _bus(S)
    lost: list = []
    a = S.ShardLeaseManager(bus, "a", 1, home_shards=(0,), ttl_ms=300, renew_ms=50,
                            settle_s=0.01, on_lost=lambda i, r: lost.append((i, r)))
    await a.start()
    out = {"a": a.epochs()}
    a.kill()   # SIGKILL-style: a stops renewing but never releases
    b = S.ShardLeaseManager(bus, "b", 1, home_shards=(), ttl_ms=300, renew_ms=50,
                            settle_s=0.01)
    await b.start()
    assert await _until(lambda: b.holds(0), 3)   # a's record ages past the TTL
    out["b"] = (b.epochs(), await _lease_records(S, bus))
    await a._renew(0)   # a resurrects: its renewal sees the foreign epoch
    out["a_after"] = (a.holds(0), a.fenced(0), lost)
    await b.stop()
    await bus.disconnect()
    return out


async def test_lease_adoption_bumps_epoch_and_deposes():
    want, got = await _both(_lease_adoption)
    assert got == want
    assert got == {"a": {"0": 1}, "b": ({"0": 2}, {"0": ("b", 2, 300.0)}),
                   "a_after": (False, False, [(0, "deposed")])}


async def _lease_self_fences(S):
    bus = await _bus(S)
    lm = S.ShardLeaseManager(bus, "m1", 1, home_shards=(0,), ttl_ms=150, renew_ms=50,
                             settle_s=0.01)
    out = [await lm.try_acquire(0, adopted=False), lm.fenced(0)]   # no loop started
    await asyncio.sleep(0.2)   # renewals never ran: the member cannot prove ownership
    out += [lm.fenced(0), lm.holds(0)]
    await lm.stop()
    await bus.disconnect()
    return out


async def test_lease_self_fences_without_renewals():
    want, got = await _both(_lease_self_fences)
    assert got == want == [True, True, False, True]


# -- stale shard refused on every mutating path -----------------------------

class _DeadLease:
    """'Held but stale': the deposed-shard limbo between losing the lease
    and noticing."""

    def held_shards(self):
        return [0]

    def held_epochs(self):
        return {0: 1}

    def holds(self, idx):
        return True

    def fenced(self, idx):
        return False

    def epochs(self):
        return {"0": 1}


async def _stale_shard(S):
    bus = await _bus(S)
    reg = S.WorkerRegistry(bus, S.fast())
    sched = S.JobScheduler(bus, reg, S.fast(), shard=S.ShardContext(1, "stale", _DeadLease()))
    await reg.initialize()
    await sched.initialize()
    w = await _worker(S, bus, [sched])
    jid = _Ids(S, 5)(0, 1)
    await sched.add_job(req(S, jid))
    await bus.flush()
    await asyncio.sleep(0.2)
    fenced = sched._shard_fenced
    out = {"queued": (dict(sched.active_jobs), len(sched.job_queue), list(w.assignments),
                      fenced.value(op="assign") >= 1)}
    assignment = S.types.JobAssignment(jobId=jid, workerId="w1", request=req(S, jid),
                                       timeout=5000)
    sched.active_jobs[jid] = assignment
    await sched._handle_job_timeout(jid)
    await sched._orphan_job(assignment, reason="test")
    out["cancel"] = await sched.cancel_job(jid)
    fail = S.types.JobResult(jobId=jid, workerId="w1", success=False, error="boom",
                             retryable=True)
    await sched._on_job_failed("job:failed", fail.model_dump_json())
    out["fenced"] = {op: fenced.value(op=op) for op in ("timeout", "orphan", "cancel",
                                                        "failure")}
    out["still_active"] = jid in sched.active_jobs
    sched.active_jobs.pop(jid, None)
    await w.stop(announce=False)
    await sched.shutdown()
    await reg.shutdown()
    await bus.disconnect()
    return out


async def test_stale_shard_refuses_every_mutating_path():
    want, got = await _both(_stale_shard)
    assert got == want
    assert got["queued"] == ({}, 1, [], True) and got["cancel"] is False
    assert got["fenced"] == {"timeout": 1, "orphan": 1, "cancel": 1, "failure": 1}
    assert got["still_active"]


# -- fleet routing / remote submit ------------------------------------------

async def _fleet_routes(S):
    bus = await _bus(S)
    shards, gws = await make_fleet(S, bus)
    w = await _worker(S, bus, shards + gws, max_concurrent=8)
    ids = _Ids(S, 11)
    jobs = [ids(0), ids(0), ids(1), ids(1)]
    results = await asyncio.gather(*[gws[i % 2].submit_and_wait(req(S, jid), timeout_ms=5000)
                                     for i, jid in enumerate(jobs)])
    out = {"results": [(r.success, r.jobId, r.response.response) for r in results],
           "processed": sorted(w.processed), "assignments": len(w.assignments),
           "shards": [(sh.scheduler.get_stats()["totalJobsProcessed"], _ident(sh),
                       {e: sh.scheduler._ctrl_submits.value(event=e)
                        for e in ("accepted", "parked", "ignored")}) for sh in shards],
           "gateways": [(gw.identity(), gw._ctrl_submits.value(event="published"))
                        for gw in gws],
           "leases": await _lease_records(S, bus)}
    await stop_fleet(shards, gws, w)
    await bus.disconnect()
    return out


async def test_fleet_submits_route_to_owning_shard():
    want, got = await _both(_fleet_routes)
    assert got == want
    assert all(r[0] for r in got["results"]) and got["assignments"] == 4
    for i, (done, ident, submits) in enumerate(got["shards"]):
        assert done == 2 and ident == {"role": "shard", "member": f"shard-{i}", "shards": [i],
                                       "numShards": 2, "epochs": {str(i): 1}}
        # non-owned submits are parked for the partition's owner, never ignored
        assert submits == {"accepted": 2, "parked": 2, "ignored": 0}


async def _remote_cancel(S):
    bus = await _bus(S)
    shards, gws = await make_fleet(S, bus)
    w = await _worker(S, bus, shards + gws, delay_s=2.0)
    jid = _Ids(S, 12)(1)
    task = asyncio.create_task(gws[0].submit_and_wait(req(S, jid), timeout_ms=4000))
    assert await _until(lambda: jid in shards[1].scheduler.active_jobs, 3)
    await gws[0].cancel_job(jid, reason="client_disconnect")
    await bus.flush()
    assert await _until(lambda: jid not in shards[1].scheduler.active_jobs, 3)
    out = {"cancelled": list(w.cancelled), "active": jid in shards[1].scheduler.active_jobs,
           "cancel_events": shards[1].scheduler._jobs_total.value(event="cancelled")}
    task.cancel()
    try:
        await task
    except (asyncio.CancelledError, Exception):  # noqa: BLE001
        pass
    await stop_fleet(shards, gws, w)
    await bus.disconnect()
    return out, jid


async def test_remote_cancel_reaches_owning_shard():
    (want, jid_j), (got, jid_t) = await _both(_remote_cancel)
    assert jid_j == jid_t and got == want
    assert got["cancelled"] == [jid_t] and not got["active"]


# -- chaos differential: kill a scheduler shard mid-decode -------------------

async def _kill_shard(S):
    """The undisturbed fleet and the fleet whose owning shard is killed
    after the 5th chunk, run at once on buses of their own."""

    async def run(chaos: bool):
        bus = await _bus(S)
        shards, gws = await make_fleet(S, bus)
        w = await _worker(S, bus, shards + gws, wid="w-chaos" if chaos else "w-base",
                          stream_tokens=list(TOKENS), stream_delay_s=0.02)
        ids = _Ids(S, 13)
        jid = ids(0)
        if not chaos:
            result, streamed = await _stream_run(S, gws[0], jid)
            assert result.success
            await stop_fleet(shards, gws, w)
            await bus.disconnect()
            return streamed

        async def kill_owner() -> None:
            await shards[0].kill()

        result, streamed = await _stream_run(S, gws[1], jid, kill_cb=kill_owner,
                                             kill_after_chunks=5)
        assert result.success
        assert await _until(lambda: shards[1].lease.holds(0), 5)
        out = {"chaos": streamed, "result": (result.jobId, result.response.response),
               "epochs": shards[1].lease.epochs(), "leases": await _lease_records(S, bus),
               "assignments": list(w.assignments), "processed": list(w.processed),
               "orphaned": [sh.scheduler._jobs_total.value(event="orphaned")
                            for sh in shards]}
        # the control plane is live again: a second request on the adopted
        # partition is served end to end through the OTHER gateway
        jid2 = ids(0)
        result2, streamed2 = await _stream_run(S, gws[0], jid2)
        out["second"] = (result2.success, streamed2, _ident(shards[1]))
        await stop_fleet(shards, gws, w)
        await bus.disconnect()
        return out

    baseline, out = await asyncio.gather(run(False), run(True))
    return {"baseline": baseline, **out}


async def test_kill_shard_mid_decode_stream_byte_identical():
    want, got = await _both(_kill_shard)
    assert got == want
    assert got["chaos"] == got["baseline"] == "".join(TOKENS)
    assert got["epochs"] == {"0": 2, "1": 1}
    assert got["leases"]["0"] == ("shard-1", 2, 400.0)
    assert len(got["assignments"]) == 1 and got["processed"] == got["assignments"]
    assert got["orphaned"] == [0, 0]
    assert got["second"][:2] == (True, "".join(TOKENS))
    assert got["second"][2]["shards"] == [0, 1]


async def _adoption_replays_queued(S):
    bus = await _bus(S)
    shards, gws = await make_fleet(S, bus)
    jid = _Ids(S, 14)(0)   # no worker yet: the job stays queued on its owner
    task = asyncio.create_task(gws[0].submit_and_wait(req(S, jid), timeout_ms=15000))
    await bus.flush()
    assert await _until(lambda: len(shards[0].scheduler.job_queue) == 1, 3)
    out = {"record_before": await bus.hget(S.shard_queue_key(0), jid) is not None}
    await shards[0].kill()
    w = S.FakeWorker(bus, "w1", ["m1"])   # arrives while the partition is orphaned
    await w.start()
    result = await task
    out.update(result=(result.success, result.response.response), processed=list(w.processed),
               held=shards[1].lease.held_shards(), epochs=shards[1].lease.epochs(),
               record_after=await bus.hget(S.shard_queue_key(0), jid))
    await stop_fleet(shards, gws, w)
    await bus.disconnect()
    return out


async def test_adoption_replays_queued_jobs_from_bus():
    want, got = await _both(_adoption_replays_queued)
    assert got == want
    assert got["record_before"] and got["result"][0] and len(got["processed"]) == 1
    assert got["held"] == [0, 1] and got["epochs"]["0"] == 2 and got["record_after"] is None


async def _adoption_drops_resolved(S):
    bus = await _bus(S)
    shards, gws = await make_fleet(S, bus)
    w = await _worker(S, bus, shards + gws, stream_tokens=list(TOKENS), stream_delay_s=0.02)
    jid = _Ids(S, 15)(0)

    async def kill_owner() -> None:
        await shards[0].kill()

    # kill late in the stream: the job completes before adoption lands
    result, streamed = await _stream_run(S, gws[0], jid, kill_cb=kill_owner,
                                         kill_after_chunks=36)
    assert await _until(lambda: shards[1].lease.holds(0), 5)
    await asyncio.sleep(0.2)
    out = {"stream": (result.success, streamed),
           "ghost": jid in shards[1].scheduler.active_jobs,
           "record": await bus.hget(S.shard_active_key(0), jid),
           "assignments": len(w.assignments)}
    await stop_fleet(shards, gws, w)
    await bus.disconnect()
    return out


async def test_adoption_drops_already_resolved_active_record():
    want, got = await _both(_adoption_drops_resolved)
    assert got == want == {"stream": (True, "".join(TOKENS)), "ghost": False, "record": None,
                           "assignments": 1}


async def _ownerless_window(S):
    bus = await _bus(S)
    # a generous TTL: the submit lands INSIDE the owner-less window
    shards, gws = await make_fleet(S, bus, ttl_ms=1000, renew_ms=100)
    w = await _worker(S, bus, shards + gws)
    await shards[0].kill()   # its lease record stays live for ~1 s
    jid = _Ids(S, 16)(0)
    task = asyncio.create_task(gws[0].submit_and_wait(req(S, jid), timeout_ms=15000))
    await bus.flush()
    assert await _until(lambda: shards[1].scheduler._ctrl_submits.value(event="parked") >= 1, 1)
    out = {"in_queue": jid in [q.request.id for q in shards[1].scheduler.job_queue],
           "parked_record": await bus.hget(S.shard_queue_key(0), jid) is not None,
           "held_before": shards[1].lease.held_shards()}
    result = await task   # the adopter replays the parked record
    out.update(result=result.success, processed=list(w.processed),
               held=shards[1].lease.held_shards())
    await stop_fleet(shards, gws, w)
    await bus.disconnect()
    return out


async def test_submit_during_ownerless_window_is_parked_and_recovered():
    want, got = await _both(_ownerless_window)
    assert got == want
    assert not got["in_queue"] and got["parked_record"] and got["held_before"] == [1]
    assert got["result"] and len(got["processed"]) == 1 and got["held"] == [0, 1]


async def _owner_reconciles(S):
    bus = await _bus(S)
    shards, gws = await make_fleet(S, bus)
    w = await _worker(S, bus, shards + gws)
    jid = _Ids(S, 17)(0)
    fut = asyncio.get_running_loop().create_future()

    async def on_result(_ch: str, raw: str) -> None:
        if not fut.done():
            fut.set_result(S.types.JobResult.model_validate_json(raw))

    # a parked submit the owner never received on ctrl:submit: ONLY the
    # durable record, awaited on the per-job result channel
    sub = await bus.subscribe(f"job:result:{jid}", on_result)
    await bus.hset(S.shard_queue_key(0), jid, json.dumps({
        "seq": 10_000, "request": req(S, jid).model_dump(mode="json")}))
    result = await asyncio.wait_for(fut, 15)
    await sub.unsubscribe()
    out = {"result": result.success, "processed": list(w.processed),
           "reconciled": shards[0].scheduler._ctrl_submits.value(event="reconciled")}
    # the ghost of a resolved job: reconcile collects it, never re-executes
    await bus.hset(S.shard_queue_key(0), jid, json.dumps({
        "seq": 10_001, "request": req(S, jid).model_dump(mode="json")}))
    key = S.shard_queue_key(0)
    for _ in range(150):
        if await bus.hget(key, jid) is None:
            break
        await asyncio.sleep(0.02)
    out.update(record=await bus.hget(key, jid), runs=w.processed.count(jid))
    await stop_fleet(shards, gws, w)
    await bus.disconnect()
    return out


async def test_owner_reconciles_parked_record_it_never_saw():
    want, got = await _both(_owner_reconciles)
    assert got == want
    assert got["result"] and got["reconciled"] == 1 and got["record"] is None
    assert got["runs"] == 1


async def _observer_prunes(S):
    bus = await _bus(S)
    reg = S.WorkerRegistry(bus, S.fast(), observer=True)
    await reg.initialize()
    w = S.FakeWorker(bus, "w1", ["m1"], heartbeat_interval_s=0.1)
    await w.start()
    await bus.flush()
    out = [reg.get_worker("w1") is not None]
    await w.die()   # no unregister/disconnect announcement
    out.append(await _until(lambda: reg.get_worker("w1") is None, 3))
    # the bus hash is untouched: removal authority stays with the shards
    out.append(await bus.hget("workers", "w1") is not None)
    await reg.shutdown()
    await bus.disconnect()
    return out


async def test_observer_registry_prunes_silently_dead_worker():
    want, got = await _both(_observer_prunes)
    assert got == want == [True, True, True]


# -- aggregation view --------------------------------------------------------

def _members(view) -> dict:
    return {m: {k: v for k, v in env.items() if k != "ageS"}
            for m, env in view.members().items()}


async def _fleet_view_aggregates(S):
    bus = await _bus(S)
    shards, gws = await make_fleet(S, bus)
    view = S.FleetView(bus, gws[0].metrics, stale_after_ms=1000)
    await view.start()
    pubs = [S.StatusPublisher(bus, sh.scheduler, "shard", sh.member_id, 100, lease=sh.lease)
            for sh in shards]
    pubs.append(S.StatusPublisher(bus, gws[0], "gateway", gws[0].member_id, 100))
    for p in pubs:
        await p.publish_once()
    await bus.flush()
    merged = view.merged_stats()
    view._collect()
    out = {"members": _members(view), "numShards": merged["numShards"],
           "identity": {m: s.get("shard") for m, s in merged["perMember"].items()},
           "totals": {k: merged["shardTotals"][k] for k in ("totalJobsProcessed", "queuedJobs")
                      if k in merged["shardTotals"]},
           "slo": sorted(view.merged_slo()), "health": sorted(view.merged_health()),
           "capacity": (sorted(view.merged_capacity()["perMember"]),
                        view.merged_capacity()["numShards"]),
           "held": {s: view._held_gauge.value(shard=s) for s in ("0", "1")},
           "roles": {r: view._members_gauge.value(role=r) for r in ("gateway", "shard")},
           "envelope": sorted(json.loads(pubs[0].envelope()))}
    await view.stop()
    await stop_fleet(shards, gws)
    await bus.disconnect()
    return out


async def test_fleet_view_aggregates_per_member():
    want, got = await _both(_fleet_view_aggregates)
    assert got == want
    assert set(got["members"]) == {"shard-0", "shard-1", "gw-0"}
    assert got["members"]["shard-0"]["role"] == "shard" and got["numShards"] == 2
    assert got["identity"]["shard-1"]["member"] == "shard-1"
    assert got["slo"] == got["health"] == sorted(got["members"])
    assert got["held"] == {"0": 1, "1": 1} and got["roles"] == {"gateway": 1, "shard": 2}


async def _fleet_view_lost_lease(S):
    bus = await _bus(S)
    # a TTL that cannot run out inside the scenario: shard 1 must not adopt
    # partition 0 before the view is read
    shards, gws = await make_fleet(S, bus, ttl_ms=10_000, renew_ms=80)
    view = S.FleetView(bus, gws[0].metrics, stale_after_ms=300)
    await view.start()
    p0, p1 = (S.StatusPublisher(bus, sh.scheduler, "shard", sh.member_id, 100, lease=sh.lease)
              for sh in shards)
    await p0.publish_once()
    await p1.publish_once()
    await bus.flush()
    view._collect()
    out = {"before": view._held_gauge.value(shard="0")}
    await shards[0].kill()   # shard 0 dies; only shard 1 keeps publishing
    assert await _until(lambda: "shard-0" not in view.members(), 3)
    await p1.publish_once()
    await bus.flush()
    view._collect()
    out.update(after={s: view._held_gauge.value(shard=s) for s in ("0", "1")},
               adopted=shards[1].lease.held_shards(), members=sorted(view.members()))
    await view.stop()
    await stop_fleet(shards, gws)
    await bus.disconnect()
    return out


async def test_fleet_view_flags_lost_lease():
    want, got = await _both(_fleet_view_lost_lease)
    assert got == want == {"before": 1, "after": {"0": 0, "1": 1}, "adopted": [1],
                           "members": ["shard-1"]}


# -- satellites --------------------------------------------------------------

async def _ratelimit_scopes(S):
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    ratelimit = importlib.import_module(f"{S.pkg}.gateway.ratelimit")
    bus = await _bus(S)

    async def make_app(scope: str, metrics):
        cfg = S.cfg.GatewayConfig(rate_limit_window_ms=60_000, rate_limit_max_requests=4,
                                  rate_limit_scope=scope)
        app = web.Application(middlewares=[ratelimit.rate_limit_middleware(
            cfg, bus=bus, metrics=metrics)])

        async def ok(_r):
            return web.json_response({"ok": True})

        app.add_routes([web.get("/t", ok)])
        client = TestClient(TestServer(app))
        await client.start_server()
        return client

    out = {}
    for scope, n in (("fleet", 6), ("replica", 8)):
        metrics = S.obs.MetricsRegistry()
        clients = [await make_app(scope, metrics), await make_app(scope, metrics)]
        statuses = [(await clients[i % 2].get("/t")).status for i in range(n)]
        rej = metrics.counter(
            "gridllm_ratelimit_rejections_total",
            "Requests throttled with HTTP 429, by bucket scope (replica "
            "= per-process buckets, so N gateway replicas multiply the "
            "configured limit by N; fleet = bus-shared buckets).", ("scope",))
        out[scope] = (statuses, rej.value(scope=scope))
        for c in clients:
            await c.close()
    await bus.disconnect()
    return out


async def test_ratelimit_fleet_scope_shares_buckets():
    want, got = await _both(_ratelimit_scopes)
    assert got == want
    assert got["fleet"][0].count(429) == 2 and got["fleet"][1] == 2
    assert got["replica"][0] == [200] * 8


async def _replica_http(S):
    from aiohttp.test_utils import TestClient, TestServer

    app_mod = importlib.import_module(f"{S.pkg}.gateway.app")
    bus = S.InMemoryBus(key_prefix="GridLLM:")
    await bus.connect()
    shards, gws = await make_fleet(S, bus, gateways=1)
    gw = gws[0]
    view = S.FleetView(bus, gw.metrics, stale_after_ms=2000)
    await view.start()
    pubs = [S.StatusPublisher(bus, sh.scheduler, "shard", sh.member_id, 100, lease=sh.lease)
            for sh in shards]
    w = await _worker(S, bus, shards + gws)
    client = TestClient(TestServer(app_mod.create_app(bus, gw.registry, gw, S.cfg.Config(),
                                                      fleet=view)))
    await client.start_server()
    try:
        resp = await client.post("/ollama/api/generate",
                                 json={"model": "m1", "prompt": "hello", "stream": False})
        body = await resp.json()
        out = {"generate": (resp.status, body["response"], body["done"]),
               "processed": len(w.processed)}
        for p in pubs:
            await p.publish_once()
        await bus.flush()
        slo = await (await client.get("/admin/slo")).json()
        workers = await (await client.get("/health/workers")).json()
        dump = await (await client.get("/admin/dump")).json()
        text = await (await client.get("/metrics")).text()
        out.update(slo=(slo["shard"], sorted(slo["fleet"])),
                   cp=(workers["controlPlane"]["numShards"],
                       sorted(workers["controlPlane"]["members"]),
                       workers["controlPlane"]["member"]),
                   dump=sorted(dump["controlPlane"]["members"]),
                   metrics=["gridllm_shard_lease_held" in text,
                            "gridllm_ctrl_submits_total" in text])
    finally:
        await client.close()
        await view.stop()
        await stop_fleet(shards, gws, w)
        await bus.disconnect()
    return out


async def test_gateway_replica_http_surface_end_to_end():
    want, got = await _both(_replica_http)
    assert got == want
    assert got["generate"] == (200, "canned response", True) and got["processed"] == 1
    assert got["slo"] == ({"role": "gateway", "member": "gw-0", "shards": [],
                           "numShards": 0}, ["shard-0", "shard-1"])
    assert got["cp"][:2] == (2, ["shard-0", "shard-1"]) and got["dump"] == ["shard-0", "shard-1"]
    assert got["metrics"] == [True, True]


async def _local_identity(S):
    bus = await _bus(S)
    reg = S.WorkerRegistry(bus, S.fast())
    sched = S.JobScheduler(bus, reg, S.fast())
    await reg.initialize()
    await sched.initialize()
    st = sched.get_stats()["shard"]
    await sched.shutdown()
    await reg.shutdown()
    await bus.disconnect()
    return st


async def test_stats_carry_shard_identity_in_local_mode():
    want, got = await _both(_local_identity)
    assert got == want == {"role": "local", "member": "local", "shards": [0], "numShards": 1}


# -- a mixed fleet over the port's broker -------------------------------------

async def test_mixed_fleet_shards_adopt_each_other_over_the_port_broker():
    """A port shard and a JAX shard own one partition each of a 2-shard
    fleet on the port's broker, behind a JAX and a port gateway, with a
    port fake worker. The port shard is killed mid-stream: the JAX shard
    adopts partition 0 at epoch 2 and the stream is unchanged. A second
    port shard joins (its home partition held, it waits), then the JAX
    shard is killed mid-stream on partition 1: the port shard adopts both,
    partition 1 at epoch 2 and partition 0 at epoch 3. Each job is
    assigned once and none is orphaned."""
    from gridllm_torch.bus.broker import GridBusBroker
    from gridllm_torch.bus.resp import RespBus as TResp
    from gridllm_tpu.bus.resp import RespBus as JResp

    broker = GridBusBroker()
    await broker.start("127.0.0.1", 0)
    buses: list = []

    async def connect(cls):
        b = cls(host="127.0.0.1", port=broker.port, key_prefix="T:")
        await b.connect()
        buses.append(b)
        return b

    members: list = []

    async def shard(S, cls, home, name):
        b = await connect(cls)
        reg = S.WorkerRegistry(b, S.fast())
        sh = S.SchedulerShard(b, reg, S.fast(), cp_config(S, home), member_id=name,
                              settle_s=0.01 + 0.005 * len(members))
        await reg.initialize()
        await sh.start()
        members.append(sh)
        return sh

    async def gateway(S, cls, name):
        b = await connect(cls)
        reg = S.WorkerRegistry(b, S.fast(), observer=True)
        gw = S.GatewaySubmitter(b, reg, S.fast(), member_id=name)
        await reg.initialize()
        await gw.initialize()
        return gw

    t0 = await shard(TORCH, TResp, 0, "torch-shard-0")
    j1 = await shard(JAX, JResp, 1, "jax-shard-1")
    jgw = await gateway(JAX, JResp, "jax-gw")
    tgw = await gateway(TORCH, TResp, "torch-gw")
    wbus = await connect(TResp)
    w = TFakeWorker(wbus, "w1", ["m1"], stream_tokens=list(TOKENS), stream_delay_s=0.02)
    t2 = None
    try:
        assert await _until(lambda: t0.lease.holds(0) and j1.lease.holds(1), 5)
        await w.start()
        assert await _until(lambda: all(m.registry.get_worker("w1") for m in (t0, j1)), 5)
        ids = _Ids(TORCH, 21)

        async def stream(S, gw, jid, victim):
            chunks: list[str] = []

            async def on_chunk(c):
                chunks.append(c.response or "")
                if len(chunks) == 5:
                    await victim.kill()

            res = await gw.submit_streaming_job(req(S, jid, stream=True), on_chunk,
                                                timeout_ms=20_000)
            return res, "".join(chunks)

        jid0 = ids(0)
        res, text = await stream(JAX, jgw, jid0, t0)
        assert res.success and text == "".join(TOKENS)
        assert await _until(lambda: j1.lease.holds(0), 5)
        assert j1.lease.epochs() == {"0": 2, "1": 1}
        t2 = await shard(TORCH, TResp, 1, "torch-shard-2")
        assert t2.lease.held_shards() == []   # its home is held live: it waits
        assert await _until(lambda: t2.registry.get_worker("w1") is not None, 5)
        jid1 = ids(1)
        res, text = await stream(TORCH, tgw, jid1, j1)
        assert res.success and text == "".join(TOKENS)
        assert await _until(lambda: t2.lease.held_shards() == [0, 1], 5)
        assert t2.lease.epochs() == {"0": 3, "1": 2}
        assert await _lease_records(TORCH, wbus) == {"0": ("torch-shard-2", 3, 400.0),
                                                     "1": ("torch-shard-2", 2, 400.0)}
        assert w.assignments == [jid0, jid1] and w.processed == [jid0, jid1]
        assert [m.scheduler._jobs_total.value(event="orphaned") for m in members] == [0, 0, 0]
        # the adopted partitions serve a fresh job through the JAX gateway
        res = await jgw.submit_and_wait(req(JAX, ids(0)), timeout_ms=10_000)
        assert res.success and res.workerId == "w1"
        assert _ident(t2)["shards"] == [0, 1]
    finally:
        await w.stop(announce=False)
        for gw in (jgw, tgw):
            await gw.shutdown()
            await gw.registry.shutdown()
        for m in members:
            await m.stop()
            await m.registry.shutdown()
        for b in buses:
            await b.disconnect()
        await broker.stop()


# -- the entry points in processes without JAX --------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(module: str, *args: str, env: dict | None = None) -> subprocess.Popen:
    """`python -m module args` with jax, jaxlib, gridllm_tpu and pydantic
    unimportable."""
    return subprocess.Popen(
        [sys.executable, "-c", _RUN_MODULE.format(blocked=BLOCKED + ("pydantic",)), module,
         *args], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


async def test_entry_points_serve_without_jax(tmp_path):
    import aiohttp

    from gridllm_torch.bus.resp import RespBus
    from gridllm_torch.engine import EngineConfig, InferenceEngine
    from gridllm_torch.utils.config import WorkerConfig
    from gridllm_torch.worker.service import WorkerService

    bport, hport, gport = _free_port(), _free_port(), _free_port()
    bus_env = {"GRIDLLM_BUS_URL": f"resp://127.0.0.1:{bport}", "GRIDLLM_SHARD_COUNT": "1",
               "GRIDLLM_SHARD_LEASE_TTL_MS": "2000", "GRIDLLM_SHARD_RENEW_MS": "400",
               "GRIDLLM_SHARD_STATUS_MS": "200", "WORKER_HEARTBEAT_TIMEOUT": "3000"}
    aof = tmp_path / "bus.aof"
    procs = {}
    procs["broker"] = _launch("gridllm_torch.bus.broker", "--host", "127.0.0.1", "--port",
                              str(bport), "--aof", str(aof))
    procs["shard"] = _launch("gridllm_torch.controlplane", env={
        **bus_env, "GRIDLLM_SHARD_ID": "0", "GRIDLLM_CONTROLPLANE_ID": "shard-e2e",
        "GRIDLLM_SHARD_HEALTH_PORT": str(hport)})
    procs["gateway"] = _launch("gridllm_torch.gateway", env={
        **bus_env, "GRIDLLM_CONTROLPLANE": "gateway", "GRIDLLM_CONTROLPLANE_ID": "gw-e2e",
        "HOST": "127.0.0.1", "PORT": str(gport)})
    engine = InferenceEngine(EngineConfig(model="tiny-llama", max_slots=2, page_size=8,
                                          num_pages=64, max_pages_per_slot=16,
                                          prefill_buckets=(16, 64), dtype="float32"),
                             device="cpu")
    wbus = RespBus(host="127.0.0.1", port=bport)
    worker = None
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=30)) as http:
            async def get(port, path):
                try:
                    async with http.get(f"http://127.0.0.1:{port}{path}") as r:
                        return r.status, await r.json()
                except aiohttp.ClientError:
                    return None, None

            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                live = await get(hport, "/health/live")
                if live[0] == 200 and live[1]["shards"] == [0] and \
                        (await get(gport, "/health"))[0] == 200:
                    break
                assert all(p.poll() is None for p in procs.values()), \
                    {k: p.poll() for k, p in procs.items()}
                await asyncio.sleep(0.1)
            assert live == (200, {"status": "alive", "member": "shard-e2e", "shards": [0]})
            await wbus.connect()
            worker = WorkerService(wbus, {"tiny-llama": engine},
                                   WorkerConfig(worker_id="w-e2e", heartbeat_interval_ms=200))
            await worker.start()
            while True:
                _, body = await get(gport, "/health/workers")
                if body and [w["workerId"] for w in body["workers"]] == ["w-e2e"] and \
                        body["controlPlane"]["numShards"] == 1:
                    break
                assert time.monotonic() < deadline + 30, body
                await asyncio.sleep(0.1)
            assert sorted(body["controlPlane"]["members"]) == ["gw-e2e", "shard-e2e"]
            async with http.post(f"http://127.0.0.1:{gport}/api/generate", json={
                    "model": "tiny-llama", "prompt": "hello", "stream": False,
                    "options": {"temperature": 0, "num_predict": 4}}) as r:
                served = (r.status, await r.json())
            # the shard counts the job from job:completed, which races the
            # replica's job:result in another process
            for _ in range(100):
                _, dump = await get(hport, "/admin/dump")
                if dump["scheduler"]["stats"]["totalJobsProcessed"]:
                    break
                await asyncio.sleep(0.05)
    finally:
        while engine.active_requests or engine.queued_requests:
            await asyncio.sleep(0.01)
        if worker is not None:
            await worker.stop(announce=False)
        await wbus.disconnect()
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        outs = {k: p.communicate(timeout=30)[0] for k, p in procs.items()}
    assert served[0] == 200 and served[1]["eval_count"] == 4, (served, outs)
    assert dump["scheduler"]["stats"]["totalJobsProcessed"] == 1, outs["shard"][-3000:]
    # SIGTERM: the shard and the replica stop cleanly, releasing the lease
    assert procs["shard"].returncode == 0 and procs["gateway"].returncode == 0, outs
    assert "blocked import" not in "".join(outs.values())
