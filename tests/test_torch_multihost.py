"""The torch worker group: plan replay and the two-process logical worker.

- One process: a liaison engine's `plan_sink` records, replayed through
  `apply_plan_op` by a follower engine that never serves, leave the same
  pool, lengths, tokens and sampler state (tests/test_llava.py's replay
  check for the JAX engine), long prompts in chunks, speculation and an
  embedding batch included; an unknown op is refused; a follower that
  replays a draft-model tree's verify_tree records (it has no draft model
  of its own) ends in the liaison's state too.
- Two processes (tests/torch_slice_child.py: worker/main.py's `run` on
  gloo, tiny-llama over tp=2) on the port's broker: the counterparts of
  tests/test_multihost.py's two tests. The group registers ONE logical
  worker and serves generates through the port's scheduler (a follower that
  did not replay the plan would hang the first all-reduce), and a member
  SIGKILLed fails the logical worker: worker:disconnected published, the
  registry entry removed, the liaison exits.

Children log to files; each wait has its own timeout and waits on bus
messages.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import uuid
from pathlib import Path

import pytest
import torch

from gridllm_torch.bus import create_bus
from gridllm_torch.bus.base import (
    CH_WORKER_DISCONNECTED,
    CH_WORKER_HEARTBEAT,
    CH_WORKER_REGISTERED,
)
from gridllm_torch.bus.broker import GridBusBroker
from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine
from gridllm_torch.utils.config import SchedulerConfig
from gridllm_torch.utils.types import InferenceRequest

CHILD = Path(__file__).with_name("torch_slice_child.py")
REPO = CHILD.parent.parent
TINY = dict(model="tiny-llama", max_slots=4, page_size=8, num_pages=64, max_pages_per_slot=16,
            prefill_buckets=(16, 32), prefill_chunk=16, dtype="float32")
LONG = "the quick brown fox jumps over the lazy dog"   # > prefill_chunk
# generous: the suite runs these beside other test workers on a shared CPU
REGISTER_TIMEOUT_S = 120
SERVE_TIMEOUT_S = 120
FAIL_TIMEOUT_S = 60


def _replay(liaison: InferenceEngine, follower: InferenceEngine, records: list[dict]):
    for rec in records:
        follower.apply_plan_op(rec)
    for name in ("tokens", "active", "counts", "window", "wlen"):
        assert torch.equal(getattr(liaison, name), getattr(follower, name)), name
    for name in ("k", "v", "lengths", "page_table"):
        assert torch.equal(getattr(liaison.cache, name), getattr(follower.cache, name)), name
    assert torch.equal(liaison.sampling.step, follower.sampling.step)


@pytest.mark.parametrize("spec", [True, False])
def test_plan_replay_leaves_the_same_state(spec):
    """Greedy and sampled requests, a prompt past one chunk (mixed steps),
    a prefix-cache repeat and an embedding batch on the liaison; the
    follower replays the records alone and ends in the same device state."""
    liaison = InferenceEngine(EngineConfig(spec_decode=spec, **TINY), device="cpu")
    follower = InferenceEngine(EngineConfig(spec_decode=spec, **TINY), device="cpu")
    records: list[dict] = []
    liaison.plan_sink = records.append
    opts = [{"temperature": 0, "num_predict": 6}, {"temperature": 0.9, "seed": 7,
                                                   "num_predict": 5}]
    for i, prompt in enumerate(["hello world", LONG, "hello world"]):
        res = liaison.generate(GenerationRequest(id=f"r{i}", prompt=prompt,
                                                 options=dict(opts[i % 2])))
        assert res.done_reason == "length"
    liaison.embed(["embed me", LONG])
    ops = [r["op"] for r in records]
    assert {"admit", "deact", "embed", "verify" if spec else "block"} <= set(ops)
    assert ops.count("admit") == 3 and ops.count("deact") == 3
    _replay(liaison, follower, records)
    liaison.reset_device_state()
    assert records[-1] == {"op": "reset"}
    _replay(liaison, follower, records[-1:])


def test_apply_plan_op_refuses_unknown_op():
    eng = InferenceEngine(EngineConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="unknown plan op"):
        eng.apply_plan_op({"op": "no_such_op"})


def test_tree_speculation_refused_in_a_group():
    """Draft-model tree speculation in a group: the liaison drafts and
    records each tree verify (drafts, validity, topology); a follower
    built with the n-gram drafter replays them into the same pool, tokens
    and lengths, the greedy streams of the liaison equal to a plain
    engine's."""
    cfg = dict(TINY, draft_model="tiny-llama", spec_k=3)
    liaison = InferenceEngine(EngineConfig(**cfg), device="cpu")
    follower = InferenceEngine(EngineConfig(**dict(cfg, draft_model="")), device="cpu")
    plain = InferenceEngine(EngineConfig(**cfg), device="cpu")
    records: list[dict] = []
    liaison.plan_sink = records.append
    opts = {"temperature": 0, "num_predict": 8, "repeat_penalty": 1.0}
    for i, prompt in enumerate(["abc abc abc abc", LONG]):
        req = dict(id=f"t{i}", prompt=prompt, options=dict(opts))
        assert (liaison.generate(GenerationRequest(**req)).token_ids
                == plain.generate(GenerationRequest(**req)).token_ids)
    trees = [r for r in records if r["op"] == "verify_tree"]
    assert trees and all(r["parents"] == liaison._tree[0].tolist() for r in trees)
    assert "verify" not in {r["op"] for r in records}
    assert follower._drafter.kind == "ngram"
    _replay(liaison, follower, records)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Group:
    """Two processes of one logical worker on a broker, logging to files."""

    def __init__(self, tmp_path: Path, broker_port: int, worker_id: str):
        coord = _free_port()
        self.logs, self.procs = [], []
        for pid in range(2):
            env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                       GRIDLLM_BUS_URL=f"resp://127.0.0.1:{broker_port}",
                       GRIDLLM_MODELS="tiny-llama", GRIDLLM_MESH_SHAPE="tp:2",
                       GRIDLLM_NUM_PROCS="2", GRIDLLM_PROC_ID=str(pid),
                       GRIDLLM_COORD_ADDR=f"127.0.0.1:{coord}", WORKER_ID=worker_id,
                       WORKER_PORT=str(_free_port()), HEARTBEAT_INTERVAL="2000",
                       GRIDLLM_KV_PAGE_SIZE="8", GRIDLLM_DTYPE="float32",
                       GRIDLLM_PREFILL_BUCKETS="16,32", GRIDLLM_MAX_BATCH_SLOTS="2")
            self.logs.append(open(tmp_path / f"member{pid}.log", "w+"))
            self.procs.append(subprocess.Popen([sys.executable, str(CHILD)], env=env,
                                               stdout=self.logs[-1],
                                               stderr=subprocess.STDOUT))

    def tail(self, pid: int) -> str:
        self.logs[pid].flush()
        self.logs[pid].seek(0)
        return self.logs[pid].read()[-3000:]

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()


async def _registered(bus, worker_id: str, group: _Group) -> None:
    """Wait for the logical worker's registration message."""
    seen = asyncio.Event()

    async def on_reg(_ch: str, raw: str) -> None:
        if json.loads(raw).get("workerId") == worker_id:
            seen.set()

    sub = await bus.subscribe(CH_WORKER_REGISTERED, on_reg)
    try:
        if not await bus.hget("workers", worker_id):
            try:
                await asyncio.wait_for(seen.wait(), REGISTER_TIMEOUT_S)
            except asyncio.TimeoutError:
                pytest.fail("the logical worker never registered; liaison: " + group.tail(0))
    finally:
        await sub.unsubscribe()


async def test_group_serves_generate_as_one_logical_worker(tmp_path):
    from gridllm_torch.scheduler import JobScheduler, WorkerRegistry

    broker = GridBusBroker()
    await broker.start(port=0)
    worker_id = "torch-slice-serve"
    group = _Group(tmp_path, broker.port, worker_id)
    bus = create_bus(f"resp://127.0.0.1:{broker.port}")
    await bus.connect()
    cfg = SchedulerConfig()
    registry = WorkerRegistry(bus, cfg)
    scheduler = JobScheduler(bus, registry, cfg)
    await registry.initialize()
    await scheduler.initialize()
    try:
        await _registered(bus, worker_id, group)
        assert list(await bus.hgetall("workers")) == [worker_id]   # ONE worker
        for prompt, n in (("hello slice", 6), (LONG, 4)):
            req = InferenceRequest(id=f"mh-{uuid.uuid4().hex[:8]}", model="tiny-llama",
                                   prompt=prompt, stream=False,
                                   options={"temperature": 0, "num_predict": n},
                                   metadata={"requestType": "inference"})
            try:
                res = await scheduler.submit_and_wait(req, timeout_ms=SERVE_TIMEOUT_S * 1000)
            except Exception as e:  # noqa: BLE001 — fail with the members' logs
                pytest.fail(f"{e!r}; liaison: {group.tail(0)}; follower: {group.tail(1)}")
            assert res.success, (res.error, group.tail(0), group.tail(1))
            assert res.workerId == worker_id
            assert res.response.eval_count == n
    finally:
        group.close()
        await scheduler.shutdown()
        await registry.shutdown()
        await bus.disconnect()
        await broker.stop()


async def test_dead_member_fails_the_logical_worker(tmp_path):
    broker = GridBusBroker()
    await broker.start(port=0)
    worker_id = "torch-slice-fail"
    group = _Group(tmp_path, broker.port, worker_id)
    bus = create_bus(f"resp://127.0.0.1:{broker.port}")
    await bus.connect()
    disconnected: asyncio.Queue = asyncio.Queue()

    async def on_disc(_ch: str, raw: str) -> None:
        disconnected.put_nowait(json.loads(raw))

    sub = await bus.subscribe(CH_WORKER_DISCONNECTED, on_disc)
    try:
        await _registered(bus, worker_id, group)
        # a few heartbeats first: the liaison's member monitor, on the same
        # event loop, has seen the follower's key by then (a member is
        # watched only once it has been seen)
        beats: asyncio.Queue = asyncio.Queue()

        async def on_beat(_ch: str, raw: str) -> None:
            if json.loads(raw).get("workerId") == worker_id:
                beats.put_nowait(raw)

        beat_sub = await bus.subscribe(CH_WORKER_HEARTBEAT, on_beat)
        for _ in range(3):
            await asyncio.wait_for(beats.get(), FAIL_TIMEOUT_S)
        await beat_sub.unsubscribe()
        group.procs[1].send_signal(signal.SIGKILL)   # no clean exit: the TTL expires
        msg = await asyncio.wait_for(disconnected.get(), FAIL_TIMEOUT_S)
        assert msg["workerId"] == worker_id
        assert "slice members lost" in msg["reason"]
        # the liaison exits on a broken group (after its hdel of the entry)
        rc = await asyncio.to_thread(group.procs[0].wait, FAIL_TIMEOUT_S)
        assert rc != 0, group.tail(0)
        assert await bus.hget("workers", worker_id) is None
    finally:
        group.close()
        await sub.unsubscribe()
        await bus.disconnect()
        await broker.stop()
