"""Worker-group step-plan transport: liaison → followers over the bus.

The counterpart of the JAX package's worker/plan.py. A tensor-parallel
logical worker is a group of processes (parallel/distributed.py) that must
issue the same model calls in the same order, or the first collective
deadlocks:

- The liaison's engines emit one compact record per device-dispatching
  action (engine.plan_sink: admit / block / verify / deact / embed /
  reset, all plain host data). PlanPublisher stamps a sequence number and
  publishes them on ONE per-worker channel ``slice:{worker_id}:plan``
  (bus.base.plan_channel) with the model name attached — one totally
  ordered stream, since a multi-model worker's engines share the group and
  the liaison's shared dispatch_lock makes emission order its dispatch
  order.
- PlanFollower (on every other process) subscribes, checks that the
  sequence is gapless (pub/sub has no replay: one lost record is an
  irrecoverable divergence, so it fails the group fast and the supervisor
  restarts it together), and replays each record through
  engine.apply_plan_op on a thread of its own.

A record goes out before its dispatch (engine.py explains why), so a
follower replays while the liaison waits in the dispatch's first
collective for it.
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading
from typing import Awaitable, Callable

from gridllm_torch.bus.base import MessageBus, Subscription, plan_channel
from gridllm_torch.engine import InferenceEngine
from gridllm_torch.utils.logging import get_logger

log = get_logger("worker.plan")

__all__ = ["PlanFollower", "PlanPublisher", "plan_channel", "ready_key"]


def ready_key(worker_id: str, process_id: int) -> str:
    """Bus key a follower sets once its plan subscription is LIVE: the
    liaison must not register (and take jobs) before every follower can
    hear the plan, or the first records land on a channel with no
    subscriber and the group diverges at startup."""
    return f"slice:{worker_id}:ready:{process_id}"


class PlanPublisher:
    """Liaison side: engine.plan_sink → ordered bus publishes.

    The sink is called from engine threads; records are queued thread-safely
    and drained by ONE async task, so wire order is emission order."""

    def __init__(self, bus: MessageBus, channel: str, loop: asyncio.AbstractEventLoop):
        self.bus = bus
        self.channel = channel
        self._loop = loop
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._q: asyncio.Queue[str] = asyncio.Queue()
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = self._loop.create_task(self._drain())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def sink(self, rec: dict) -> None:
        """engine.plan_sink entry: safe from any thread."""
        with self._seq_lock:
            self._seq += 1
            msg = json.dumps({"seq": self._seq, "rec": rec})
            self._loop.call_soon_threadsafe(self._q.put_nowait, msg)

    async def _drain(self) -> None:
        while True:
            msg = await self._q.get()
            try:
                await self.bus.publish(self.channel, msg)
            except Exception as e:  # noqa: BLE001 — followers see the gap
                log.error("plan publish failed", error=str(e))


class PlanFollower:
    """Follower side: bus records → engine.apply_plan_op, in order, on ONE
    replay thread across all of the worker's models."""

    def __init__(self, bus: MessageBus, channel: str, engines: dict[str, InferenceEngine],
                 on_divergence: Callable[[str], Awaitable[None]]):
        self.bus = bus
        self.channel = channel
        self.engines = engines
        self.on_divergence = on_divergence
        self.applied = 0
        self._expected = 1
        self._sub: Subscription | None = None
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._replay, name="plan-replay", daemon=True)
        self._thread.start()
        self._sub = await self.bus.subscribe(self.channel, self._on_msg)

    async def stop(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
            self._sub = None
        self._stop.set()
        self._q.put(None)
        if self._thread is not None:
            # the thread may sit in a collective whose peer is gone: it is a
            # daemon, and the process exits after this
            self._thread.join(timeout=10)
            self._thread = None

    async def _on_msg(self, _ch: str, raw: str) -> None:
        d = json.loads(raw)
        if d["seq"] != self._expected:
            await self.on_divergence(
                f"plan sequence gap: expected {self._expected}, got {d['seq']} "
                "(lost record → SPMD divergence)")
            return
        self._expected += 1
        self._q.put(d["rec"])

    def _replay(self) -> None:
        while not self._stop.is_set():
            rec = self._q.get()
            if rec is None:
                return
            try:
                self.engines[rec["model"]].apply_plan_op(rec)
                self.applied += 1
            except Exception as e:  # noqa: BLE001
                log.error("plan replay failed", op=rec.get("op"), error=str(e))
                if self._loop is not None:
                    asyncio.run_coroutine_threadsafe(
                        self.on_divergence(f"plan replay failed: {e}"), self._loop)
                return
