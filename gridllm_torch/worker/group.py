"""Group membership and failure propagation for multi-process logical
workers (the JAX package's worker/group.py).

- ONE logical worker: only the liaison (process 0) registers on the bus,
  heartbeats `heartbeat:{workerId}` and runs the job protocol.
- EVERY process (the liaison too) keeps a member TTL key
  `heartbeat:group:{workerId}:{processId}` on the bus.
- Any member key expiring ⇒ the group is broken ⇒ the WHOLE logical worker
  fails fast: the liaison announces `worker:disconnected` and stops
  heartbeating, so the scheduler's orphan path requeues its jobs; the
  followers exit, so the supervisor restarts the group together.

A member that exits cleanly deletes its key, which the monitors see at
once.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Awaitable, Callable

from gridllm_torch.bus.base import CH_WORKER_DISCONNECTED, MessageBus
from gridllm_torch.parallel.distributed import GroupConfig
from gridllm_torch.utils.logging import get_logger

log = get_logger("worker.group")


def member_key(worker_id: str, process_id: int) -> str:
    return f"heartbeat:group:{worker_id}:{process_id}"


class GroupMembership:
    """Per-process membership beacon and group-health monitor.

    `on_slice_failure` fires (once) when any member goes silent. The
    liaison passes a callback that fails the logical worker; followers
    one that exits the process."""

    def __init__(self, bus: MessageBus, worker_id: str, group: GroupConfig,
                 heartbeat_interval_s: float = 5.0,
                 on_slice_failure: Callable[[str], Awaitable[None]] | None = None):
        self.bus = bus
        self.worker_id = worker_id
        self.group = group
        self.interval_s = heartbeat_interval_s
        self.on_slice_failure = on_slice_failure
        self._tasks: list[asyncio.Task] = []
        self._running = False
        self._failed = False
        # a member is monitored only once it has been seen, so the group's
        # start (processes join over seconds) is not a failure
        self._seen: set[int] = set()

    async def start(self) -> None:
        if not self.group.is_group:
            return
        self._running = True
        await self._beat_once()
        self._tasks.append(asyncio.create_task(self._beacon_loop()))
        self._tasks.append(asyncio.create_task(self._monitor_loop()))
        log.info("group membership active", worker=self.worker_id,
                 process=f"{self.group.process_id}/{self.group.num_processes}")

    def saw(self, process_id: int) -> None:
        """Watch member `process_id` from now on: its liveness was shown
        another way (the liaison's ready barrier), so a death before this
        monitor's first look still fails the group."""
        self._seen.add(process_id)

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        if self.group.is_group:
            try:
                await self.bus.delete(member_key(self.worker_id, self.group.process_id))
            except Exception:  # noqa: BLE001 — the bus may be gone at exit
                pass

    async def _beat_once(self) -> None:
        await self.bus.set_with_expiry(member_key(self.worker_id, self.group.process_id),
                                       str(time.time()), ttl_s=self.interval_s * 2)

    async def _beacon_loop(self) -> None:
        while self._running:
            try:
                await self._beat_once()
            except Exception as e:  # noqa: BLE001
                log.warning("group beacon failed", error=str(e))
            await asyncio.sleep(self.interval_s)

    async def _monitor_loop(self) -> None:
        check_s = max(self.interval_s / 2, 0.05)
        while self._running:
            await asyncio.sleep(check_s)
            try:
                missing = await self._missing_members()
            except Exception as e:  # noqa: BLE001
                log.warning("group monitor bus error", error=str(e))
                continue
            if missing and not self._failed:
                self._failed = True
                reason = f"slice members lost: {sorted(missing)}"
                log.error("worker group broken", worker=self.worker_id, reason=reason)
                if self.on_slice_failure is not None:
                    await self.on_slice_failure(reason)
                return

    async def _missing_members(self) -> set[int]:
        missing: set[int] = set()
        for pid in range(self.group.num_processes):
            if pid == self.group.process_id:
                continue
            if await self.bus.get(member_key(self.worker_id, pid)) is None:
                if pid in self._seen:
                    missing.add(pid)
            else:
                self._seen.add(pid)
        return missing


async def fail_logical_worker(bus: MessageBus, worker_id: str, reason: str) -> None:
    """Liaison-side group failure: announce the disconnection so the
    scheduler evicts the worker and orphans its jobs at once (the heartbeat
    TTL would get there later anyway)."""
    try:
        await bus.publish(CH_WORKER_DISCONNECTED, json.dumps({
            "workerId": worker_id, "reason": reason}))
        await bus.hdel("workers", worker_id)
    except Exception as e:  # noqa: BLE001
        log.warning("failure announce failed", error=str(e))
