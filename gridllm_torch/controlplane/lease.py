"""Bus-backed shard-ownership leases with epoch fencing.

Each scheduler shard owns a partition of the job-id space by holding a
lease record in the bus hash ``shard_leases``:

    {idx: {"owner": member, "epoch": N, "renewedAt": ts, "ttlMs": ttl}}

Semantics, in the broker's epoch-fencing shape:

- **Acquire** bumps the record's epoch: every ownership transfer is a
  strictly newer epoch, so two members can never both believe they hold
  the same (shard, epoch) pair. With no compare-and-set on the bus
  contract, acquisition is write → settle → read-back-verify: both
  racing candidates write, the broker serializes, and after the settle
  window only the LAST writer reads itself back as owner. The loser's
  next renewal sees a foreign owner/epoch and deposes itself. The settle
  window is deterministic per member (spread, not synchronized) and must
  exceed the bus round trip — the renew interval bounds any residual
  overlap, and the scheduler's fence check refuses mutations the moment
  freshness lapses.
- **Renew** re-reads before rewriting: a foreign owner OR a foreign
  epoch under our own name means we were deposed — drop ownership and
  fire ``on_lost`` (the scheduler releases the partition's local state
  without touching the durable records the new owner replays).
- **Expire locally**: if renewals stop landing (partition, dead broker)
  for longer than the TTL, the member fences ITSELF — it cannot prove
  nobody else adopted the shard, so ``fenced()`` goes False and every
  mutating scheduler path refuses. This is the "a deposed or partitioned
  shard can never double-assign" contract.
- **Sweep/adopt**: every member scans the other partitions each
  interval; an expired or missing lease is acquired (epoch bump) and
  ``on_acquired(idx, adopted=True)`` triggers the scheduler's durable-
  state replay (adopt_shard).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import time
from typing import Any, Awaitable, Callable

from gridllm_torch.bus.base import MessageBus
from gridllm_torch.obs import MetricsRegistry
from gridllm_torch.utils.logging import get_logger

log = get_logger("controlplane.lease")

LEASES_KEY = "shard_leases"

# (idx, adopted) → None; adopted=False is the boot-time home acquisition
AcquiredCb = Callable[[int, bool], Awaitable[None] | None]
# (idx, reason) → None; reason is "deposed" or "expired"
LostCb = Callable[[int, str], Awaitable[None] | None]


def _settle_s(member_id: str) -> float:
    """Deterministic per-member settle window (40-80 ms): candidates that
    race an acquisition settle at different times, so the later writer's
    record is visible to the earlier one's read-back."""
    h = int.from_bytes(
        hashlib.blake2b(member_id.encode(), digest_size=2).digest(), "big")
    return 0.04 + (h % 40) / 1000.0


class ShardLeaseManager:
    def __init__(self, bus: MessageBus, member_id: str, num_shards: int,
                 home_shards: tuple[int, ...] | list[int],
                 ttl_ms: float, renew_ms: float,
                 metrics: MetricsRegistry | None = None,
                 on_acquired: AcquiredCb | None = None,
                 on_lost: LostCb | None = None,
                 settle_s: float | None = None):
        self.bus = bus
        self.member_id = member_id
        self.num_shards = num_shards
        self.home_shards = tuple(home_shards)
        self.ttl_ms = float(ttl_ms)
        self.renew_ms = float(renew_ms)
        self.on_acquired = on_acquired
        self.on_lost = on_lost
        self.settle_s = (_settle_s(member_id) if settle_s is None
                         else settle_s)
        self._held: dict[int, int] = {}       # shard idx → our epoch
        self._last_ok: dict[int, float] = {}  # shard idx → monotonic renew
        self._task: asyncio.Task | None = None
        self._running = False
        self._transitions = None
        self._epoch_gauge = None
        if metrics is not None:
            self.attach_metrics(metrics)

    def attach_metrics(self, metrics: MetricsRegistry) -> None:
        """Register the lease instruments on a registry — called by the
        SchedulerShard with its scheduler's per-instance registry so the
        shard health port's /metrics serves them."""
        self._transitions = metrics.counter(
            "gridllm_shard_lease_transitions_total",
            "Shard-ownership lease transitions, by event (acquired = "
            "boot-time home partition, adopted = failover takeover "
            "with epoch bump, deposed = a newer owner appeared, "
            "expired = renewals stopped landing and the member "
            "fenced itself, released = graceful shutdown).",
            ("event",))
        self._epoch_gauge = metrics.gauge(
            "gridllm_shard_lease_epoch",
            "Lease epoch of each shard partition this member "
            "currently holds — bumps exactly once per ownership "
            "transfer (the fencing token).",
            ("shard",))
        metrics.add_collector("shard_lease", self._collect)

    # -- observability -------------------------------------------------------
    def _collect(self) -> None:
        for idx, epoch in self._held.items():
            self._epoch_gauge.set(epoch, shard=str(idx))

    def _count(self, event: str) -> None:
        if self._transitions is not None:
            self._transitions.inc(event=event)

    # -- queries -------------------------------------------------------------
    def holds(self, idx: int) -> bool:
        return idx in self._held

    def held_shards(self) -> list[int]:
        return sorted(self._held)

    def held_epochs(self) -> dict[int, int]:
        """{shard idx: our epoch} for every partition currently held."""
        return dict(self._held)

    def epochs(self) -> dict[str, int]:
        return {str(i): e for i, e in sorted(self._held.items())}

    def fenced(self, idx: int) -> bool:
        """Fresh-lease check: held AND the last successful renewal landed
        within the TTL. This is what the scheduler's mutating paths ask."""
        last = self._last_ok.get(idx)
        if idx not in self._held or last is None:
            return False
        return (time.monotonic() - last) * 1000.0 < self.ttl_ms

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        """Acquire the home partitions (waiting out a live holder — a
        misconfigured duplicate shard id idles instead of split-braining)
        and start the renew/sweep loop."""
        self._running = True
        for idx in self.home_shards:
            await self.try_acquire(idx, adopted=False)
        self._task = asyncio.create_task(self._loop())

    async def stop(self, release: bool = True) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if release:
            for idx in list(self._held):
                try:
                    await self.bus.hdel(LEASES_KEY, str(idx))
                except Exception as e:  # noqa: BLE001 — shutdown best-effort
                    log.warning("lease release failed", shard=idx,
                                error=str(e))
                self._count("released")
            self._held.clear()
            self._last_ok.clear()

    def kill(self) -> None:
        """Chaos/test hook: stop renewing WITHOUT releasing anything —
        exactly what a SIGKILLed shard process looks like to the fleet
        (its lease records age out and a survivor adopts them)."""
        self._running = False
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # -- protocol ------------------------------------------------------------
    def _parse(self, raw: str | None) -> dict[str, Any] | None:
        if not raw:
            return None
        try:
            rec = json.loads(raw)
            return rec if isinstance(rec, dict) else None
        except Exception:
            return None

    def _live(self, rec: dict[str, Any], now: float) -> bool:
        ttl = float(rec.get("ttlMs") or self.ttl_ms)
        return (now - float(rec.get("renewedAt") or 0)) * 1000.0 < ttl

    async def partition_orphaned(self, idx: int) -> bool:
        """True when the partition currently has NO live lease holder —
        the owner-less window between a shard death and adoption. Used by
        the submit fan-in: a job arriving for an orphaned partition is
        parked straight into the durable queue record so the eventual
        adopter replays it instead of every shard dropping it. Errs
        toward False (a degraded bus must not make everyone think the
        partition is free)."""
        try:
            cur = self._parse(await self.bus.hget(LEASES_KEY, str(idx)))
        except Exception:  # noqa: BLE001
            return False
        return cur is None or not self._live(cur, time.time())

    async def try_acquire(self, idx: int, adopted: bool) -> bool:
        """One write → settle → read-back-verify acquisition attempt.

        The read-back runs TWICE with a settle window between: a racing
        candidate whose write lands after our first verification is
        caught by the second, so both-believe-they-won requires the
        loser's write to straggle past two settle windows (per-member
        deterministic lengths, so the candidates never settle in
        lockstep). The residual overlap is bounded by one renew interval
        (the next renewal reads a foreign record and deposes) and backed
        by the worker-side duplicate-assignment drop — an overlapped
        dispatch is ignored by a worker already running the job."""
        try:
            cur = self._parse(await self.bus.hget(LEASES_KEY, str(idx)))
            now = time.time()
            if cur is not None and cur.get("owner") != self.member_id \
                    and self._live(cur, now):
                return False  # live foreign lease — not adoptable
            epoch = int((cur or {}).get("epoch") or 0) + 1
            rec = {"owner": self.member_id, "epoch": epoch,
                   "renewedAt": now, "ttlMs": self.ttl_ms}
            await self.bus.hset(LEASES_KEY, str(idx), json.dumps(rec))
            for _ in range(2):
                await asyncio.sleep(self.settle_s)
                back = self._parse(await self.bus.hget(LEASES_KEY,
                                                       str(idx)))
                if back is None or back.get("owner") != self.member_id \
                        or int(back.get("epoch") or 0) != epoch:
                    return False  # lost the settle race — later writer won
        except Exception as e:  # noqa: BLE001 — bus failure = no lease
            log.warning("lease acquisition failed", shard=idx, error=str(e))
            return False
        self._held[idx] = epoch
        self._last_ok[idx] = time.monotonic()
        self._count("adopted" if adopted else "acquired")
        log.info("shard lease acquired", shard=idx, epoch=epoch,
                 adopted=adopted, member=self.member_id)
        if self.on_acquired is not None:
            ret = self.on_acquired(idx, adopted)
            if asyncio.iscoroutine(ret):
                await ret
        return True

    async def _lose(self, idx: int, reason: str) -> None:
        self._held.pop(idx, None)
        self._last_ok.pop(idx, None)
        self._count(reason)
        log.warning("shard lease lost", shard=idx, reason=reason,
                    member=self.member_id)
        if self.on_lost is not None:
            ret = self.on_lost(idx, reason)
            if asyncio.iscoroutine(ret):
                await ret

    async def _renew(self, idx: int) -> None:
        epoch = self._held.get(idx)
        if epoch is None:
            return
        try:
            cur = self._parse(await self.bus.hget(LEASES_KEY, str(idx)))
            if cur is None or cur.get("owner") != self.member_id \
                    or int(cur.get("epoch") or 0) != epoch:
                # a newer owner (or a newer incarnation of us) holds it
                await self._lose(idx, "deposed")
                return
            cur["renewedAt"] = time.time()
            await self.bus.hset(LEASES_KEY, str(idx), json.dumps(cur))
            self._last_ok[idx] = time.monotonic()
        except Exception as e:  # noqa: BLE001 — renewal may miss a beat
            log.warning("lease renewal failed", shard=idx, error=str(e))
            last = self._last_ok.get(idx, 0.0)
            if (time.monotonic() - last) * 1000.0 >= self.ttl_ms:
                # can't prove ownership anymore — self-fence and drop
                await self._lose(idx, "expired")

    async def _sweep(self) -> None:
        """Adopt any partition whose lease is missing or expired."""
        for idx in range(self.num_shards):
            if idx in self._held:
                continue
            try:
                cur = self._parse(await self.bus.hget(LEASES_KEY, str(idx)))
            except Exception:  # noqa: BLE001 — degraded bus: no adoption
                continue
            if cur is not None and self._live(cur, time.time()) \
                    and cur.get("owner") != self.member_id:
                continue
            await self.try_acquire(idx, adopted=True)

    async def _loop(self) -> None:
        interval = self.renew_ms / 1000.0
        while self._running:
            await asyncio.sleep(interval)
            try:
                for idx in list(self._held):
                    await self._renew(idx)
                await self._sweep()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — loop must survive
                log.error("lease loop iteration failed", error=str(e))
