"""In-memory bus: single-process deployments and the unit-test fake.

SURVEY.md §4 calls for "an in-memory fake bus" so scheduler-policy tests need
no Redis/TPU. This is also a real deployment mode: gateway + scheduler +
worker in one process (the minimum end-to-end slice, SURVEY.md §7 step 4).

Delivery semantics mirror Redis pub/sub: fire-and-forget from the publisher's
point of view, asynchronous, strictly ordered per subscriber (HandlerPump).
``flush()`` drains in-flight deliveries (tests).
"""

from __future__ import annotations

import fnmatch
import time

from gridllm_torch.bus.base import (
    Handler,
    HandlerPump,
    MessageBus,
    Subscription,
    record_publish,
)


class InMemoryBus(MessageBus):
    def __init__(self, key_prefix: str = "GridLLM:"):
        super().__init__(key_prefix)
        self._kv: dict[str, str] = {}
        self._expiry: dict[str, float] = {}          # key → monotonic deadline
        self._hashes: dict[str, dict[str, str]] = {}
        self._subs: dict[str, list[HandlerPump]] = {}   # channel → pumps
        self._psubs: dict[str, list[HandlerPump]] = {}  # pattern → pumps
        self._connected = False

    # -- lifecycle ----------------------------------------------------------
    async def connect(self) -> None:
        self._connected = True

    async def disconnect(self) -> None:
        self._connected = False
        for registry in (self._subs, self._psubs):
            for pumps in registry.values():
                for p in pumps:
                    p.stop()
            registry.clear()

    async def is_healthy(self) -> bool:
        return self._connected

    # -- KV -----------------------------------------------------------------
    def _expired(self, key: str) -> bool:
        dl = self._expiry.get(key)
        if dl is not None and time.monotonic() >= dl:
            self._kv.pop(key, None)
            self._hashes.pop(key, None)
            self._expiry.pop(key, None)
            return True
        return False

    async def get(self, key: str) -> str | None:
        key = self._k(key)
        if self._expired(key):
            return None
        return self._kv.get(key)

    async def set(self, key: str, value: str) -> None:
        key = self._k(key)
        self._kv[key] = value
        self._expiry.pop(key, None)

    async def set_with_expiry(self, key: str, value: str, ttl_s: float) -> None:
        key = self._k(key)
        self._kv[key] = value
        self._expiry[key] = time.monotonic() + ttl_s

    async def delete(self, key: str) -> None:
        key = self._k(key)
        self._kv.pop(key, None)
        self._hashes.pop(key, None)
        self._expiry.pop(key, None)

    async def ttl(self, key: str) -> int:
        key = self._k(key)
        if self._expired(key) or (key not in self._kv and key not in self._hashes):
            return -2
        dl = self._expiry.get(key)
        if dl is None:
            return -1
        return max(0, int(dl - time.monotonic()))

    # -- hash ---------------------------------------------------------------
    async def hget(self, key: str, field: str) -> str | None:
        return self._hashes.get(self._k(key), {}).get(field)

    async def hset(self, key: str, field: str, value: str) -> None:
        self._hashes.setdefault(self._k(key), {})[field] = value

    async def hgetall(self, key: str) -> dict[str, str]:
        return dict(self._hashes.get(self._k(key), {}))

    async def hdel(self, key: str, field: str) -> None:
        self._hashes.get(self._k(key), {}).pop(field, None)

    # -- pub/sub ------------------------------------------------------------
    async def publish(self, channel: str, message: str) -> int:
        # HLC-framed by record_publish; pumps strip + merge
        message = record_publish(channel, message) or message
        pumps: list[HandlerPump] = list(self._subs.get(channel, []))
        for pattern, phs in self._psubs.items():
            if fnmatch.fnmatchcase(channel, pattern):
                pumps.extend(phs)
        for p in pumps:
            p.push(channel, message)
        return len(pumps)

    async def subscribe(self, channel: str, handler: Handler) -> Subscription:
        pump = HandlerPump(handler)
        self._subs.setdefault(channel, []).append(pump)

        async def _unsub() -> None:
            lst = self._subs.get(channel, [])
            if pump in lst:
                lst.remove(pump)
            pump.stop()
            if not lst:
                self._subs.pop(channel, None)

        return Subscription(_unsub, channel)

    async def psubscribe(self, pattern: str, handler: Handler) -> Subscription:
        pump = HandlerPump(handler)
        self._psubs.setdefault(pattern, []).append(pump)

        async def _unsub() -> None:
            lst = self._psubs.get(pattern, [])
            if pump in lst:
                lst.remove(pump)
            pump.stop()
            if not lst:
                self._psubs.pop(pattern, None)

        return Subscription(_unsub, pattern)

    # -- test helper --------------------------------------------------------
    async def flush(self) -> None:
        """Await all in-flight deliveries (and any they trigger)."""
        for _ in range(50):
            pumps = [p for lst in (*self._subs.values(), *self._psubs.values()) for p in lst]
            for p in pumps:
                await p.drain()  # waits for queued AND in-flight handler calls
            # handlers may have published more, possibly to new subscriptions
            pumps = [p for lst in (*self._subs.values(), *self._psubs.values()) for p in lst]
            if all(p.queue.empty() and p.queue._unfinished_tasks == 0 for p in pumps):  # type: ignore[attr-defined]
                break
