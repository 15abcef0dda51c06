"""RESP wire-protocol bus client (asyncio, no third-party deps).

Speaks RESP2 to any compatible broker: a real Redis 7 (the reference's bus,
docker-compose.yml service `redis`) or the bundled `gridbusd` broker
(the JAX package's bus/broker.py). Mirrors the reference's 3-connection pattern —
main KV / subscriber / publisher — because a RESP connection in subscribe
mode cannot issue normal commands (server/src/services/RedisService.ts:19-53,
client/src/services/RedisConnectionManager.ts:36-92).

Failure handling:
- ``endpoints`` is an ORDERED broker list (primary first, warm standbys
  after — ``GRIDLLM_BUS_ENDPOINTS``). Every (re)connect walks the list
  from the top: the first usable broker wins, a reachable REPLICA is
  promoted (``FAILOVER``) only after every earlier endpoint failed, and
  a resurrected stale primary is fenced off (``FENCE`` with the newer
  epoch demotes it) instead of split-braining the KV state. Endpoint
  switches count in ``gridllm_bus_failovers_total``.
- main/publisher connections reconnect lazily inside ``command`` (one retry
  per call) — a broker restart or failover does not permanently poison
  KV/publish.
- the subscriber connection reconnects with NEVER-GIVE-UP capped
  exponential backoff with full jitter (a transient outage must never
  permanently kill the push loop), re-issues all subscriptions, and
  RESUMEs every durable channel from its last-seen seq — the broker
  replays the gap and the per-channel dedupe below drops overlap, so
  consumer-observed delivery is exactly-once across a broker bounce.
  While down, ``gridllm_bus_subscriber_down``/
  ``gridllm_bus_partition_seconds`` expose the partition and
  ``partition_state()`` feeds the registry/scheduler liveness holds.
  On loss it fires ``on_disconnect`` so the worker can publish
  `worker:disconnected` best-effort, mirroring
  RedisConnectionManager.ts:158-179.
- deliveries are strictly ordered per handler (HandlerPump).
- against real Redis (no EPOCH/RESUME commands) the HA layer disables
  itself after the first handshake and everything behaves as before.
"""

from __future__ import annotations

import asyncio
import random
import time
import weakref
from collections import OrderedDict
from typing import Awaitable, Callable

from gridllm_torch.bus.base import (
    Handler,
    HandlerPump,
    MessageBus,
    Subscription,
    channel_class,
    durable_channel,
    record_publish,
    split_seq,
)
from gridllm_torch.obs import metrics as obs
from gridllm_torch.obs.flightrec import default_flight_recorder
from gridllm_torch.utils.logging import get_logger

log = get_logger("bus.resp")

# -- bus-HA instruments (process-global registry) ---------------------------
_FAILOVERS = obs.default_registry().counter(
    "gridllm_bus_failovers_total",
    "Client-observed broker failovers: a bus connection re-established "
    "to a DIFFERENT endpoint in the ordered GRIDLLM_BUS_ENDPOINTS list.",
)
_REPLAYED = obs.default_registry().counter(
    "gridllm_bus_replayed_messages_total",
    "Messages replayed from the broker's durable-channel ring after a "
    "subscriber reconnect (RESUME), by channel class.",
    ("channel",),
)
_SUB_DOWN = obs.default_registry().gauge(
    "gridllm_bus_subscriber_down",
    "1 while this process's bus subscriber connection is down (push "
    "deliveries suspended; liveness verdicts are held).",
)
_PARTITION_SECONDS = obs.default_registry().gauge(
    "gridllm_bus_partition_seconds",
    "Seconds the current bus-session partition has lasted in this "
    "process; 0 while the subscriber session is healthy.",
)

_BUSES: "weakref.WeakSet[RespBus]" = weakref.WeakSet()


def _collect_bus_health() -> None:
    """Scrape-time collector: partition gauges from every live RespBus."""
    now = time.monotonic()
    down = 0
    longest = 0.0
    for bus in list(_BUSES):
        st = bus.partition_state()
        if st.get("degraded") and st.get("since") is not None:
            down = 1
            longest = max(longest, now - float(st["since"]))
    _SUB_DOWN.set(down)
    _PARTITION_SECONDS.set(longest)


obs.default_registry().add_collector("bus_partition", _collect_bus_health)


def encode_command(*args: str | bytes | int | float) -> bytes:
    """RESP array-of-bulk-strings command encoding."""
    out = [f"*{len(args)}\r\n".encode()]
    for a in args:
        b = a if isinstance(a, bytes) else str(a).encode()
        out.append(f"${len(b)}\r\n".encode())
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


class RespProtocolError(Exception):
    pass


async def read_reply(reader: asyncio.StreamReader):
    """Parse one RESP2 reply (simple/error/int/bulk/array, recursively)."""
    line = await reader.readuntil(b"\r\n")
    kind, rest = line[:1], line[1:-2]
    if kind == b"+":
        return rest.decode()
    if kind == b"-":
        raise RespProtocolError(rest.decode())
    if kind == b":":
        return int(rest)
    if kind == b"$":
        n = int(rest)
        if n == -1:
            return None
        data = await reader.readexactly(n + 2)
        return data[:-2].decode("utf-8", errors="replace")
    if kind == b"*":
        n = int(rest)
        if n == -1:
            return None
        return [await read_reply(reader) for _ in range(n)]
    raise RespProtocolError(f"bad RESP type byte: {line!r}")


_CONN_ERRORS = (ConnectionError, asyncio.IncompleteReadError, OSError, EOFError)


class _Conn:
    """One RESP connection with serialized request/reply and lazy reconnect.
    The actual socket + handshake comes from ``connector`` (RespBus owns
    endpoint selection, failover, and fencing)."""

    def __init__(self, name: str,
                 connector: Callable[[], Awaitable[
                     tuple[asyncio.StreamReader, asyncio.StreamWriter]]]):
        self.name = name
        self._connector = connector
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        async with self._lock:
            await self._connect_locked()

    async def _connect_locked(self) -> None:
        await self._close_locked()
        self.reader, self.writer = await self._connector()

    async def close(self) -> None:
        async with self._lock:
            await self._close_locked()

    async def _close_locked(self) -> None:
        if self.writer is not None:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:
                pass
        self.reader = self.writer = None

    def _abandon(self) -> None:
        """Synchronous transport drop for the cancellation path: no
        awaits, so a pending CancelledError cannot re-fire inside the
        cleanup itself."""
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:  # noqa: BLE001
                pass
        self.reader = self.writer = None

    async def command(self, *args: str | bytes | int | float):
        async with self._lock:
            for attempt in range(2):
                try:
                    if self.writer is None:
                        await self._connect_locked()
                    assert self.reader is not None and self.writer is not None
                    self.writer.write(encode_command(*args))
                    await self.writer.drain()
                    return await read_reply(self.reader)
                except asyncio.CancelledError:
                    # Cancelled mid-exchange (caller timeout, task
                    # teardown, a handler unsubscribing its own pump):
                    # the command may already be written and its reply in
                    # flight. Abandon the transport so the NEXT command
                    # reconnects cleanly instead of reading the orphaned
                    # reply as its own — a reply-stream desync poisons
                    # every subsequent command on the connection.
                    self._abandon()
                    raise
                except _CONN_ERRORS:
                    await self._close_locked()
                    if attempt == 1:
                        raise
                    log.warning("connection lost, retrying once",
                                conn=self.name, command=str(args[0]))

    async def send_only(self, *args: str | bytes | int | float) -> None:
        """Write a command without reading its reply. Used on the subscriber
        connection while the push-message pump owns the read side (the pump
        consumes and ignores subscribe/unsubscribe acks)."""
        async with self._lock:
            if self.writer is None:
                raise ConnectionError(f"{self.name}: not connected")
            self.writer.write(encode_command(*args))
            await self.writer.drain()


class RespBus(MessageBus):
    # cap on the per-channel last-seen-seq map (exactly-once dedupe
    # state); oldest channels age out LRU-style
    MAX_SEQ_TRACKED = 8192
    CONNECT_TIMEOUT_S = 2.0

    def __init__(self, host: str = "localhost", port: int = 6379,
                 key_prefix: str = "GridLLM:", password: str | None = None,
                 db: int = 0, reconnect_max_attempts: int = 10,
                 endpoints: list[tuple[str, int]] | None = None):
        super().__init__(key_prefix)
        self.host, self.port = host, port
        self.password, self.db = password, db
        # HISTORICAL name: the subscriber loop no longer gives up (a
        # transient outage once killed the push loop for good); past this
        # many consecutive failures it logs loudly and keeps trying.
        self.reconnect_max_attempts = reconnect_max_attempts
        # ordered endpoint list, primary first (GRIDLLM_BUS_ENDPOINTS);
        # the single (host, port) is the degenerate one-entry list
        self.endpoints: list[tuple[str, int]] = (
            list(endpoints) if endpoints else [(host, port)])
        self._active_ep: int | None = None   # index serving this process
        self._epoch = 0                      # highest fencing epoch seen
        self._ha: bool | None = None         # broker speaks EPOCH/RESUME?
        self._main = _Conn("main", lambda: self._open_connection("main"))
        self._pub = _Conn("publisher",
                          lambda: self._open_connection("publisher"))
        self._sub = _Conn("subscriber",
                          lambda: self._open_connection("subscriber"))
        self._subs: dict[str, list[HandlerPump]] = {}
        self._psubs: dict[str, list[HandlerPump]] = {}
        # per-channel last-seen seq on durable channels: the dedupe half
        # of exactly-once (the broker's RESUME replay is the other half)
        self._last_seq: OrderedDict[str, int] = OrderedDict()
        self._reader_task: asyncio.Task | None = None
        self._closed = False
        # partition-aware liveness: monotonic marks of the
        # current subscriber-session outage and the last recovery
        self._down_since: float | None = None
        self._last_rejoin: float | None = None
        # Set by the worker runtime to publish `worker:disconnected` fast-path
        self.on_disconnect: Callable[[], Awaitable[None]] | None = None
        _BUSES.add(self)

    # -- endpoint selection / fencing handshake -----------------------------
    async def _open_connection(
        self, conn_name: str
    ) -> tuple[asyncio.StreamReader, asyncio.StreamWriter]:
        """Walk the endpoint list from the top and return the first USABLE
        broker connection, fully handshaken (AUTH/SELECT, then the HA
        epoch/fence exchange). List order is the election authority:
        reaching a replica means every preferred endpoint already failed
        this pass, so promoting it is safe-by-construction (no quorum —
        the operator's ordering is the quorum)."""
        last_err: Exception | None = None
        for idx, (host, port) in enumerate(self.endpoints):
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port),
                    self.CONNECT_TIMEOUT_S)
            except (OSError, asyncio.TimeoutError) as e:
                last_err = e if isinstance(e, OSError) else \
                    ConnectionError(f"connect timeout to {host}:{port}")
                continue
            try:
                for cmd in ([("AUTH", self.password)] if self.password
                            else []) + \
                           ([("SELECT", self.db)] if self.db else []):
                    writer.write(encode_command(*cmd))
                    await writer.drain()
                    await read_reply(reader)
                if await self._ha_handshake(reader, writer):
                    if self._active_ep is not None and idx != self._active_ep:
                        _FAILOVERS.inc()
                        default_flight_recorder().record(
                            "bus", "failover", conn=conn_name,
                            endpoint=f"{host}:{port}", epoch=self._epoch)
                        log.warning("bus failover", conn=conn_name,
                                    endpoint=f"{host}:{port}",
                                    epoch=self._epoch)
                    self._active_ep = idx
                    return reader, writer
                last_err = ConnectionError(
                    f"{host}:{port} not usable (stale or unfenceable)")
            except _CONN_ERRORS as e:
                last_err = e
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass
        raise last_err or ConnectionError("no usable bus endpoint")

    async def _ha_handshake(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> bool:
        """EPOCH/FENCE/FAILOVER exchange on a fresh connection. True when
        the broker is usable as the current primary. Against a broker
        without the HA commands (real Redis) the layer memoizes itself
        off and every endpoint is usable as-is."""
        if self._ha is False:
            return True

        async def ask(*args):
            writer.write(encode_command(*args))
            await writer.drain()
            return await read_reply(reader)

        try:
            got = await ask("EPOCH")
        except RespProtocolError:
            # plain Redis: no EPOCH — no fencing, no resume, no promote
            self._ha = False
            return True
        self._ha = True
        if not isinstance(got, list) or len(got) != 2:
            return False
        role, broker_epoch = str(got[0]), int(got[1])
        if role == "stale":
            return False
        if role == "replica":
            # every earlier endpoint failed this pass — promote. A
            # standby that never synced refuses (-NOTSYNCED): promoting
            # an empty broker during a bring-up race (this client booted
            # before the primary) would split-brain, so keep walking /
            # retrying until the real primary arrives.
            try:
                new_epoch = max(self._epoch, broker_epoch) + 1
                promoted = await ask("FAILOVER", new_epoch)
                self._epoch = max(self._epoch, int(promoted))
                await ask("FENCE", self._epoch)
            except RespProtocolError as e:
                log.warning("standby refused promotion", error=str(e))
                return False
            return True
        # primary: fence at the max of both epochs — a FENCE carrying a
        # NEWER epoch than the broker's demotes a resurrected stale
        # primary (raises -STALE) and we move on down the list
        fence_at = max(self._epoch, broker_epoch)
        try:
            await ask("FENCE", fence_at)
        except RespProtocolError as e:
            log.warning("stale primary fenced off", error=str(e),
                        epoch=fence_at)
            return False
        self._epoch = fence_at
        return True

    # -- lifecycle ----------------------------------------------------------
    async def connect(self) -> None:
        """Connect all three links; brief retry so a worker starting alongside
        the broker (compose-style bring-up) doesn't die on the race."""
        self._closed = False
        for conn in (self._main, self._pub, self._sub):
            delay = 0.3
            for attempt in range(5):
                try:
                    await conn.connect()
                    break
                # the full connection-error family, not just OSError: a
                # broker that accepts the TCP handshake and then hangs up
                # mid-handshake (dying broker, broker.accept fault site)
                # surfaces as IncompleteReadError/EOFError
                except _CONN_ERRORS:
                    if attempt == 4:
                        raise
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 3.0)
        self._reader_task = asyncio.create_task(self._sub_reader_loop())
        # Re-establish any subscriptions that predate a reconnect
        # (pump owns the read side now → write-only)
        await self._reissue_subscriptions()

    async def _reissue_subscriptions(self) -> None:
        for channel in list(self._subs):
            if self._ha and channel in self._last_seq:
                # RESUME subscribes AND replays the outage gap atomically
                # broker-side, so replayed frames always precede the
                # first live one — the seq dedupe drops any overlap
                await self._sub.send_only("RESUME", channel,
                                          self._last_seq[channel])
            else:
                await self._sub.send_only("SUBSCRIBE", channel)
        for pattern in list(self._psubs):
            await self._sub.send_only("PSUBSCRIBE", pattern)

    async def disconnect(self) -> None:
        self._closed = True
        # a deliberate close is not a partition: don't leave the gauges
        # (and any liveness holds) pinned on a bus that no longer exists
        self._down_since = None
        if self._reader_task is not None:
            self._reader_task.cancel()
            self._reader_task = None
        for registry in (self._subs, self._psubs):
            for pumps in registry.values():
                for p in pumps:
                    p.stop()
            registry.clear()
        self._last_seq.clear()
        for conn in (self._main, self._pub, self._sub):
            await conn.close()

    async def is_healthy(self) -> bool:
        try:
            return (await self._main.command("PING")) == "PONG"
        except Exception:
            return False

    def partition_state(self) -> dict:
        """Partition-aware liveness feed (bus/base.py liveness_suspended):
        degraded while the subscriber session is down — this process is
        DEAF, so missing heartbeats say nothing about the fleet."""
        return {"degraded": self._down_since is not None,
                "since": self._down_since,
                "lastRejoin": self._last_rejoin}

    def _mark_partition(self) -> None:
        if self._down_since is None:
            self._down_since = time.monotonic()
            _SUB_DOWN.set(1)
            default_flight_recorder().record(
                "bus", "subscriber_down", endpoint=self._active_ep)

    def _mark_rejoin(self) -> None:
        if self._down_since is not None:
            outage_s = time.monotonic() - self._down_since
            self._down_since = None
            self._last_rejoin = time.monotonic()
            _SUB_DOWN.set(0)
            _PARTITION_SECONDS.set(0)
            default_flight_recorder().record(
                "bus", "subscriber_reconnected",
                outageS=round(outage_s, 3), endpoint=self._active_ep)

    async def _sub_reader_loop(self) -> None:
        """Push-message pump for the subscriber connection."""
        backoff = 0.5
        proto_errors = 0
        while not self._closed:
            try:
                assert self._sub.reader is not None
                msg = await read_reply(self._sub.reader)
                backoff = 0.5
                proto_errors = 0
            except asyncio.CancelledError:
                return
            except RespProtocolError as e:
                # a pushed error frame (e.g. RESUME against a broker that
                # lost the ring channel) is not a dead connection — but a
                # run of them means the reply stream is desynced, and
                # that IS one
                proto_errors += 1
                if proto_errors < 10:
                    log.warning("subscriber push error frame",
                                error=str(e))
                    continue
                msg = None
                if not await self._handle_sub_loss(
                        f"protocol desync: {e}", backoff):
                    return
                backoff = min(backoff * 2, 30.0)
                proto_errors = 0
                continue
            except Exception as e:
                if self._closed:
                    return
                if not await self._handle_sub_loss(str(e), backoff):
                    return
                backoff = min(backoff * 2, 30.0)
                continue
            if not isinstance(msg, list) or not msg:
                continue
            kind = msg[0]
            if kind == "message" and len(msg) == 3:
                _, channel, payload = msg
                payload = self._dedupe(channel, payload)
                if payload is None:
                    continue
                for pump in list(self._subs.get(channel, [])):
                    pump.push(channel, payload)
            elif kind == "pmessage" and len(msg) == 4:
                _, pattern, channel, payload = msg
                payload = self._dedupe(channel, payload)
                if payload is None:
                    continue
                for pump in list(self._psubs.get(pattern, [])):
                    pump.push(channel, payload)
            elif (kind == "subscribe" and len(msg) == 3
                    and self._ha and isinstance(msg[2], int)):
                # gridbus acks durable-channel subscribes with the
                # channel's current seq — the resume BASELINE. Without
                # it, a channel that never delivered before an outage
                # (a job's result channel) could not RESUME and anything
                # published during the gap would be silently lost.
                channel = str(msg[1])
                if durable_channel(channel) \
                        and channel not in self._last_seq:
                    self._note_seq(channel, int(msg[2]))
            elif kind == "resume" and len(msg) == 4:
                # broker's replay ack: [resume, channel, replayed, lost]
                _, channel, replayed, lost = msg
                if int(replayed):
                    _REPLAYED.inc(int(replayed),
                                  channel=channel_class(str(channel)))
                if int(lost) < 0:
                    # the broker lost its seq history (restart with no
                    # standby, counter eviction) and we are AHEAD of it:
                    # void the watermark — keeping it would drop every
                    # new message as a "duplicate" until the broker's
                    # fresh counter overtook it, silently muting the
                    # channel. The gap itself is unknowable; the
                    # at-least-once sweeps own it.
                    self._last_seq.pop(str(channel), None)
                    log.warning("bus seq history lost; watermark voided",
                                channel=str(channel))
                    default_flight_recorder().record(
                        "bus", "seq_reset", channel=str(channel))
                elif int(lost):
                    # the outage outran the replay ring: at-least-once
                    # degrades to the sweep/retry machinery for the hole
                    log.warning("bus resume gap (ring outrun)",
                                channel=str(channel), lost=int(lost))
                    default_flight_recorder().record(
                        "bus", "resume_gap", channel=str(channel),
                        lost=int(lost))
            # subscribe/unsubscribe acks: ignore

    def _note_seq(self, channel: str, seq: int) -> None:
        if channel in self._last_seq:
            self._last_seq.move_to_end(channel)
        self._last_seq[channel] = seq
        while len(self._last_seq) > self.MAX_SEQ_TRACKED:
            self._last_seq.popitem(last=False)

    def _dedupe(self, channel: str, payload: str) -> str | None:
        """Strip the broker's seq framing and drop already-seen messages
        (replay overlap, duplicated deliveries across a failover). None
        means drop; a payload without framing passes through untouched."""
        seq, body = split_seq(payload)
        if seq is None:
            return payload
        last = self._last_seq.get(channel)
        if last is not None and seq <= last:
            return None  # duplicate of something already delivered
        self._note_seq(channel, seq)
        return body

    async def _handle_sub_loss(self, error: str, delay: float) -> bool:
        """One subscriber-session outage: mark the partition, fire the
        disconnect hook, reconnect forever (capped backoff, full jitter).
        Returns False only when the bus is being closed."""
        log.warning("subscriber connection lost, reconnecting", error=error)
        self._mark_partition()
        if self.on_disconnect is not None:
            try:
                await self.on_disconnect()
            except Exception:
                pass
        ok = await self._reconnect_sub(delay)
        if ok:
            self._mark_rejoin()
        return ok

    async def _reconnect_sub(self, delay: float) -> bool:
        """Never-give-up reconnect: full-jitter capped
        exponential backoff, looping until the bus closes. The old
        10-attempts-then-dead behavior turned a 30-second broker outage
        into a permanently deaf process with only a log line to show."""
        attempt = 0
        while not self._closed:
            attempt += 1
            await asyncio.sleep(delay * random.random())  # full jitter
            try:
                await self._sub.connect()  # closes the stale transport first
                await self._reissue_subscriptions()
                log.info("subscriber reconnected", attempt=attempt)
                return True
            except Exception as e:  # noqa: BLE001 — keep trying
                if attempt == self.reconnect_max_attempts:
                    log.error(
                        "subscriber still down; continuing to retry",
                        attempts=attempt, error=str(e))
                delay = min(max(delay, 0.25) * 2, 30.0)
        return False

    # -- KV -----------------------------------------------------------------
    async def get(self, key: str) -> str | None:
        return await self._main.command("GET", self._k(key))

    async def set(self, key: str, value: str) -> None:
        await self._main.command("SET", self._k(key), value)

    async def set_with_expiry(self, key: str, value: str, ttl_s: float) -> None:
        # PX for sub-second TTLs (heartbeat TTL = 2× interval)
        await self._main.command("SET", self._k(key), value, "PX", int(ttl_s * 1000))

    async def delete(self, key: str) -> None:
        await self._main.command("DEL", self._k(key))

    async def ttl(self, key: str) -> int:
        return int(await self._main.command("TTL", self._k(key)))

    # -- hash ---------------------------------------------------------------
    async def hget(self, key: str, field: str) -> str | None:
        return await self._main.command("HGET", self._k(key), field)

    async def hset(self, key: str, field: str, value: str) -> None:
        await self._main.command("HSET", self._k(key), field, value)

    async def hgetall(self, key: str) -> dict[str, str]:
        flat = await self._main.command("HGETALL", self._k(key)) or []
        return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}

    async def hdel(self, key: str, field: str) -> None:
        await self._main.command("HDEL", self._k(key), field)

    # -- pub/sub ------------------------------------------------------------
    async def publish(self, channel: str, message: str) -> int:
        # HLC-framed by record_publish; the broker's seq
        # framing wraps OUTSIDE this, so _dedupe strips seq first and
        # the HandlerPump strips + merges the surviving HLC frame
        message = record_publish(channel, message) or message
        return int(await self._pub.command("PUBLISH", channel, message))

    async def subscribe(self, channel: str, handler: Handler) -> Subscription:
        pump = HandlerPump(handler)
        first = channel not in self._subs
        self._subs.setdefault(channel, []).append(pump)
        if first:
            await self._sub.send_only("SUBSCRIBE", channel)

        async def _unsub() -> None:
            lst = self._subs.get(channel, [])
            if pump in lst:
                lst.remove(pump)
            pump.stop()
            if not lst:
                self._subs.pop(channel, None)
                self._last_seq.pop(channel, None)
                try:
                    await self._sub.send_only("UNSUBSCRIBE", channel)
                except Exception:
                    pass

        return Subscription(_unsub, channel)

    async def psubscribe(self, pattern: str, handler: Handler) -> Subscription:
        pump = HandlerPump(handler)
        first = pattern not in self._psubs
        self._psubs.setdefault(pattern, []).append(pump)
        if first:
            await self._sub.send_only("PSUBSCRIBE", pattern)

        async def _unsub() -> None:
            lst = self._psubs.get(pattern, [])
            if pump in lst:
                lst.remove(pump)
            pump.stop()
            if not lst:
                self._psubs.pop(pattern, None)
                try:
                    await self._sub.send_only("PUNSUBSCRIBE", pattern)
                except Exception:
                    pass

        return Subscription(_unsub, pattern)
