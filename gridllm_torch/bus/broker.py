"""gridbus: a minimal RESP2 broker (pure asyncio), the port's copy of the
JAX package's bus/broker.py, the same on the wire and on disk: its
replies are byte-equal to that broker's, and either broker replays the
other's append-only file.

It covers exactly the command subset the GridLLM protocol uses: PING,
GET/SET(+PX/EX)/DEL/TTL/EXISTS, HGET/HSET/HGETALL/HDEL, PUBLISH/SUBSCRIBE/
UNSUBSCRIBE/PSUBSCRIBE/PUNSUBSCRIBE, AUTH/SELECT (accepted, no-op). Real
Redis remains fully compatible (RespBus speaks standard RESP2); this
broker exists so a multi-process cluster runs with no external
dependency.

``--aof PATH`` enables append-only persistence. Mutating KV/hash commands
append one JSON line, flushed per write and fsync'd at most once per
second (Redis's `everysec` durability); on start the log is replayed
(expiries stored as absolute wall deadlines, already-expired keys
dropped) and compacted to a snapshot.

High availability, three extensions beyond Redis's command subset, all
optional (RespBus degrades gracefully against real Redis):

- **Resumable channels.** Durable channel classes (``durable_channel`` in
  bus/base.py: job results, stream frames, ``job:snapshot``,
  ``job:handoff``, ``job:drain``, ``kvx:*``, ``ctrl:submit``) get a
  per-channel monotonic sequence number framed into every delivered
  payload plus a bounded replay ring (``--ring-cap`` messages/channel).
  ``RESUME <ch> <seq>`` on a subscriber connection replays everything
  after ``seq`` and acks with ``["resume", ch, replayed, lost]``: a
  reconnecting subscriber recovers the outage gap instead of silently
  losing it.
- **Warm-standby replication.** ``--replicaof host:port`` starts the
  broker as a follower: it connects to the primary over the normal RESP
  port, issues ``SYNC``, applies the snapshot, then tails the live
  record stream (mutations AND durable publishes with their seqs, so
  RESUME works against the standby after failover). A replica answers
  reads/subscribes but rejects mutations with ``-READONLY``.
- **Fencing epochs.** The primary carries an epoch (persisted in the
  AOF). Clients learn it via ``EPOCH`` (-> [role, epoch]) and fence each
  connection with ``FENCE <epoch>``; a FENCE carrying a HIGHER epoch
  than the broker's proves a newer primary was elected while this one
  was away: the broker marks itself stale and refuses every further
  mutation/publish, so a resurrected stale primary cannot split-brain
  the KV state (``active_jobs``, registry hashes). ``FAILOVER <epoch>``
  promotes a replica: it stops tailing and becomes the primary at that
  epoch. Election is client-driven by endpoint-list order (no quorum):
  the operator lists the real primary first, and a client only promotes
  a standby after every earlier endpoint failed.

Run: ``python -m gridllm_torch.bus.broker --host 127.0.0.1 --port 6379
[--aof bus.aof] [--replicaof host:port] [--ring-cap N]``
"""

from __future__ import annotations

import argparse
import asyncio
import fnmatch
import json
import os
import time
from collections import OrderedDict, deque

from gridllm_torch import faults
from gridllm_torch.bus.base import durable_channel, encode_seq
from gridllm_torch.utils.logging import get_logger

log = get_logger("bus.broker")


def _bulk(s: str | None) -> bytes:
    if s is None:
        return b"$-1\r\n"
    b = s.encode()
    return b"$%d\r\n%s\r\n" % (len(b), b)


def _arr(items: list[bytes]) -> bytes:
    return b"*%d\r\n%s" % (len(items), b"".join(items))


def _int(n: int) -> bytes:
    return b":%d\r\n" % n


OK = b"+OK\r\n"
PONG = b"+PONG\r\n"

# commands that mutate KV/hash state — the fencing + replica gates apply
_MUTATING = frozenset(("SET", "SETEX", "DEL", "HSET", "HDEL"))


class GridBusBroker:
    def __init__(self, aof_path: str | None = None,
                 replica_of: tuple[str, int] | None = None,
                 ring_cap: int = 512) -> None:
        self._kv: dict[str, str] = {}
        self._expiry: dict[str, float] = {}
        self._hashes: dict[str, dict[str, str]] = {}
        # channel/pattern → set of client writers
        self._subs: dict[str, set[asyncio.StreamWriter]] = {}
        self._psubs: dict[str, set[asyncio.StreamWriter]] = {}
        self._clients: set[asyncio.StreamWriter] = {*()}
        self._server: asyncio.AbstractServer | None = None
        self._aof_path = aof_path
        self._aof = None  # open append handle when persistence is on
        self._last_fsync = 0.0
        # -- HA state ----------------------------------------------------------
        # per-durable-channel monotonic seq + bounded replay ring of
        # (seq, payload); channels LRU-capped so per-job channels don't
        # accumulate forever on a long-lived broker. The seq counters
        # outlive their rings (and at 16x the ring-channel cap): a
        # counter that reset while a long-lived subscriber still held
        # its old watermark would mute the channel — every new message
        # seq <= watermark, silently dropped as a duplicate.
        self.ring_cap = max(int(ring_cap), 1)
        self._rings: OrderedDict[str, deque[tuple[int, str]]] = OrderedDict()
        self._seq: OrderedDict[str, int] = OrderedDict()
        self.MAX_RING_CHANNELS = 4096
        self.MAX_SEQ_CHANNELS = 65536
        # fencing: role/epoch/stale plus each connection's fenced epoch
        self.role = "replica" if replica_of else "primary"
        self.epoch = 1
        self.stale = False
        self._conn_epoch: dict[asyncio.StreamWriter, int] = {}
        # replication: live follower links (SYNC'd connections) on the
        # primary; the follower's own tail task + upstream address
        self._replicas: set[asyncio.StreamWriter] = set()
        self._replica_of = replica_of
        self._repl_task: asyncio.Task | None = None
        self.repl_synced = False  # follower: snapshot fully applied

    # -- kv helpers ---------------------------------------------------------
    def _expired(self, key: str) -> bool:
        dl = self._expiry.get(key)
        if dl is not None and time.monotonic() >= dl:
            self._kv.pop(key, None)
            self._expiry.pop(key, None)
            return True
        return False

    # -- persistence (AOF) + replication forwarding -------------------------
    def _wall_deadline(self, key: str) -> float | None:
        """Monotonic expiry → absolute wall time for the log."""
        dl = self._expiry.get(key)
        return None if dl is None else time.time() + (dl - time.monotonic())

    def _log(self, rec: dict) -> None:
        if self._aof is None:
            return
        self._aof.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._aof.flush()
        now = time.monotonic()
        if now - self._last_fsync >= 1.0:  # Redis `everysec`
            if faults.check("broker.fsync"):
                # injected durability stall: the fsync blocks the event
                # loop the way a saturated disk does — every client's
                # command round-trip freezes for the stall window
                time.sleep(0.4)
            os.fsync(self._aof.fileno())
            self._last_fsync = now

    def _record(self, rec: dict) -> None:
        """One mutation record: persist (when AOF on) AND forward to every
        live replica link. Replication is independent of persistence —
        a diskless primary still feeds its warm standby."""
        self._log(rec)
        if self._replicas:
            frame = _arr([_bulk("repl"),
                          _bulk(json.dumps(rec, separators=(",", ":")))])
            for w in list(self._replicas):
                if not self._try_write(w, frame):
                    self._replicas.discard(w)

    def _apply(self, rec: dict) -> None:
        op = rec["op"]
        if op == "set":
            self._kv[rec["k"]] = rec["v"]
            self._expiry.pop(rec["k"], None)
            exp = rec.get("exp")
            if exp is not None:
                remaining = exp - time.time()
                if remaining <= 0:
                    self._kv.pop(rec["k"], None)
                else:
                    self._expiry[rec["k"]] = time.monotonic() + remaining
        elif op == "del":
            for k in rec["ks"]:
                self._kv.pop(k, None)
                self._expiry.pop(k, None)
                self._hashes.pop(k, None)
        elif op == "hset":
            self._hashes.setdefault(rec["k"], {}).update(rec["fv"])
        elif op == "hdel":
            h = self._hashes.get(rec["k"], {})
            for f in rec["fs"]:
                h.pop(f, None)
        elif op == "epoch":
            self.epoch = max(self.epoch, int(rec["v"]))
        elif op == "stale":
            # a fencing demotion survives restarts: without this a
            # supervisor-restarted old primary would come back willing
            # to take writes at its pre-failover epoch (split-brain)
            self.stale = True
        elif op == "pub":
            # replicated durable publish: adopt the primary's seq into
            # our own ring (RESUME keeps working after a failover) and
            # deliver to any local subscribers
            ch, msg, seq = rec["ch"], rec["m"], int(rec["seq"])
            cur = self._seq.get(ch, 0)
            if seq > cur:
                if ch in self._seq:
                    self._seq.move_to_end(ch)
                self._seq[ch] = seq
                while len(self._seq) > self.MAX_SEQ_CHANNELS:
                    self._seq.popitem(last=False)
                self._ring(ch).append((seq, msg))
                self._deliver(ch, encode_seq(seq, msg))

    # -- replay rings -------------------------------------------------------
    def _ring(self, channel: str) -> deque[tuple[int, str]]:
        ring = self._rings.get(channel)
        if ring is None:
            ring = deque(maxlen=self.ring_cap)
            self._rings[channel] = ring
            # evict the RING only, never its seq counter: a rarely-
            # published durable channel (job:drain) whose counter reset
            # would restart at seq 1 and long-lived subscribers would
            # drop every message as a stale duplicate
            while len(self._rings) > self.MAX_RING_CHANNELS:
                self._rings.popitem(last=False)
        else:
            self._rings.move_to_end(channel)
        return ring

    def _next_seq(self, channel: str) -> int:
        seq = self._seq.get(channel, 0) + 1
        if channel in self._seq:
            self._seq.move_to_end(channel)
        self._seq[channel] = seq
        while len(self._seq) > self.MAX_SEQ_CHANNELS:
            self._seq.popitem(last=False)
        return seq

    def _replay_and_compact(self) -> None:
        path = self._aof_path
        assert path is not None
        n = 0
        src = path
        if not os.path.exists(path) and os.path.exists(path + ".bak"):
            # A crash in a previous compaction's window between snapshotting
            # the log to .bak and publishing the compacted replacement can
            # leave no file at `path`. The .bak holds the full pre-compaction
            # state — replay it rather than silently starting empty.
            log.warning("aof: missing, recovering from .bak", path=path)
            src = path + ".bak"
        if os.path.exists(src):
            with open(src) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            records = []
            bad_at = None
            for i, line in enumerate(lines):
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    bad_at = i
                    break
            if bad_at is not None and bad_at != len(lines) - 1:
                # Redis's aof-load-truncated policy: a torn FINAL line
                # (crash mid-append) is expected and dropped; corruption
                # in the middle means the file is damaged and replaying a
                # prefix (then compacting over the original!) would
                # silently destroy every good record after it. Refuse.
                raise RuntimeError(
                    f"aof: corrupt record {bad_at + 1}/{len(lines)} in "
                    f"{src} (not a torn tail) — refusing to start; "
                    "repair or remove the file (remove its .bak too, or "
                    "startup will recover the pre-compaction state from it)"
                )
            if bad_at is not None:
                log.warning("aof: dropping torn final record", path=src)
            for rec in records:
                try:
                    self._apply(rec)
                    n += 1
                except KeyError:
                    raise RuntimeError(
                        f"aof: malformed record in {src} — refusing to "
                        "start; repair or remove the file (remove its .bak "
                        "too, or startup will recover state from it)"
                    ) from None
        # Compact: current state as a fresh log. Ordering matters for crash
        # safety — the compacted snapshot is fully written + fsync'd BEFORE
        # the original is touched, so some replayable file exists at every
        # instant: a crash before the .bak rename leaves `path` intact; a
        # crash between the two renames leaves .bak (recovered above); the
        # final os.replace is atomic.
        tmp = path + ".compact"
        with open(tmp, "w") as f:
            for rec in self._snapshot_records():
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if src == path and os.path.exists(path):
            # the pre-compaction log survives as .bak until the NEXT
            # successful compaction — the snapshot rewrite must never be
            # the only copy of the state it was derived from
            os.replace(path, path + ".bak")
        os.replace(tmp, path)
        self._aof = open(path, "a")
        log.info("aof: replayed and compacted", path=path, records=n,
                 keys=len(self._kv), hashes=len(self._hashes))

    def _snapshot_records(self, include_rings: bool = False) -> list[dict]:
        """Current state as replayable records: the AOF compactor and the
        SYNC snapshot share this shape (SYNC adds the replay rings so a
        standby can serve RESUME for pre-attach messages)."""
        out: list[dict] = [{"op": "epoch", "v": self.epoch}]
        if self.stale:
            out.append({"op": "stale"})
        for k, v in list(self._kv.items()):  # _expired() pops from _kv
            if self._expired(k):
                continue
            rec = {"op": "set", "k": k, "v": v}
            exp = self._wall_deadline(k)
            if exp is not None:
                rec["exp"] = exp
            out.append(rec)
        for k, h in self._hashes.items():
            if h:
                out.append({"op": "hset", "k": k, "fv": h})
        if include_rings:
            for ch, ring in self._rings.items():
                for seq, msg in ring:
                    out.append({"op": "pub", "ch": ch, "m": msg, "seq": seq})
        return out

    # -- replication (follower side) ----------------------------------------
    async def _replicate_loop(self) -> None:
        """Tail the primary: SYNC, apply the snapshot, then stream live
        records. Reconnects with capped backoff while still a replica —
        promotion (FAILOVER) cancels this task."""
        from gridllm_torch.bus.resp import encode_command, read_reply

        assert self._replica_of is not None
        host, port = self._replica_of
        delay = 0.3
        while self.role == "replica":
            try:
                reader, writer = await asyncio.open_connection(host, port)
            except OSError:
                await asyncio.sleep(delay)
                delay = min(delay * 2, 5.0)
                continue
            try:
                writer.write(encode_command("SYNC"))
                await writer.drain()
                # the incoming snapshot is the FULL primary state: start
                # from empty so keys deleted on the primary during a
                # replication gap cannot resurrect here after a failover.
                # repl_synced drops with it — an EMPTY standby whose
                # re-sync died mid-snapshot must refuse promotion until
                # a snapshot lands again (the -NOTSYNCED gate)
                self.repl_synced = False
                self._kv.clear()
                self._expiry.clear()
                self._hashes.clear()
                self._rings.clear()
                self._seq.clear()
                delay = 0.3
                while self.role == "replica":
                    frame = await read_reply(reader)
                    if (not isinstance(frame, list) or len(frame) != 2
                            or frame[0] != "repl"):
                        continue
                    rec = json.loads(frame[1])
                    if rec.get("op") == "synced":
                        self.repl_synced = True
                        log.info("replica: snapshot applied, tailing",
                                 primary=f"{host}:{port}")
                        continue
                    self._apply(rec)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — link loss: retry
                if self.role == "replica":
                    log.warning("replica: link to primary lost",
                                error=str(e))
            finally:
                try:
                    writer.close()
                except Exception:  # noqa: BLE001
                    pass
            await asyncio.sleep(delay)
            delay = min(delay * 2, 5.0)

    # -- server -------------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 6379) -> None:
        if self._aof_path:
            self._replay_and_compact()
        self._server = await asyncio.start_server(self._client, host, port)
        if self._replica_of is not None and self.role == "replica":
            self._repl_task = asyncio.create_task(self._replicate_loop())
        log.info("gridbus broker listening", host=host, port=port,
                 role=self.role, epoch=self.epoch)

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._repl_task is not None:
            self._repl_task.cancel()
            self._repl_task = None
        if self._server is not None:
            self._server.close()
            # Close live client connections too: since Python 3.12.1
            # Server.wait_closed() blocks until all handlers finish.
            for w in list(self._clients):
                try:
                    w.close()
                except Exception:
                    pass
            await self._server.wait_closed()
            self._server = None
        if self._aof is not None:
            try:
                self._aof.flush()
                os.fsync(self._aof.fileno())
            finally:
                self._aof.close()
                self._aof = None

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    MAX_BULK = 64 * 1024 * 1024  # guard against absurd $<len> headers

    async def _read_command(self, reader: asyncio.StreamReader) -> list[str] | None:
        """Returns None to close the connection (EOF or malformed frame)."""
        try:
            line = await reader.readuntil(b"\r\n")
            if not line.startswith(b"*"):
                # inline command (telnet-style)
                parts = line.strip().split()
                return [p.decode("utf-8", errors="replace") for p in parts] if parts else []
            n = int(line[1:-2])
            if n < 0 or n > 1024:
                return None
            args: list[str] = []
            for _ in range(n):
                hdr = await reader.readuntil(b"\r\n")
                if not hdr.startswith(b"$"):
                    return None
                ln = int(hdr[1:-2])
                if ln < 0 or ln > self.MAX_BULK:
                    return None
                data = await reader.readexactly(ln + 2)
                args.append(data[:-2].decode("utf-8", errors="replace"))
            return args
        except (asyncio.IncompleteReadError, ConnectionResetError, ValueError,
                asyncio.LimitOverrunError):
            return None

    async def _client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        if faults.check("broker.accept"):
            # injected accept-drop: the TCP handshake succeeded but the
            # broker hangs up before reading a byte — what a dying broker
            # (or a connection-table-exhausted one) looks like to clients
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass
            return
        self._clients.add(writer)
        try:
            while True:
                args = await self._read_command(reader)
                if args is None:
                    break
                if not args:
                    continue
                reply = self._execute(args, writer)
                if reply is not None:
                    if faults.check("broker.reply"):
                        # injected mid-reply reset: half the reply lands,
                        # then the connection dies — the client's reply
                        # stream is torn exactly where a crashing broker
                        # tears it
                        writer.write(reply[: max(1, len(reply) // 2)])
                        break
                    writer.write(reply)
                    await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError, BrokenPipeError):
            pass
        finally:
            self._clients.discard(writer)
            self._replicas.discard(writer)
            self._conn_epoch.pop(writer, None)
            self._drop_client(writer)
            writer.close()

    def _drop_client(self, writer: asyncio.StreamWriter) -> None:
        for registry in (self._subs, self._psubs):
            empty = []
            for target, clients in registry.items():
                clients.discard(writer)
                if not clients:
                    empty.append(target)
            for t in empty:
                registry.pop(t, None)

    # -- command dispatch ---------------------------------------------------
    def _gate_mutation(self, writer: asyncio.StreamWriter) -> bytes | None:
        """Fencing + role gate for mutating commands/publishes: a stale
        primary refuses everything (a newer epoch exists somewhere), a
        replica refuses writes, and a connection fenced at an older epoch
        than the broker's is a laggard from before the failover."""
        if self.stale:
            return (b"-STALE write refused: fenced at epoch %d, a newer "
                    b"primary exists\r\n" % self.epoch)
        if self.role == "replica":
            return b"-READONLY replica; FAILOVER to promote\r\n"
        fenced = self._conn_epoch.get(writer)
        if fenced is not None and fenced < self.epoch:
            return (b"-FENCED connection epoch %d behind broker epoch "
                    b"%d\r\n" % (fenced, self.epoch))
        return None

    def _execute(self, args: list[str], writer: asyncio.StreamWriter) -> bytes | None:
        cmd = args[0].upper()
        a = args[1:]
        if cmd == "PING":
            return PONG
        if cmd in ("AUTH", "SELECT"):
            return OK
        if cmd == "EPOCH":
            return _arr([_bulk(self.role if not self.stale else "stale"),
                         _int(self.epoch)])
        if cmd == "FENCE":
            try:
                e = int(a[0])
            except (IndexError, ValueError):
                return b"-ERR FENCE requires an integer epoch\r\n"
            if e > self.epoch:
                # proof of a newer primary: demote self permanently (until
                # an operator rebuilds this broker from the new primary) —
                # persisted, so a supervisor restart cannot resurrect a
                # fenced-off primary as a willing write target
                if self.role == "primary" and not self.stale:
                    self.stale = True
                    self._record({"op": "stale"})
                    log.warning("fenced by newer epoch; now stale",
                                mine=self.epoch, theirs=e)
                return (b"-STALE fenced: my epoch %d < %d\r\n"
                        % (self.epoch, e))
            if self.stale:
                return (b"-STALE write refused: fenced at epoch %d\r\n"
                        % self.epoch)
            if e < self.epoch:
                return (b"-EPOCH behind: current epoch is %d\r\n"
                        % self.epoch)
            self._conn_epoch[writer] = e
            return OK
        if cmd == "FAILOVER":
            try:
                e = int(a[0]) if a else self.epoch + 1
            except ValueError:
                return b"-ERR FAILOVER requires an integer epoch\r\n"
            if self.stale:
                return (b"-STALE cannot promote a fenced broker "
                        b"(epoch %d)\r\n" % self.epoch)
            if self.role == "replica" and not self.repl_synced:
                # a standby that NEVER reached its primary holds no state
                # — promoting it during a bring-up race (client boots
                # before the primary) would split-brain an empty broker
                # against the real one. Clients keep walking the list
                # until the primary arrives or a synced standby exists.
                return (b"-NOTSYNCED replica never synced with its "
                        b"primary; refusing promotion\r\n")
            if self.role == "replica":
                self.role = "primary"
                self.epoch = max(self.epoch + 1, e)
                if self._repl_task is not None:
                    self._repl_task.cancel()
                    self._repl_task = None
                self._record({"op": "epoch", "v": self.epoch})
                log.info("promoted to primary", epoch=self.epoch)
            # already primary: idempotent — the raced second client just
            # learns the epoch the first promotion established
            return _int(self.epoch)
        if cmd == "SYNC":
            # follower attach: snapshot (state + rings + epoch), then this
            # connection becomes a live record stream
            self._replicas.add(writer)
            for rec in self._snapshot_records(include_rings=True):
                writer.write(_arr([
                    _bulk("repl"),
                    _bulk(json.dumps(rec, separators=(",", ":")))]))
            writer.write(_arr([_bulk("repl"), _bulk('{"op":"synced"}')]))
            log.info("replica attached", replicas=len(self._replicas))
            return None
        if cmd == "RESUME":
            try:
                ch, last = a[0], int(a[1])
            except (IndexError, ValueError):
                return b"-ERR RESUME requires <channel> <last_seq>\r\n"
            # RESUME IS a subscribe: registration + replay happen inside
            # one synchronous command execution, so no concurrent publish
            # can interleave between them — replayed ring entries always
            # precede the first live frame, which is what lets the client
            # dedupe by a monotonic per-channel watermark
            self._subs.setdefault(ch, set()).add(writer)
            cur = self._seq.get(ch, 0)
            if last > cur:
                # the subscriber is AHEAD of us: this broker lost its seq
                # history (restart with no standby, counter eviction).
                # Ack lost=-1 so the client VOIDS its watermark — keeping
                # it would mute the channel (every new message seq <=
                # watermark, silently dropped as a duplicate) until the
                # fresh counter overtook the stale one.
                writer.write(_arr([_bulk("resume"), _bulk(ch),
                                   _int(0), _int(-1)]))
                return None
            ring = self._rings.get(ch)
            replayed = 0
            lost = 0
            if ring:
                first = ring[0][0]
                if first > last + 1:
                    # the gap outran the ring: everything between the
                    # subscriber's watermark and the ring head is gone
                    lost = first - last - 1
                for seq, msg in ring:
                    if seq > last:
                        writer.write(_arr([
                            _bulk("message"), _bulk(ch),
                            _bulk(encode_seq(seq, msg))]))
                        replayed += 1
            elif cur > last:
                lost = cur - last
            writer.write(_arr([_bulk("resume"), _bulk(ch),
                               _int(replayed), _int(lost)]))
            return None
        if cmd == "GET":
            key = a[0]
            if self._expired(key):
                return _bulk(None)
            return _bulk(self._kv.get(key))
        if cmd in _MUTATING:
            gate = self._gate_mutation(writer)
            if gate is not None:
                return gate
        if cmd == "SET":
            key, val = a[0], a[1]
            self._kv[key] = val
            self._expiry.pop(key, None)
            i = 2
            while i < len(a):
                opt = a[i].upper()
                if opt == "PX":
                    self._expiry[key] = time.monotonic() + int(a[i + 1]) / 1000
                    i += 2
                elif opt == "EX":
                    self._expiry[key] = time.monotonic() + int(a[i + 1])
                    i += 2
                else:
                    i += 1
            if self._aof is not None or self._replicas:
                rec = {"op": "set", "k": key, "v": val}
                exp = self._wall_deadline(key)
                if exp is not None:
                    rec["exp"] = exp
                self._record(rec)
            return OK
        if cmd == "SETEX":
            self._kv[a[0]] = a[2]
            self._expiry[a[0]] = time.monotonic() + int(a[1])
            self._record({"op": "set", "k": a[0], "v": a[2],
                          "exp": time.time() + int(a[1])})
            return OK
        if cmd == "DEL":
            n = 0
            for key in a:
                if key in self._kv or key in self._hashes:
                    n += 1
                self._kv.pop(key, None)
                self._expiry.pop(key, None)
                self._hashes.pop(key, None)
            if n:
                self._record({"op": "del", "ks": list(a)})
            return _int(n)
        if cmd == "TTL":
            key = a[0]
            if self._expired(key) or (key not in self._kv and key not in self._hashes):
                return _int(-2)
            dl = self._expiry.get(key)
            return _int(-1 if dl is None else max(0, int(dl - time.monotonic())))
        if cmd == "EXISTS":
            return _int(sum(1 for k in a if not self._expired(k) and (k in self._kv or k in self._hashes)))
        if cmd == "HGET":
            return _bulk(self._hashes.get(a[0], {}).get(a[1]))
        if cmd == "HSET":
            h = self._hashes.setdefault(a[0], {})
            added = 0
            fv: dict[str, str] = {}
            for i in range(1, len(a) - 1, 2):
                if a[i] not in h:
                    added += 1
                h[a[i]] = a[i + 1]
                fv[a[i]] = a[i + 1]
            self._record({"op": "hset", "k": a[0], "fv": fv})
            return _int(added)
        if cmd == "HGETALL":
            h = self._hashes.get(a[0], {})
            flat: list[bytes] = []
            for k, v in h.items():
                flat.append(_bulk(k))
                flat.append(_bulk(v))
            return _arr(flat)
        if cmd == "HDEL":
            h = self._hashes.get(a[0], {})
            n = 0
            for f in a[1:]:
                if f in h:
                    h.pop(f)
                    n += 1
            if n:
                self._record({"op": "hdel", "k": a[0], "fs": list(a[1:])})
            return _int(n)
        if cmd == "PUBLISH":
            gate = self._gate_mutation(writer)
            if gate is not None:
                return gate
            return _int(self._publish(a[0], a[1]))
        if cmd == "SUBSCRIBE":
            for ch in a:
                self._subs.setdefault(ch, set()).add(writer)
                # durable channels ack with their CURRENT seq (0 = none
                # yet): the subscriber records it as its resume baseline,
                # so a later reconnect can RESUME even on channels that
                # never delivered a message before the outage (a result
                # channel subscribed at submit, result published mid-gap).
                # Plain channels keep Redis's subscription-count ack.
                n = self._seq.get(ch, 0) if durable_channel(ch) else 1
                writer.write(_arr([_bulk("subscribe"), _bulk(ch), _int(n)]))
            return None
        if cmd == "UNSUBSCRIBE":
            for ch in a:
                clients = self._subs.get(ch)
                if clients:
                    clients.discard(writer)
                    if not clients:
                        self._subs.pop(ch, None)
                writer.write(_arr([_bulk("unsubscribe"), _bulk(ch), _int(0)]))
            return None
        if cmd == "PSUBSCRIBE":
            for p in a:
                self._psubs.setdefault(p, set()).add(writer)
                writer.write(_arr([_bulk("psubscribe"), _bulk(p), _int(1)]))
            return None
        if cmd == "PUNSUBSCRIBE":
            for p in a:
                clients = self._psubs.get(p)
                if clients:
                    clients.discard(writer)
                    if not clients:
                        self._psubs.pop(p, None)
                writer.write(_arr([_bulk("punsubscribe"), _bulk(p), _int(0)]))
            return None
        return b"-ERR unknown command '%s'\r\n" % cmd.encode()

    def _publish(self, channel: str, message: str) -> int:
        payload = message
        if durable_channel(channel):
            # assign the seq and record in the replay ring even with zero
            # subscribers: the whole point is that a subscriber currently
            # disconnected can RESUME this exact window later
            seq = self._next_seq(channel)
            self._ring(channel).append((seq, message))
            payload = encode_seq(seq, message)
            if self._replicas:
                frame = _arr([_bulk("repl"), _bulk(json.dumps(
                    {"op": "pub", "ch": channel, "m": message, "seq": seq},
                    separators=(",", ":")))])
                for w in list(self._replicas):
                    if not self._try_write(w, frame):
                        self._replicas.discard(w)
        return self._deliver(channel, payload)

    def _deliver(self, channel: str, payload: str) -> int:
        n = 0
        frame = _arr([_bulk("message"), _bulk(channel), _bulk(payload)])
        for w in list(self._subs.get(channel, ())):
            if self._try_write(w, frame):
                n += 1
        for pattern, clients in list(self._psubs.items()):
            if fnmatch.fnmatchcase(channel, pattern):
                pframe = _arr([_bulk("pmessage"), _bulk(pattern), _bulk(channel), _bulk(payload)])
                for w in list(clients):
                    if self._try_write(w, pframe):
                        n += 1
        return n

    # Redis's client-output-buffer-limit for pubsub clients defaults to
    # 32mb hard; same idea — a subscriber that stops reading gets kicked
    # instead of growing the broker's memory unboundedly.
    MAX_SUB_BUFFER = 32 * 1024 * 1024

    def _try_write(self, writer: asyncio.StreamWriter, frame: bytes) -> bool:
        try:
            if writer.is_closing():
                return False
            transport = writer.transport
            if transport.get_write_buffer_size() > self.MAX_SUB_BUFFER:
                log.warning("kicking slow pub/sub subscriber (output buffer full)")
                self._drop_client(writer)
                writer.close()
                return False
            writer.write(frame)
            return True
        except Exception:
            return False


def main() -> None:  # pragma: no cover
    from gridllm_torch.utils.config import env_int

    ap = argparse.ArgumentParser(description="gridbus RESP broker")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=6379)
    ap.add_argument("--aof", default=os.environ.get("GRIDBUS_AOF") or None,
                    metavar="PATH",
                    help="append-only persistence file (scheduler state "
                         "survives broker restarts; Redis --appendonly "
                         "equivalent)")
    ap.add_argument("--replicaof", default=None, metavar="HOST:PORT",
                    help="start as a warm standby tailing this primary "
                         "over its RESP port (SYNC snapshot + live record "
                         "stream); a client FAILOVER promotes it")
    ap.add_argument("--ring-cap", type=int,
                    default=env_int("GRIDLLM_BUS_RING_CAP"),
                    help="replay-ring capacity per durable channel "
                         "(messages) — the RESUME window a reconnecting "
                         "subscriber can recover")
    ns = ap.parse_args()
    replica_of = None
    if ns.replicaof:
        host, _, port = ns.replicaof.rpartition(":")
        replica_of = (host or "127.0.0.1", int(port))

    async def run() -> None:
        broker = GridBusBroker(aof_path=ns.aof, replica_of=replica_of,
                               ring_cap=ns.ring_cap)
        await broker.start(ns.host, ns.port)
        await broker.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":  # pragma: no cover
    main()
