"""The port's gridbus broker against the JAX package's.

A raw RESP command script gets byte-equal replies from both brokers (the
KV and hash commands, pub/sub with the durable channels' sequence framing,
AUTH/SELECT, EPOCH, FENCE, RESUME, FAILOVER, a refused write on a stale
broker); the JAX and port RespBus clients share the port's broker; an
append-only file written by either broker is replayed by the other into
the same state; and the broker scenarios of tests/test_bus_ha.py run on
the port's broker behind the port's client: RESUME over an outage gap, a
ring outrun reported as lost, the seq counter kept through ring eviction
and voided after a restart, epoch fencing, a stale demotion that survives
a restart, a warm-standby failover and a resurrected stale primary with
one package's broker at each end, an unsynced standby refusing promotion,
and the broker.accept, broker.reply and broker.fsync fault sites.
"""

from __future__ import annotations

import asyncio
import json
import time

import pytest

from gridllm_torch import faults as tfaults
from gridllm_torch.bus.base import job_stream_channel, split_seq, worker_job_channel
from gridllm_torch.bus.broker import GridBusBroker as TBroker
from gridllm_torch.bus.resp import RespBus as TResp
from gridllm_torch.bus.resp import RespProtocolError, encode_command, read_reply
from gridllm_tpu import faults as jfaults
from gridllm_tpu.bus.broker import GridBusBroker as JBroker
from gridllm_tpu.bus.resp import RespBus as JResp

BROKERS = {"jax": JBroker, "torch": TBroker}


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


async def _wait(predicate, timeout_s: float = 10.0, interval: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        await asyncio.sleep(interval)
    return False


async def _frame(reader: asyncio.StreamReader) -> bytes:
    """The raw bytes of one complete RESP2 reply."""
    line = await reader.readuntil(b"\r\n")
    kind = line[:1]
    if kind in (b"+", b"-", b":"):
        return line
    n = int(line[1:-2])
    if kind == b"$":
        return line + (await reader.readexactly(n + 2) if n >= 0 else b"")
    out = line
    for _ in range(max(n, 0)):
        out += await _frame(reader)
    return out


class _Conn:
    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer

    @classmethod
    async def open(cls, port: int) -> _Conn:
        return cls(*await asyncio.open_connection("127.0.0.1", port))

    async def ask(self, *args, frames: int = 1, raw: bytes | None = None) -> list[bytes]:
        self.writer.write(raw if raw is not None else encode_command(*args))
        await self.writer.drain()
        return [await asyncio.wait_for(_frame(self.reader), 5) for _ in range(frames)]

    async def read(self, frames: int = 1) -> list[bytes]:
        return [await asyncio.wait_for(_frame(self.reader), 5) for _ in range(frames)]

    def close(self) -> None:
        self.writer.close()


async def _command_script(broker_cls) -> list:
    """Every command the protocol uses, once or more, with each reply's
    bytes (and each frame a subscriber connection receives) in order."""
    broker = broker_cls(ring_cap=4)
    await broker.start("127.0.0.1", 0)
    out: list = []
    a = await _Conn.open(broker.port)
    s = await _Conn.open(broker.port)
    try:
        out += await a.ask("PING")
        out += await a.ask(raw=b"PING\r\n")
        out += await a.ask("AUTH", "secret")
        out += await a.ask("SELECT", 0)
        out += await a.ask("SET", "k", "v")
        out += await a.ask("GET", "k")
        out += await a.ask("SET", "kpx", "v", "PX", 60_000)
        out += await a.ask("TTL", "kpx")
        out += await a.ask("SET", "kex", "v", "EX", 100)
        out += await a.ask("TTL", "kex")
        out += await a.ask("SETEX", "ksx", 50, "v")
        out += await a.ask("TTL", "ksx")
        out += await a.ask("TTL", "k")
        out += await a.ask("TTL", "missing")
        out += await a.ask("EXISTS", "k", "kpx", "missing")
        out += await a.ask("DEL", "k", "missing")
        out += await a.ask("DEL", "missing")
        out += await a.ask("GET", "k")
        out += await a.ask("HSET", "h", "f1", "v1", "f2", "v2")
        out += await a.ask("HSET", "h", "f1", "v3")
        out += await a.ask("HGET", "h", "f1")
        out += await a.ask("HGET", "h", "nope")
        out += await a.ask("HGETALL", "h")
        out += await a.ask("HDEL", "h", "f2", "nope")
        out += await a.ask("HGETALL", "h")
        out += await a.ask("HGETALL", "nohash")
        out += await a.ask("TTL", "h")
        # pub/sub: a durable channel acks with its current seq and frames
        # every payload with it; a plain channel keeps Redis's count ack
        out += await a.ask("PUBLISH", "job:stream:a", "before-subscribe")
        out += await s.ask("SUBSCRIBE", "job:stream:a", "plain:ch", frames=2)
        out += await s.ask("PSUBSCRIBE", "job:result:*")
        out += await a.ask("PUBLISH", "job:stream:a", "m1")
        out += await s.read()
        out += await a.ask("PUBLISH", "plain:ch", "m2")
        out += await s.read()
        out += await a.ask("PUBLISH", "job:result:x", "r1")
        out += await s.read()
        out += await a.ask("PUBLISH", "nobody:listens", "x")
        out += await s.ask("UNSUBSCRIBE", "plain:ch")
        out += await s.ask("PUNSUBSCRIBE", "job:result:*")
        out += await a.ask("PUBLISH", "job:result:x", "r2")
        out += await a.ask("PUBLISH", "job:stream:a", "m3")
        out += await s.read()
        for i in range(4):   # the ring (4) keeps seqs 4..7 of job:stream:a
            out += await a.ask("PUBLISH", "job:stream:a", f"n{i}")
        out += await s.read(4)
        # RESUME: replay after a watermark, a gap past the ring, a
        # subscriber ahead of the broker, a channel with no ring
        r = await _Conn.open(broker.port)
        out += await r.ask("RESUME", "job:stream:a", 4, frames=4)
        out += await r.ask("RESUME", "job:stream:a", 0, frames=5)
        out += await r.ask("RESUME", "job:stream:a", 99)
        out += await r.ask("RESUME", "job:stream:none", 0)
        out += await r.ask("RESUME", "job:stream:a")
        r.close()
        # epochs and fencing
        out += await a.ask("EPOCH")
        out += await a.ask("FENCE", 1)
        out += await a.ask("FENCE", 0)
        out += await a.ask("FENCE", "x")
        out += await a.ask("FAILOVER")
        out += await a.ask("FAILOVER", "x")
        out += await a.ask("NOSUCHCMD", "x")
        out += await a.ask("FENCE", 9)
        out += await a.ask("SET", "k", "v")
        out += await a.ask("HSET", "h", "f", "v")
        out += await a.ask("PUBLISH", "job:stream:a", "x")
        out += await a.ask("FENCE", 1)
        out += await a.ask("FAILOVER", 3)
        out += await a.ask("EPOCH")
        out += await a.ask("GET", "kpx")
    finally:
        a.close()
        s.close()
        await broker.stop()
    return out


async def test_command_script_replies_byte_equal():
    want = await _command_script(JBroker)
    got = await _command_script(TBroker)
    assert got == want


async def test_jax_and_torch_resp_clients_share_the_port_broker():
    """A frame published by either package's client reaches the other's
    subscriber with its framing stripped, in order, through the port's
    broker; a hash written by one is read by the other."""
    broker = TBroker()
    await broker.start("127.0.0.1", 0)
    tbus = TResp(host="127.0.0.1", port=broker.port)
    jbus = JResp(host="127.0.0.1", port=broker.port)
    await tbus.connect()
    await jbus.connect()
    try:
        t_got, j_got = [], []

        async def t_handler(ch, msg):
            t_got.append((ch, msg))

        async def j_handler(ch, msg):
            j_got.append((ch, msg))

        await tbus.subscribe(worker_job_channel("w1"), t_handler)
        await jbus.psubscribe("job:stream:*", j_handler)
        await asyncio.sleep(0.1)
        sent_j = [f'{{"type":"job_assignment","n":{i}}}' for i in range(5)]
        sent_t = [f'{{"id":"j1","response":"tok{i}"}}' for i in range(5)]
        for a, b in zip(sent_j, sent_t):
            await jbus.publish(worker_job_channel("w1"), a)
            await tbus.publish(job_stream_channel("j1"), b)
        await jbus.hset("workers", "w1", '{"workerId":"w1"}')
        await tbus.set_with_expiry("heartbeat:w1", "1.5", ttl_s=10.0)
        assert await _wait(lambda: len(t_got) == 5 and len(j_got) == 5, timeout_s=5)
        assert t_got == [(worker_job_channel("w1"), m) for m in sent_j]
        assert j_got == [(job_stream_channel("j1"), m) for m in sent_t]
        assert await tbus.hgetall("workers") == {"w1": '{"workerId":"w1"}'}
        assert await jbus.get("heartbeat:w1") == "1.5" and 0 < await jbus.ttl("heartbeat:w1") <= 10
    finally:
        await tbus.disconnect()
        await jbus.disconnect()
        await broker.stop()


# ------------------------------------------------------------------ AOF


async def _mutate(port: int) -> None:
    c = await _Conn.open(port)
    for cmd in (("SET", "plain", "p"), ("SET", "px", "v", "PX", 60_000),
                ("SET", "gone", "v", "PX", 1), ("SETEX", "ex", 100, "v"),
                ("HSET", "workers", "w1", "a", "w2", "b"), ("HSET", "workers", "w1", "c"),
                ("HDEL", "workers", "w2"), ("SET", "dead", "x"), ("DEL", "dead"),
                ("HSET", "emptied", "f", "v"), ("HDEL", "emptied", "f")):
        await c.ask(*cmd)
    c.close()
    await asyncio.sleep(0.01)   # "gone" expires before the restart


def _state(broker) -> dict:
    for k in list(broker._kv):
        broker._expired(k)
    return {"kv": dict(broker._kv), "hashes": {k: v for k, v in broker._hashes.items() if v},
            "expiring": sorted(broker._expiry), "epoch": broker.epoch, "stale": broker.stale}


def _records(path) -> list[dict]:
    recs = [json.loads(ln) for ln in open(path) if ln.strip()]
    for r in recs:
        if "exp" in r:
            r["exp"] = round(r["exp"])   # a wall deadline re-derived at compaction
    return recs


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
async def test_aof_written_by_one_broker_replays_in_the_other(writer, reader, tmp_path):
    """One broker's log, replayed by a broker of each package: the same
    state (expiries kept as wall deadlines, an expired key dropped) and
    the same compacted snapshot, the log kept beside it as .bak."""
    aof = str(tmp_path / "bus.aof")
    w = BROKERS[writer](aof_path=aof)
    await w.start("127.0.0.1", 0)
    await _mutate(w.port)
    want = _state(w)
    await w.stop()
    log = open(aof).read()
    states, snapshots = {}, {}
    for name in (writer, reader):
        path = tmp_path / f"{name}.aof"
        path.write_text(log)
        b = BROKERS[name](aof_path=str(path))
        await b.start("127.0.0.1", 0)
        try:
            states[name] = _state(b)
            c = await _Conn.open(b.port)
            assert await c.ask("HGETALL", "workers") == [b"*2\r\n$2\r\nw1\r\n$1\r\nc\r\n"]
            c.close()
        finally:
            await b.stop()
        snapshots[name] = _records(path)
        assert (tmp_path / f"{name}.aof.bak").read_text() == log
    assert states[reader] == states[writer] == want == {
        "kv": {"plain": "p", "px": "v", "ex": "v"}, "hashes": {"workers": {"w1": "c"}},
        "expiring": ["ex", "px"], "epoch": 1, "stale": False}
    assert snapshots[reader] == snapshots[writer]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
async def test_stale_mark_and_epoch_replay_across_packages(writer, reader, tmp_path):
    """A fencing demotion and a promoted epoch written by one broker's AOF
    hold in the other after a restart."""
    aof = str(tmp_path / "bus.aof")
    w = BROKERS[writer](aof_path=aof)
    await w.start("127.0.0.1", 0)
    w.epoch = 4
    w._record({"op": "epoch", "v": 4})
    c = await _Conn.open(w.port)
    assert (await c.ask("FENCE", 7))[0].startswith(b"-STALE fenced")
    c.close()
    await w.stop()
    r = BROKERS[reader](aof_path=aof)
    await r.start("127.0.0.1", 0)
    try:
        assert (r.stale, r.epoch) == (True, 4)
        c = await _Conn.open(r.port)
        assert await c.ask("EPOCH") == [b"*2\r\n$5\r\nstale\r\n:4\r\n"]
        assert (await c.ask("SET", "k", "v"))[0].startswith(b"-STALE")
        c.close()
    finally:
        await r.stop()


@pytest.mark.parametrize("name", list(BROKERS))
async def test_aof_torn_tail_dropped_and_corruption_refused(name, tmp_path):
    aof = tmp_path / "bus.aof"
    aof.write_text('{"op":"set","k":"a","v":"1"}\n{"op":"set","k":"b","v"')
    b = BROKERS[name](aof_path=str(aof))
    await b.start("127.0.0.1", 0)
    assert b._kv == {"a": "1"}
    await b.stop()
    bad = tmp_path / "bad.aof"
    bad.write_text('{"op":"set","k":"a","v":"1"}\nnot json\n{"op":"set","k":"b","v":"2"}\n')
    with pytest.raises(RuntimeError, match="corrupt record 2/3"):
        await BROKERS[name](aof_path=str(bad)).start("127.0.0.1", 0)
    assert bad.read_text().count("\n") == 3   # refused, never compacted over


# ------------------------------------------------- tests/test_bus_ha.py's


async def test_replay_ring_resumes_outage_gap():
    from gridllm_torch.bus.resp import _REPLAYED

    broker = TBroker(ring_cap=16)
    await broker.start("127.0.0.1", 0)
    bus = TResp(host="127.0.0.1", port=broker.port, key_prefix="T:")
    pub = TResp(host="127.0.0.1", port=broker.port, key_prefix="T:")
    await bus.connect()
    await pub.connect()
    got: list[str] = []

    async def handler(_ch, m):
        got.append(m)

    try:
        await bus.subscribe("job:stream:x", handler)
        await asyncio.sleep(0.05)
        await pub.publish("job:stream:x", "a")
        await pub.publish("job:stream:x", "b")
        assert await _wait(lambda: got == ["a", "b"])
        replayed0 = int(_REPLAYED.value(channel="job:stream"))
        # the gap lands while the subscriber is down: the broker takes no
        # new connection until both frames are published
        tfaults.configure("broker.accept=@1+", seed=0)
        bus._sub.writer.close()
        assert await _wait(lambda: bus.partition_state()["degraded"])
        await pub.publish("job:stream:x", "c")
        await pub.publish("job:stream:x", "d")
        tfaults.reset()
        assert await _wait(lambda: len(got) >= 4, timeout_s=15)
        assert got == ["a", "b", "c", "d"]
        assert int(_REPLAYED.value(channel="job:stream")) - replayed0 == 2
        assert bus.partition_state()["degraded"] is False
    finally:
        await bus.disconnect()
        await pub.disconnect()
        await broker.stop()


@pytest.mark.parametrize("name", list(BROKERS))
async def test_resume_reports_ring_outrun_as_lost(name):
    broker = BROKERS[name](ring_cap=4)
    await broker.start("127.0.0.1", 0)
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", broker.port)
        for i in range(10):   # seqs 1..10; the ring keeps 7..10
            broker._publish("job:stream:z", f"m{i + 1}")
        writer.write(encode_command("RESUME", "job:stream:z", 2))
        await writer.drain()
        frames = [await read_reply(reader) for _ in range(5)]
        assert frames[-1] == ["resume", "job:stream:z", 4, 4]   # replayed 7..10, lost 3..6
        assert [split_seq(f[2]) for f in frames[:-1]] == [(7, "m7"), (8, "m8"), (9, "m9"),
                                                          (10, "m10")]
        writer.close()
    finally:
        await broker.stop()


async def test_broker_seq_reset_voids_watermark_instead_of_muting():
    broker = TBroker()
    await broker.start("127.0.0.1", 0)
    port = broker.port
    bus = TResp(host="127.0.0.1", port=port, key_prefix="T:")
    await bus.connect()
    got: list[str] = []

    async def handler(_ch, m):
        got.append(m)

    broker2 = pub = None
    try:
        await bus.subscribe("job:stream:r", handler)
        await asyncio.sleep(0.05)
        pub = TResp(host="127.0.0.1", port=port, key_prefix="T:")
        await pub.connect()
        for m in ("a", "b", "c"):
            await pub.publish("job:stream:r", m)
        assert await _wait(lambda: got == ["a", "b", "c"])
        await broker.stop()
        broker2 = TBroker()   # fresh seq counters: no AOF, no standby
        await broker2.start("127.0.0.1", port)
        assert await _wait(lambda: "job:stream:r" not in bus._last_seq, timeout_s=20)
        await pub.publish("job:stream:r", "d")   # fresh seq 1
        assert await _wait(lambda: got == ["a", "b", "c", "d"], timeout_s=10)
    finally:
        await bus.disconnect()
        if pub is not None:
            await pub.disconnect()
        await (broker2 or broker).stop()


@pytest.mark.parametrize("name", list(BROKERS))
def test_ring_eviction_keeps_seq_counter(name):
    broker = BROKERS[name](ring_cap=4)
    broker.MAX_RING_CHANNELS = 2
    broker._publish("job:drain", "d1")
    broker._publish("job:stream:a", "x")
    broker._publish("job:stream:b", "x")   # evicts job:drain's ring
    assert "job:drain" not in broker._rings and broker._seq["job:drain"] == 1
    broker._publish("job:drain", "d2")
    assert broker._seq["job:drain"] == 2


async def test_epoch_fencing_rejects_stale_primary():
    broker = TBroker()
    await broker.start("127.0.0.1", 0)
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", broker.port)

        async def ask(*args):
            writer.write(encode_command(*args))
            await writer.drain()
            return await read_reply(reader)

        assert await ask("EPOCH") == ["primary", 1]
        with pytest.raises(RespProtocolError, match="STALE"):
            await ask("FENCE", 5)
        assert broker.stale
        for cmd in (("SET", "k", "v"), ("HSET", "h", "f", "v"), ("DEL", "k"),
                    ("PUBLISH", "job:snapshot", "{}")):
            with pytest.raises(RespProtocolError, match="STALE"):
                await ask(*cmd)
        assert broker._kv == {} and await ask("GET", "k") is None
        assert await ask("EPOCH") == ["stale", 1]
        writer.close()
        # a connection fenced at an older epoch than the broker's is a laggard
        b2 = TBroker()
        await b2.start("127.0.0.1", 0)
        r, w = await asyncio.open_connection("127.0.0.1", b2.port)
        for cmd, want in ((("FENCE", 1), "OK"), (("SET", "k", "v"), "OK")):
            w.write(encode_command(*cmd))
            await w.drain()
            assert await read_reply(r) == want
        b2.epoch = 2
        w.write(encode_command("SET", "k", "v2"))
        await w.drain()
        with pytest.raises(RespProtocolError, match="FENCED"):
            await read_reply(r)
        assert b2._kv["k"] == "v"
        w.close()
        await b2.stop()
    finally:
        await broker.stop()


@pytest.mark.parametrize("primary,standby", [("jax", "torch"), ("torch", "jax")])
async def test_warm_standby_failover_across_packages(primary, standby):
    """The primary dies mid-session: the port's endpoint-listed client
    fails over, promotes the other package's standby (epoch bump), finds
    the replicated KV state there, and RESUMEs the replicated ring so the
    frames around the failover arrive exactly once."""
    from gridllm_torch.bus.resp import _FAILOVERS

    p = BROKERS[primary]()
    await p.start("127.0.0.1", 0)
    s = BROKERS[standby](replica_of=("127.0.0.1", p.port))
    await s.start("127.0.0.1", 0)
    assert await _wait(lambda: s.repl_synced, timeout_s=5)
    eps = [("127.0.0.1", p.port), ("127.0.0.1", s.port)]
    bus = TResp(host=eps[0][0], port=eps[0][1], key_prefix="T:", endpoints=eps)
    await bus.connect()
    got: list[str] = []

    async def handler(_ch, m):
        got.append(m)

    try:
        failovers0 = int(_FAILOVERS.value())
        await bus.subscribe("job:stream:f", handler)
        await asyncio.sleep(0.05)
        await bus.set("jobrec", "state-1")
        await bus.hset("workers", "w1", "x")
        await bus.publish("job:stream:f", "before")
        assert await _wait(lambda: got == ["before"])
        assert await _wait(lambda: s._seq.get("job:stream:f") == 1)
        await p.stop()
        await bus.set("jobrec", "state-2")   # fails over and promotes
        assert s.role == "primary" and s.epoch >= 2
        assert await bus.get("jobrec") == "state-2"
        assert await bus.hget("workers", "w1") == "x"
        await bus.publish("job:stream:f", "after")
        assert await _wait(lambda: got == ["before", "after"], timeout_s=15)
        assert s._seq["job:stream:f"] == 2 and int(_FAILOVERS.value()) > failovers0
    finally:
        await bus.disconnect()
        await s.stop()


@pytest.mark.parametrize("primary,standby", [("jax", "torch"), ("torch", "jax")])
async def test_resurrected_stale_primary_is_fenced_not_split_brained(primary, standby):
    p = BROKERS[primary]()
    await p.start("127.0.0.1", 0)
    p0 = p.port
    s = BROKERS[standby](replica_of=("127.0.0.1", p0))
    await s.start("127.0.0.1", 0)
    assert await _wait(lambda: s.repl_synced, timeout_s=5)
    eps = [("127.0.0.1", p0), ("127.0.0.1", s.port)]
    bus = TResp(host=eps[0][0], port=eps[0][1], key_prefix="T:", endpoints=eps)
    await bus.connect()
    old = None
    try:
        await bus.set("k", "v0")
        await p.stop()
        await bus.set("k", "v1")   # fails over; the standby is promoted
        assert s.role == "primary" and s.epoch >= 2
        old = BROKERS[primary]()
        await old.start("127.0.0.1", p0)
        bus._main.writer.close()   # the main connection re-walks the list
        await asyncio.sleep(0.05)
        await bus.set("k", "v2")
        assert old.stale and old._kv == {}
        assert s._kv.get("T:k") == "v2"
    finally:
        await bus.disconnect()
        await s.stop()
        if old is not None:
            await old.stop()


async def test_unsynced_standby_refuses_promotion():
    standby = TBroker(replica_of=("127.0.0.1", 1))   # nobody listens there
    await standby.start("127.0.0.1", 0)
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", standby.port)
        writer.write(encode_command("FAILOVER", 2))
        await writer.drain()
        with pytest.raises(RespProtocolError, match="NOTSYNCED"):
            await read_reply(reader)
        writer.write(encode_command("SET", "k", "v"))
        await writer.drain()
        with pytest.raises(RespProtocolError, match="READONLY"):
            await read_reply(reader)
        assert standby.role == "replica"
        writer.close()
    finally:
        await standby.stop()


async def test_broker_accept_drop_site():
    tfaults.configure("broker.accept=@1", seed=0)
    broker = TBroker()
    await broker.start("127.0.0.1", 0)
    bus = TResp(host="127.0.0.1", port=broker.port, key_prefix="T:")
    try:
        await bus.connect()   # the first connection is injected away, retried
        assert await bus.is_healthy()
        assert int(tfaults._INJECTED.value(site="broker.accept")) >= 1
    finally:
        await bus.disconnect()
        await broker.stop()


async def test_broker_reply_reset_site():
    broker = TBroker()
    await broker.start("127.0.0.1", 0)
    bus = TResp(host="127.0.0.1", port=broker.port, key_prefix="T:")
    await bus.connect()
    try:
        await bus.set("k", "v" * 64)
        tfaults.configure("broker.reply=@1", seed=0)
        assert await bus.get("k") == "v" * 64   # torn reply, the retry wins
        tfaults.reset()
        assert await bus.get("k") == "v" * 64
    finally:
        await bus.disconnect()
        await broker.stop()


async def test_broker_fsync_stall_site(tmp_path):
    tfaults.configure("broker.fsync=@1", seed=0)
    broker = TBroker(aof_path=str(tmp_path / "bus.aof"))
    await broker.start("127.0.0.1", 0)
    bus = TResp(host="127.0.0.1", port=broker.port, key_prefix="T:")
    await bus.connect()
    try:
        t0 = time.monotonic()
        await bus.set("k", "v")   # the first logged write fsyncs and stalls
        assert time.monotonic() - t0 >= 0.35
        assert await bus.get("k") == "v"
        assert int(tfaults._INJECTED.value(site="broker.fsync")) == 1
    finally:
        await bus.disconnect()
        await broker.stop()
