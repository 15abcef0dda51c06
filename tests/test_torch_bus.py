"""The port's buses against the JAX package's.

The port's `InMemoryBus` gives the JAX one's results for the calls a
worker makes (publish, subscribe, psubscribe and the unsubscribe, the KV
and hash calls, TTL keys), and the port's RESP client works against the
JAX package's broker: alone, beside a JAX RESP client on the same broker
(each reads the other's frames, the HLC and sequence framing stripped
alike), and through a broker restart.
"""

import asyncio

import pytest

from gridllm_torch.bus import InMemoryBus as TBus
from gridllm_torch.bus import create_bus as t_create_bus
from gridllm_torch.bus.base import CH_JOB_COMPLETED, job_stream_channel, worker_job_channel
from gridllm_torch.bus.resp import RespBus as TResp
from gridllm_tpu.bus import InMemoryBus as JBus
from gridllm_tpu.bus.broker import GridBusBroker
from gridllm_tpu.bus.resp import RespBus as JResp


async def _script(bus) -> list:
    """The calls a worker and its scheduler make, with every result and
    every delivery recorded in order."""
    out: list = []
    got: list = []

    async def handler(ch, msg):
        got.append(("exact", ch, msg))

    async def phandler(ch, msg):
        got.append(("pattern", ch, msg))

    await bus.connect()
    out.append(await bus.is_healthy())
    sub = await bus.subscribe(worker_job_channel("w1"), handler)
    psub = await bus.psubscribe("job:stream:*", phandler)
    out.append(await bus.publish(worker_job_channel("w1"), '{"type":"job_assignment"}'))
    out.append(await bus.publish(job_stream_channel("j1"), '{"id":"j1","response":"a"}'))
    out.append(await bus.publish(job_stream_channel("j2"), '{"id":"j2","response":"b"}'))
    out.append(await bus.publish(CH_JOB_COMPLETED, "{}"))      # no subscriber
    await bus.hset("workers", "w1", '{"workerId":"w1"}')
    await bus.hset("workers", "w2", '{"workerId":"w2"}')
    out.append(await bus.hget("workers", "w1"))
    out.append(await bus.hget("workers", "nope"))
    out.append(await bus.hgetall("workers"))
    await bus.hdel("workers", "w2")
    out.append(await bus.hgetall("workers"))
    await bus.set("k", "v")
    out.append((await bus.get("k"), await bus.ttl("k")))
    await bus.set_with_expiry("heartbeat:w1", "1.5", ttl_s=10.0)
    out.append((await bus.get("heartbeat:w1"), await bus.ttl("heartbeat:w1")))
    await bus.delete("k")
    out.append((await bus.get("k"), await bus.ttl("k")))
    for _ in range(200):
        if len(got) >= 3:
            break
        await asyncio.sleep(0.01)
    await sub.unsubscribe()
    await psub.unsubscribe()
    out.append(await bus.publish(worker_job_channel("w1"), "after"))
    await asyncio.sleep(0.05)
    out.append(sorted(got))
    await bus.disconnect()
    return out


async def test_in_memory_bus_matches_jax():
    assert await _script(TBus()) == await _script(JBus())


async def test_create_bus_memory_and_resp():
    assert isinstance(t_create_bus(""), TBus)
    resp = t_create_bus("resp://127.0.0.1:7001,127.0.0.1:7002")
    assert isinstance(resp, TResp)
    with pytest.raises(ValueError, match="Unknown bus url"):
        t_create_bus("kafka://x")


async def test_resp_client_against_jax_broker():
    broker = GridBusBroker()
    await broker.start("127.0.0.1", 0)
    try:
        got = await _script(TResp(host="127.0.0.1", port=broker.port, key_prefix="T:"))
        want = await _script(JBus(key_prefix="T:"))
        # a RESP publish answers with the broker's receiver count, a
        # hash/key read as the in-memory bus does
        assert got == want
    finally:
        await broker.stop()


async def test_torch_and_jax_resp_clients_share_a_broker():
    """A frame published by either package's client reaches the other's
    subscriber with its framing stripped, in order; durable channels
    (a worker's job channel, job streams) carry the broker's sequence."""
    broker = GridBusBroker()
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
        for _ in range(300):
            if len(t_got) == 5 and len(j_got) == 5:
                break
            await asyncio.sleep(0.01)
        assert t_got == [(worker_job_channel("w1"), m) for m in sent_j]
        assert j_got == [(job_stream_channel("j1"), m) for m in sent_t]
        assert await tbus.hgetall("workers") == {"w1": '{"workerId":"w1"}'}
    finally:
        await tbus.disconnect()
        await jbus.disconnect()
        await broker.stop()


async def test_resp_client_survives_broker_restart():
    broker = GridBusBroker()
    await broker.start("127.0.0.1", 0)
    port = broker.port
    bus = TResp(host="127.0.0.1", port=port)
    await bus.connect()
    try:
        await bus.set("k", "v1")
        await broker.stop()
        broker = GridBusBroker()
        await broker.start("127.0.0.1", port)
        await bus.set("k", "v2")           # reconnects inside the command
        assert await bus.get("k") == "v2"
    finally:
        await bus.disconnect()
        await broker.stop()
