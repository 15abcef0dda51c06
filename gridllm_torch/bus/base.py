"""Message-bus interface: the DCN-plane control/data bus contract.

The port's copy of the JAX package's bus/base.py, the same on the wire:
channel names, the channel registry (whose publisher and subscriber
modules name the JAX package's, where the protocol is declared and
checked), the broker's sequence framing and the HLC framing.

Reference analogue: server/src/services/RedisService.ts:110-247 and
client/src/services/RedisConnectionManager.ts:257-358 — Redis KV + hash +
pub/sub with a `GridLLM:` key prefix. Design fixes baked in (SURVEY.md §2.8):

- ``subscribe`` returns a ``Subscription`` handle whose ``unsubscribe()``
  removes exactly that handler — the reference leaked one `message` listener
  per subscribe call (RedisService.ts:207-227).
- Channel names are NOT key-prefixed (matches reference behavior: ioredis
  keyPrefix does not apply to pub/sub), keys ARE.

The protocol carried over this interface (channels `worker:*`, `job:*`,
keys `workers`, `heartbeat:{id}`, `active_jobs`, `job_queue`) is inventoried
in SURVEY.md §2.6 and implemented by scheduler/ and worker/. Every channel
family is declared in the typed CHANNELS registry below — call
sites use the CH_* constants / *_channel helpers, never raw name strings;
the channel-discipline analyzer rule enforces it.
"""

from __future__ import annotations

import abc
import asyncio
import dataclasses
import re
import time
from typing import Any, Awaitable, Callable

from gridllm_torch import faults
from gridllm_torch.obs import metrics as obs

# Fleet timeline: every publish is stamped with the process
# HLC (inside the broker's seq framing) and every delivery merges the
# stamp back, so cross-member event order is provable without clock
# sync. Importing obs.timeline here is safe ONLY because the line above
# already loaded the whole obs package — timeline.py itself must never
# import bus code at module level (see its module docstring).
from gridllm_torch.obs.timeline import (
    EDGE_FAMILIES,
    default_clock,
    edge_request_id,
    emit_event,
    encode_hlc,
    split_hlc,
    timeline_armed,
)

# handler(channel, message) — message is the raw string payload
Handler = Callable[[str, str], Awaitable[None]]

# Bus-plane instruments (process-global registry): publish/deliver volumes
# and delivery latency (publish → handler start), labeled by channel CLASS
# (per-job/per-worker ids collapsed) so cardinality stays bounded.
_PUBLISHED = obs.default_registry().counter(
    "gridllm_bus_messages_published_total",
    "Messages published to the bus, by channel class.",
    ("channel",),
)
_DELIVERED = obs.default_registry().counter(
    "gridllm_bus_messages_delivered_total",
    "Messages delivered to subscribed handlers, by channel class.",
    ("channel",),
)
_DELIVERY_LATENCY = obs.default_registry().histogram(
    "gridllm_bus_delivery_latency_seconds",
    "Latency from subscriber-side enqueue to handler start, by channel class.",
    ("channel",),
)

# -- typed channel registry --------------------------------------
#
# Every channel family the protocol carries is declared here ONCE —
# mirroring the ENV_VARS registry in utils/config.py — with its name
# pattern, payload contract, durability class, and intended publisher/
# subscriber modules. Call sites never spell a channel name as a raw
# string: fixed channels use the CH_* constants below, parameterized
# channels go through the *_channel helpers. The channel-discipline rule
# (the JAX package's analysis/) enforces all of it statically: raw literals at
# publish/subscribe call sites are findings, publish/subscribe direction
# must match the declared modules, publisher-side payload keys must
# agree with the declared model both ways, and ``durable_channel`` /
# ``channel_class`` below DERIVE from this registry so a channel can't
# be durable-in-docs but fire-and-forget-in-code. The README "Bus
# channels" table is cross-checked against this registry by the same
# rule, so docs cannot drift from the protocol.


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """One channel family: the single source of truth for its wire name,
    payload shape, durability class, and who talks on it."""

    family: str                   # metric-label class (collapses per-id names)
    pattern: str                  # "job:result:{job_id}" / fixed literal
    payload: str                  # pydantic model name, "keys", or "opaque"
    keys: tuple[str, ...]         # declared payload keys ("keys" payloads)
    durable: bool                 # broker sequences + ring-buffers it
    publishers: tuple[str, ...]   # repo-relative modules that may publish
    subscribers: tuple[str, ...]  # repo-relative modules that may subscribe
    helper: str                   # the constant / helper call sites must use
    description: str


CHANNELS: dict[str, ChannelSpec] = {}


def register_channel(family: str, *, pattern: str, payload: str = "keys",
                     keys: tuple[str, ...] = (), durable: bool = False,
                     publishers: tuple[str, ...] = (),
                     subscribers: tuple[str, ...] = (),
                     helper: str = "", description: str = "") -> None:
    if family in CHANNELS:
        # same contract as register_env: silent last-writer-wins would
        # let two registrations disagree with no signal anywhere
        raise ValueError(f"duplicate register_channel({family!r})")
    CHANNELS[family] = ChannelSpec(family, pattern, payload, tuple(keys),
                                   durable, tuple(publishers),
                                   tuple(subscribers), helper, description)


# Durability rationale: durable=True marks channels whose loss
# mid-outage is NOT recoverable by the at-least-once sweeps alone —
# result/stream frames feed live client streams, snapshots are the
# crash-resume watermarks, handoff/drain/preempted move live assignments,
# kvx:* carries KV-page migration chunks, and worker:{id}:job carries
# assignments/cancellations (an assignment published while the worker's
# subscriber is mid-reconnect must not vanish until the job timeout).
# Everything else (heartbeats, registration, traces, plan replay) is
# periodic or best-effort and stays plain fire-and-forget pub/sub.

register_channel(
    "worker:job", pattern="worker:{worker_id}:job", payload="keys",
    keys=("type", "job", "jobId", "reason", "xfer", "fromWorker", "header"),
    durable=True,
    publishers=("gridllm_tpu/scheduler/scheduler.py",
                "gridllm_tpu/transfer/migrate.py",
                "gridllm_tpu/obs/health.py"),
    subscribers=("gridllm_tpu/worker/service.py",),
    helper="worker_job_channel",
    description="Per-worker control: job_assignment/job_cancellation/"
                "job_preempt/kv_import/kv_release/drain messages, "
                "demuxed by the 'type' key.")
register_channel(
    "worker:reregister", pattern="worker:reregister:{worker_id}",
    payload="keys", keys=("type", "timestamp"),
    publishers=("gridllm_tpu/scheduler/registry.py",),
    subscribers=("gridllm_tpu/worker/service.py",),
    helper="worker_reregister_channel",
    description="Registry asks one silent-but-alive worker to re-publish "
                "its registration.")
register_channel(
    "worker:admin", pattern="worker:admin", payload="keys",
    keys=("op", "id", "model", "source", "destination", "if_idle",
          "workerId"),
    publishers=("gridllm_tpu/gateway/admin.py",
                "gridllm_tpu/scheduler/placement.py"),
    subscribers=("gridllm_tpu/worker/service.py",),
    helper="CH_WORKER_ADMIN",
    description="Model-management ops (load/unload/copy), broadcast by "
                "the gateway or targeted at one worker (workerId key) by "
                "the placement controller; workers answer on "
                "admin:result.")
register_channel(
    "admin:result", pattern="admin:result:{op_id}", payload="keys",
    keys=("workerId", "op", "ack", "ok", "detail"), durable=True,
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/gateway/admin.py",
                 "gridllm_tpu/scheduler/placement.py"),
    helper="admin_result_channel",
    description="Per-op admin answers: immediate ack, then ok/detail "
                "when the op resolves.")
register_channel(
    "worker:registered", pattern="worker:registered", payload="WorkerInfo",
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/registry.py",),
    helper="CH_WORKER_REGISTERED",
    description="Worker self-registration (full WorkerInfo).")
register_channel(
    "worker:unregistered", pattern="worker:unregistered", payload="keys",
    keys=("workerId",),
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/registry.py",),
    helper="CH_WORKER_UNREGISTERED",
    description="Graceful worker shutdown announcement.")
register_channel(
    "worker:heartbeat", pattern="worker:heartbeat", payload="keys",
    keys=("workerId", "status", "currentJobs", "prefixKeys", "role",
          "decodeSlotsFree", "httpAddr", "modelCapacity"),
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/registry.py",),
    helper="CH_WORKER_HEARTBEAT",
    description="Periodic liveness + load + prefix-affinity keys + "
                "disagg role/headroom/transfer address + per-model "
                "slot/KV-page headroom.")
register_channel(
    "worker:status_update", pattern="worker:status_update", payload="keys",
    keys=("workerId", "status", "currentJobs"),
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/registry.py",),
    helper="CH_WORKER_STATUS_UPDATE",
    description="Change-deduped online/busy/draining transitions.")
register_channel(
    "worker:disconnected", pattern="worker:disconnected", payload="keys",
    keys=("workerId", "reason"),
    publishers=("gridllm_tpu/worker/group.py",),
    subscribers=("gridllm_tpu/scheduler/registry.py",),
    helper="CH_WORKER_DISCONNECTED",
    description="Fast-path worker death announcement (multi-host slice "
                "failure) — beats the heartbeat TTL by ~10 s.")
register_channel(
    "job:completed", pattern="job:completed", payload="JobResult",
    durable=True,
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="CH_JOB_COMPLETED",
    description="Global job-success lifecycle event.")
register_channel(
    "job:failed", pattern="job:failed", payload="JobResult", durable=True,
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="CH_JOB_FAILED",
    description="Global job-failure / NACK lifecycle event (nack=True "
                "requeues without burning the retry ladder).")
register_channel(
    "job:result", pattern="job:result:{job_id}", payload="JobResult",
    durable=True,
    publishers=("gridllm_tpu/worker/service.py",
                "gridllm_tpu/scheduler/scheduler.py"),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="job_result_channel",
    description="Per-job final result delivered to the submit waiter.")
register_channel(
    "job:stream", pattern="job:stream:{job_id}", payload="StreamChunk",
    durable=True,
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="job_stream_channel",
    description="Per-job token stream frames (absolute char offsets; "
                "the gateway trims resume overlap).")
register_channel(
    "job:snapshot", pattern="job:snapshot", payload="keys",
    keys=("jobId", "workerId", "tokens", "seed"), durable=True,
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="CH_JOB_SNAPSHOT",
    description="Decode-resume watermarks (generated ids + resolved "
                "sampler seed) at the snapshot cadence.")
register_channel(
    "job:handoff", pattern="job:handoff", payload="keys",
    keys=("jobId", "fromWorker", "toWorker", "ok", "reason", "tokens",
          "bytes", "seconds", "path"), durable=True,
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="CH_JOB_HANDOFF",
    description="Disagg prefill→decode handoff report (ok=False counts "
                "the local-serve fallback).")
register_channel(
    "job:drain", pattern="job:drain", payload="keys",
    keys=("jobId", "fromWorker", "toWorker", "migrated", "snapshot",
          "tokens", "bytes"), durable=True,
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="CH_JOB_DRAIN",
    description="Graceful-drain handoff: suspended decode moved to a "
                "peer (or requeued) with its resume snapshot.")
register_channel(
    "job:preempted", pattern="job:preempted", payload="keys",
    keys=("jobId", "fromWorker", "snapshot", "tokens", "parkedTokens"),
    durable=True,
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="CH_JOB_PREEMPTED",
    description="Suspend-to-host preemption report; the victim requeues "
                "behind the higher-priority work.")
register_channel(
    "ctrl:submit", pattern="ctrl:submit", payload="keys",
    keys=("request", "submitter"), durable=True,
    publishers=("gridllm_tpu/controlplane/client.py",),
    subscribers=("gridllm_tpu/controlplane/shard.py",),
    helper="CH_CTRL_SUBMIT",
    description="Gateway-replica job submission fan-out: "
                "every scheduler shard consumes it and the one owning "
                "shard_of(job id) enqueues; durable so a submission "
                "published while a shard's subscriber reconnects "
                "replays instead of vanishing.")
register_channel(
    "ctrl:cancel", pattern="ctrl:cancel", payload="keys",
    keys=("jobId", "reason", "submitter"), durable=True,
    publishers=("gridllm_tpu/controlplane/client.py",),
    subscribers=("gridllm_tpu/controlplane/shard.py",),
    helper="CH_CTRL_CANCEL",
    description="Gateway-replica cancellation relay: the owning shard "
                "runs its local cancel path (queued, retrying, or "
                "active).")
register_channel(
    "ctrl:status", pattern="ctrl:status", payload="keys",
    keys=("member", "role", "ts", "shards", "leases", "stats", "slo",
          "queued", "active", "hangs"),
    publishers=("gridllm_tpu/controlplane/status.py",),
    subscribers=("gridllm_tpu/controlplane/status.py",),
    helper="CH_CTRL_STATUS",
    description="Periodic control-plane member status envelopes; the "
                "gateway replicas' FleetView aggregates them into one "
                "fleet-wide /metrics + /admin/slo + /health view "
                "(best-effort, re-published every interval).")
register_channel(
    "trace", pattern="trace:{request_id}", payload="keys",
    keys=("requestId", "workerId", "spans"),
    publishers=("gridllm_tpu/worker/service.py",),
    subscribers=("gridllm_tpu/scheduler/scheduler.py",),
    helper="trace_channel",
    description="Worker-side span timelines, stitched into one trace by "
                "the gateway (helper lives in obs/tracer.py; the "
                "scheduler psubscribes trace_pattern()).")
register_channel(
    "kvx", pattern="kvx:{xfer_id}", payload="opaque", durable=True,
    publishers=("gridllm_tpu/transfer/migrate.py",),
    subscribers=("gridllm_tpu/transfer/migrate.py",),
    helper="kvx_channel",
    description="KV-page migration chunk streams (versioned wire frames, "
                "per-attempt transfer id — transfer/wire.py).")
register_channel(
    "slice", pattern="slice:{worker_id}:plan", payload="keys",
    keys=("seq", "rec"),
    publishers=("gridllm_tpu/worker/plan.py",),
    subscribers=("gridllm_tpu/worker/plan.py",),
    helper="plan_channel",
    description="Multi-host SPMD plan replay: liaison publishes ordered "
                "engine plan ops, followers apply in lockstep.")
register_channel(
    "obs:event", pattern="obs:event", payload="keys",
    keys=("member", "events"), durable=True,
    publishers=("gridllm_tpu/obs/timeline.py",),
    subscribers=("gridllm_tpu/obs/timeline.py",),
    helper="CH_OBS_EVENT",
    description="Fleet timeline event batches: every member's "
                "TimelinePublisher flushes HLC-stamped lifecycle events "
                "here; TimelineStore instances on gateway replicas and "
                "shards merge them into the causal fleet log behind "
                "/admin/timeline and /admin/incidents. Durable: a "
                "subscriber mid-reconnect replays the ring instead of "
                "losing the incident window it exists to capture.")
register_channel(
    "obs:dump", pattern="obs:dump", payload="keys",
    keys=("opId", "requester"),
    publishers=("gridllm_tpu/gateway/obs_routes.py",),
    subscribers=("gridllm_tpu/controlplane/status.py",),
    helper="CH_OBS_DUMP",
    description="Fleet-merged dump fan-out: a gateway replica "
                "serving /admin/dump?fleet=1 broadcasts a collection op; "
                "every control-plane member's StatusPublisher answers "
                "with its local dump artifact on the per-op reply "
                "channel. Best-effort — a silent member is reported "
                "missing, never silently merged.")
register_channel(
    "obs:dump:reply", pattern="obs:dump:reply:{op_id}", payload="keys",
    keys=("opId", "member", "dump"), durable=True,
    publishers=("gridllm_tpu/controlplane/status.py",),
    subscribers=("gridllm_tpu/gateway/obs_routes.py",),
    helper="obs_dump_reply_channel",
    description="Per-op replies to a fleet dump collection: one message "
                "per live member, keyed by member identity. Durable so a "
                "reply published while the requester's subscriber is "
                "still settling replays instead of vanishing.")
register_channel(
    "health:state", pattern="health:state", payload="keys",
    keys=("worker", "state", "reason", "member", "ts"), durable=True,
    publishers=("gridllm_tpu/obs/health.py",),
    subscribers=("gridllm_tpu/scheduler/registry.py",),
    helper="CH_HEALTH_STATE",
    description="Worker health-state transitions: the shard's "
                "health monitor announces online/degraded/quarantined/"
                "probation verdicts; every registry (shards AND observer "
                "replicas) applies them to its worker table so placement "
                "and /health/workers agree fleet-wide. Durable: a missed "
                "quarantine verdict would leave a replica routing at a "
                "bad worker.")


# -- registry constants & helpers (the only sanctioned channel spellings) ----

CH_WORKER_ADMIN = "worker:admin"
CH_WORKER_REGISTERED = "worker:registered"
CH_WORKER_UNREGISTERED = "worker:unregistered"
CH_WORKER_HEARTBEAT = "worker:heartbeat"
CH_WORKER_STATUS_UPDATE = "worker:status_update"
CH_WORKER_DISCONNECTED = "worker:disconnected"
CH_JOB_COMPLETED = "job:completed"
CH_JOB_FAILED = "job:failed"
CH_JOB_SNAPSHOT = "job:snapshot"
CH_JOB_HANDOFF = "job:handoff"
CH_JOB_DRAIN = "job:drain"
CH_JOB_PREEMPTED = "job:preempted"
CH_CTRL_SUBMIT = "ctrl:submit"
CH_CTRL_CANCEL = "ctrl:cancel"
CH_CTRL_STATUS = "ctrl:status"
CH_OBS_EVENT = "obs:event"
CH_OBS_DUMP = "obs:dump"
CH_HEALTH_STATE = "health:state"


def worker_job_channel(worker_id: str) -> str:
    return f"worker:{worker_id}:job"


def worker_reregister_channel(worker_id: str) -> str:
    return f"worker:reregister:{worker_id}"


def admin_result_channel(op_id: str) -> str:
    return f"admin:result:{op_id}"


def job_result_channel(job_id: str) -> str:
    return f"job:result:{job_id}"


def job_stream_channel(job_id: str) -> str:
    return f"job:stream:{job_id}"


def kvx_channel(xfer_id: str) -> str:
    return f"kvx:{xfer_id}"


def plan_channel(worker_id: str) -> str:
    return f"slice:{worker_id}:plan"


def obs_dump_reply_channel(op_id: str) -> str:
    return f"obs:dump:reply:{op_id}"


# -- derived classification (pattern matchers over the registry) -------------

def _compile_pattern(pattern: str) -> Callable[[str], bool]:
    """Matcher for one registered pattern: literal segments must appear in
    order, ``{placeholder}`` segments match one-or-more characters."""
    parts = re.split(r"\{[^{}]+\}", pattern)
    if len(parts) == 1:
        lit = parts[0]
        return lambda ch: ch == lit
    first, *mid, last = parts

    def match(ch: str) -> bool:
        if not ch.startswith(first):
            return False
        pos = len(first)
        for seg in mid:
            idx = ch.find(seg, pos + 1)  # placeholder is ≥ 1 char
            if idx < 0:
                return False
            pos = idx + len(seg)
        if last:
            return ch.endswith(last) and len(ch) >= pos + 1 + len(last)
        return len(ch) > pos

    return match


# fixed channels resolve by dict lookup; parameterized ones walk matchers.
# Compiled lazily and invalidated by registry size so a register_channel()
# call after import (tests, future plugins) is never silently ignored by
# durable_channel()/channel_class().
_MATCHERS: tuple[int, dict[str, ChannelSpec],
                 tuple[tuple[Callable[[str], bool], ChannelSpec], ...]] \
    = (-1, {}, ())


def _matchers() -> tuple[dict[str, ChannelSpec],
                         tuple[tuple[Callable[[str], bool],
                                     ChannelSpec], ...]]:
    global _MATCHERS
    version, fixed, param = _MATCHERS
    if version != len(CHANNELS):
        fixed = {s.pattern: s for s in CHANNELS.values()
                 if "{" not in s.pattern}
        param = tuple((_compile_pattern(s.pattern), s)
                      for s in CHANNELS.values() if "{" in s.pattern)
        _MATCHERS = (len(CHANNELS), fixed, param)
    return fixed, param


def channel_spec(channel: str) -> ChannelSpec | None:
    """The registered spec a concrete channel name belongs to, or None."""
    fixed, param = _matchers()
    spec = fixed.get(channel)
    if spec is not None:
        return spec
    for match, s in param:
        if match(channel):
            return s
    return None


def channel_class(channel: str) -> str:
    """Collapse per-id channels (``job:stream:{id}``, ``worker:{id}:job``)
    into their registered family name for metric labels. Derived from the
    channel registry; unregistered channels pass through unchanged."""
    spec = channel_spec(channel)
    return channel if spec is None else spec.family


def durable_channel(channel: str) -> bool:
    """True when the broker sequences + ring-buffers this channel.
    Derived from the channel registry — durability is declared exactly
    once, on the ChannelSpec."""
    spec = channel_spec(channel)
    return spec is not None and spec.durable


# Sequence framing on durable channels: the broker prefixes the payload
# with an out-of-band marker + seq so subscribers can dedupe replays.
# Payloads are JSON in this protocol, so the NUL-framed marker can never
# collide with organic content; a broker that doesn't sequence (real
# Redis) simply yields seq=None and the client skips dedupe/resume.
_SEQ_MARK = "\x00q\x00"


def encode_seq(seq: int, payload: str) -> str:
    return f"{_SEQ_MARK}{seq}\x00{payload}"


def split_seq(payload: str) -> tuple[int | None, str]:
    """(seq, body) for a seq-framed payload; (None, payload) otherwise."""
    if not payload.startswith(_SEQ_MARK):
        return None, payload
    rest = payload[len(_SEQ_MARK):]
    num, sep, body = rest.partition("\x00")
    if not sep or not num.isdigit():
        return None, payload
    return int(num), body


def liveness_suspended(bus: "MessageBus", grace_ms: float) -> bool:
    """Partition-aware liveness: True while the bus session is
    degraded OR within the rejoin grace window after it recovered. The
    registry suspends worker-death verdicts and the scheduler defers
    orphan sweeps while this holds — a broker bounce must not be read as
    a fleet-wide worker die-off (every heartbeat went missing because WE
    were deaf, not because the workers died)."""
    st = bus.partition_state()
    if st.get("degraded"):
        return True
    rejoined = st.get("lastRejoin")
    if rejoined is None:
        return False
    return (time.monotonic() - float(rejoined)) * 1000.0 < grace_ms


def record_publish(channel: str, message: str | None = None) -> str | None:
    """Called by bus implementations on every publish. The bus.publish
    fault site lives here — BEFORE the accounting and the actual send, so
    an injected publish failure looks exactly like a dead bus to the
    caller (the message never leaves the process).

    Fleet timeline: when ``message`` is given, it comes back
    HLC-framed (stamped with the process clock's ``tick()``) and the bus
    implementation sends the RETURNED string; lifecycle families in
    ``EDGE_FAMILIES`` additionally leave a ``bus.send`` edge event
    carrying the same stamp, so a receiver's merge provably orders the
    matching ``bus.recv`` after it."""
    faults.inject("bus.publish")
    cls = channel_class(channel)
    _PUBLISHED.inc(channel=cls)
    if message is None:
        return None
    stamp = default_clock().tick()
    if timeline_armed() and cls in EDGE_FAMILIES:
        emit_event("bus.send", request_id=edge_request_id(message),
                   stamp=stamp, channel=cls)
    return encode_hlc(stamp, message)


class HandlerPump:
    """Per-handler FIFO delivery: a queue plus one pump task, so a handler
    always finishes message N before seeing N+1 (token-stream frames on
    `job:stream:{id}` rely on in-order delivery), while publishers never
    block. Handler exceptions are logged and do not kill the pump."""

    def __init__(self, handler: Handler):
        self.handler = handler
        self.queue: asyncio.Queue[tuple[str, str, float]] = asyncio.Queue()
        self.task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        while True:
            channel, message, t_push = await self.queue.get()
            if faults.check("bus.deliver"):
                # injected delivery loss: the handler never sees the
                # message — exactly what an at-least-once consumer must
                # survive via sweeps/retries/heartbeat timeouts (and no
                # HLC merge: a dropped message established no order)
                self.queue.task_done()
                continue
            cls = channel_class(channel)
            stamp, message = split_hlc(message)
            if stamp is not None:
                # HLC merge hook: the local clock advances
                # past the sender's stamp, so every event this process
                # emits from here on is provably after the send
                merged = default_clock().update(stamp)
                if timeline_armed() and cls in EDGE_FAMILIES:
                    emit_event("bus.recv",
                               request_id=edge_request_id(message),
                               stamp=merged, channel=cls)
            _DELIVERED.inc(channel=cls)
            _DELIVERY_LATENCY.observe(
                max(0.0, time.monotonic() - t_push), channel=cls
            )
            try:
                await self.handler(channel, message)
            except asyncio.CancelledError:
                raise
            except Exception:
                import traceback

                traceback.print_exc()
            finally:
                self.queue.task_done()

    def push(self, channel: str, message: str) -> None:
        self.queue.put_nowait((channel, message, time.monotonic()))

    async def drain(self) -> None:
        await self.queue.join()

    def stop(self) -> None:
        self.task.cancel()


class Subscription:
    """Handle for one (pattern|channel, handler) registration."""

    def __init__(self, unsubscribe: Callable[[], Awaitable[None]], target: str):
        self._unsubscribe = unsubscribe
        self.target = target
        self.active = True

    async def unsubscribe(self) -> None:
        if self.active:
            self.active = False
            await self._unsubscribe()


class MessageBus(abc.ABC):
    """KV + hash + pub/sub bus. All ``key`` args get the configured prefix."""

    def __init__(self, key_prefix: str = "GridLLM:"):
        self.key_prefix = key_prefix

    def _k(self, key: str) -> str:
        return f"{self.key_prefix}{key}"

    # -- lifecycle ----------------------------------------------------------
    @abc.abstractmethod
    async def connect(self) -> None: ...

    @abc.abstractmethod
    async def disconnect(self) -> None: ...

    @abc.abstractmethod
    async def is_healthy(self) -> bool:
        """reference: RedisService.isHealthy (ping), RedisService.ts:270-277."""

    def partition_state(self) -> dict[str, Any]:
        """Point-in-time session health for partition-aware liveness
       : ``degraded`` while this process's subscriber session
        is down (its view of heartbeats/events is stale, not the fleet),
        ``since`` the monotonic start of the current partition, and
        ``lastRejoin`` the monotonic time the session last recovered.
        In-process buses are never partitioned — only RespBus overrides."""
        return {"degraded": False, "since": None, "lastRejoin": None}

    # -- KV -----------------------------------------------------------------
    @abc.abstractmethod
    async def get(self, key: str) -> str | None: ...

    @abc.abstractmethod
    async def set(self, key: str, value: str) -> None: ...

    @abc.abstractmethod
    async def set_with_expiry(self, key: str, value: str, ttl_s: float) -> None:
        """reference: setWithExpiry — heartbeat TTL keys
        (RedisConnectionManager.ts:299-309)."""

    @abc.abstractmethod
    async def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    async def ttl(self, key: str) -> int:
        """Seconds to live; -1 no expiry; -2 missing (Redis TTL semantics —
        the liveness probe reads this, WorkerRegistry.ts:161-180)."""

    # -- hash ---------------------------------------------------------------
    @abc.abstractmethod
    async def hget(self, key: str, field: str) -> str | None: ...

    @abc.abstractmethod
    async def hset(self, key: str, field: str, value: str) -> None: ...

    @abc.abstractmethod
    async def hgetall(self, key: str) -> dict[str, str]: ...

    @abc.abstractmethod
    async def hdel(self, key: str, field: str) -> None: ...

    # -- pub/sub ------------------------------------------------------------
    @abc.abstractmethod
    async def publish(self, channel: str, message: str) -> int:
        """Returns receiver count when known (0 otherwise)."""

    @abc.abstractmethod
    async def subscribe(self, channel: str, handler: Handler) -> Subscription: ...

    @abc.abstractmethod
    async def psubscribe(self, pattern: str, handler: Handler) -> Subscription:
        """Glob-style pattern subscribe (reference: RedisService.ts:230-247)."""
