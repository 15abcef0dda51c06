"""Stateless gateway replica's scheduler facade.

``GatewaySubmitter`` keeps the JobScheduler's public submit surface —
``submit_and_wait`` / ``submit_streaming_job`` / ``cancel_job`` /
``get_stats`` — so every gateway route works unchanged, but owns NO
partition: ``add_job`` publishes the request on the durable
``ctrl:submit`` channel and the owning scheduler shard (shard.py)
enqueues it. Results and stream frames never touch a shard on the way
back — workers publish them on the durable per-job channels the submit
path already subscribes, which is exactly why any replica can serve any
request and why streaming state rebuilds after a replica restart: the
broker's replay rings re-deliver the frames the replica missed.

The waiter-side timeout still cancels remotely (``ctrl:cancel``); SLO
judgment stays here because only the submitting replica sees the
client-observed TTFT/e2e. Orphan sweeps, retries, deadlines, and the
hang watchdog all live on the shards.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any

from gridllm_torch.bus.base import (
    CH_CTRL_CANCEL,
    CH_CTRL_SUBMIT,
    MessageBus,
)
from gridllm_torch.obs.timeline import emit_event
from gridllm_torch.obs.tracer import trace_pattern
from gridllm_torch.scheduler.registry import WorkerRegistry
from gridllm_torch.scheduler.scheduler import JobScheduler
from gridllm_torch.utils.config import SchedulerConfig, SLOConfig
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import InferenceRequest

log = get_logger("controlplane.client")


def make_member_id(configured: str, role: str) -> str:
    """Stable-if-configured member id (GRIDLLM_CONTROLPLANE_ID); the
    generated fallback is unique per process so status envelopes and
    lease owners never collide."""
    return configured or f"{role}-{uuid.uuid4().hex[:8]}"


class GatewaySubmitter(JobScheduler):
    """A JobScheduler that owns nothing: submissions fan out on the bus,
    and only the submit-side state (waiters, tracer, SLO) lives here."""

    def __init__(self, bus: MessageBus, registry: WorkerRegistry,
                 config: SchedulerConfig | None = None,
                 slo_config: SLOConfig | None = None,
                 member_id: str = ""):
        super().__init__(bus, registry, config, slo_config=slo_config)
        self.member_id = make_member_id(member_id, "gateway")

    # -- lifecycle -----------------------------------------------------------
    async def initialize(self) -> None:
        """Submit-side wiring only: no lifecycle-channel subscriptions,
        no dispatch/sweep loops, no watchdog — a replica has no queue to
        sweep and no assignments to watch. Worker span timelines are
        still ingested so /admin/trace stitches end to end on whichever
        replica served the request."""
        self._running = True
        self._subs.append(
            await self.bus.psubscribe(trace_pattern(), self._on_trace))
        log.info("gateway submitter initialized", member=self.member_id)

    # -- submit surface ------------------------------------------------------
    async def add_job(self, request: InferenceRequest,
                      requeue: bool = False) -> str:
        """Publish the request to the scheduler shards. The per-class
        deadline is stamped HERE (submission time is the gateway's
        clock); everything downstream — queueing, dispatch, retries —
        belongs to the owning shard."""
        md = request.metadata
        if "deadlineAt" not in md:
            deadline_ms = self._deadline_for(request)
            if deadline_ms > 0:
                md["deadlineAt"] = time.time() + deadline_ms / 1000
        await self.bus.publish(CH_CTRL_SUBMIT, json.dumps({
            "request": request.model_dump(mode="json"),
            "submitter": self.member_id,
        }))
        # accounted as ctrl published ONLY: the owning shard counts the
        # job's `queued` event (and its terminal event) — counting it
        # here too would double every job fleet-wide and break the
        # "queued balances against terminal events" invariant
        self._ctrl_submits.inc(event="published")
        # fleet timeline: the gateway-side anchor of every
        # request's causal slice — attributed to THIS replica, ordered
        # before the owning shard's events by the ctrl:submit bus edge
        emit_event("gateway.submitted", member=self.member_id,
                   request_id=request.id, model=request.model)
        log.job("job published to scheduler shards", request.id,
                model=request.model)
        self.emit("job_queued", request)
        return request.id

    async def cancel_job(self, job_id: str, reason: str = "cancelled") -> bool:
        """Relay the cancellation; the owning shard resolves whether the
        job was queued, retrying, or active and accounts it exactly once."""
        await self.bus.publish(CH_CTRL_CANCEL, json.dumps({
            "jobId": job_id, "reason": reason,
            "submitter": self.member_id,
        }))
        self._drop_resume_state(job_id)
        return True

    def identity(self) -> dict[str, Any]:
        return {"role": "gateway", "member": self.member_id,
                "shards": [], "numShards": 0}
