"""Control-plane status fan-out + fleet-wide aggregation.

Every control-plane member (gateway replica or scheduler shard)
publishes a periodic envelope on ``ctrl:status``; each gateway
replica's ``FleetView`` keeps the latest envelope per member and serves
the thin aggregation layer the admin surface reads — so ``/metrics``,
``/admin/slo``, ``/admin/dump``, and ``/health/workers`` present one
fleet-wide view regardless of which replica is asked, WITHOUT ever
summing unlabeled numbers: everything stays keyed by member/shard
identity (the "health and scrapes agree" invariant, per shard).

A member whose envelope goes stale (no publish within the prune
window) drops out of the view; a shard partition nobody fresh claims
reads as lease-lost (``gridllm_shard_lease_held`` 0 — the
``GridLLMShardLeaseLost`` alert) until a survivor adopts it.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any

from gridllm_torch.bus.base import (
    CH_CTRL_STATUS,
    CH_OBS_DUMP,
    MessageBus,
    Subscription,
    obs_dump_reply_channel,
)
from gridllm_torch.obs import MetricsRegistry, build_dump, merge_capacity
from gridllm_torch.utils.logging import get_logger

log = get_logger("controlplane.status")


class StatusPublisher:
    """Periodic ``ctrl:status`` envelope for one member. Shards attach
    their scheduler + lease state; gateway replicas publish their
    submit-side SLO view so /admin/slo aggregates the client-observed
    judgments from every replica."""

    def __init__(self, bus: MessageBus, scheduler: Any, role: str,
                 member_id: str, interval_ms: float,
                 lease: Any | None = None):
        self.bus = bus
        self.scheduler = scheduler
        self.role = role
        self.member_id = member_id
        self.interval_s = interval_ms / 1000.0
        self.lease = lease
        self._task: asyncio.Task | None = None
        self._dump_sub: Subscription | None = None

    def _per_shard_counts(self) -> dict[str, dict[str, Any]]:
        """Exact per-partition queue/active counts (a member may hold
        several partitions after adoption — attribute jobs to the one
        that owns them, not to the member as a blob)."""
        sched = self.scheduler
        if sched.shard is None or self.lease is None:
            return {}
        out = {str(i): {"epoch": e, "queued": 0, "active": 0}
               for i, e in self.lease.held_epochs().items()}
        for qj in list(sched.job_queue):
            rec = out.get(str(sched.shard.shard_for(qj.request.id)))
            if rec is not None:
                rec["queued"] += 1
        for job_id in list(sched.active_jobs):
            rec = out.get(str(sched.shard.shard_for(job_id)))
            if rec is not None:
                rec["active"] += 1
        return out

    def envelope(self) -> str:
        sched = self.scheduler
        return json.dumps({
            "member": self.member_id,
            "role": self.role,
            "ts": time.time(),
            "shards": (self.lease.held_shards()
                       if self.lease is not None else []),
            "leases": self._per_shard_counts(),
            "stats": sched.get_stats(),
            "slo": sched.slo.snapshot(),
            # fleet economics: this member's per-model
            # demand/headroom snapshot + its usage-ledger view; shards
            # carry the authoritative demand (they own the queues)
            "capacity": (sched.capacity.snapshot()
                         if getattr(sched, "capacity", None) is not None
                         else None),
            "usage": (sched.usage.snapshot()
                      if getattr(sched, "usage", None) is not None
                      else None),
            # active fleet health: this member's worker health
            # verdicts + canary summary — shards carry the authoritative
            # view (their monitors issue the verdicts)
            "health": (sched.health.snapshot()
                       if getattr(sched, "health", None) is not None
                       else None),
            "canary": (sched.prober.summary()
                       if getattr(sched, "prober", None) is not None
                       else None),
            "queued": len(sched.job_queue),
            "active": len(sched.active_jobs),
            "hangs": len(sched.watchdog.hangs),
        })

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop())
        # fleet-merged dump: every member with a status
        # publisher also answers dump collection ops, so ONE
        # /admin/dump?fleet=1 call captures the whole control plane
        self._dump_sub = await self.bus.subscribe(CH_OBS_DUMP,
                                                  self._on_dump_request)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._dump_sub is not None:
            await self._dump_sub.unsubscribe()
            self._dump_sub = None

    async def _on_dump_request(self, _ch: str, raw: str) -> None:
        """Answer one fleet dump collection op with this member's local
        artifact on the per-op reply channel (keyed by member identity;
        the requester never merges artifacts silently)."""
        try:
            op_id = str(json.loads(raw).get("opId") or "")
        except (ValueError, TypeError):
            return
        if not op_id:
            return
        try:
            artifact = build_dump(self.scheduler, reason="fleet_dump")
            await self.bus.publish(
                obs_dump_reply_channel(op_id),
                json.dumps({"opId": op_id, "member": self.member_id,
                            "dump": artifact}, default=str))
        except Exception as e:  # noqa: BLE001 — dumps are best-effort
            log.warning("fleet dump reply failed", error=str(e),
                        opId=op_id)

    async def publish_once(self) -> None:
        await self.bus.publish(CH_CTRL_STATUS, self.envelope())

    async def _loop(self) -> None:
        while True:
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — status is best-effort
                log.warning("status publish failed", error=str(e))
            await asyncio.sleep(self.interval_s)


class FleetView:
    """Latest-envelope-per-member aggregation on a gateway replica."""

    def __init__(self, bus: MessageBus, metrics: MetricsRegistry,
                 stale_after_ms: float):
        self.bus = bus
        self.stale_after_s = stale_after_ms / 1000.0
        self._members: dict[str, dict[str, Any]] = {}
        # high-water shard count: when EVERY shard envelope goes stale
        # (total shard outage — exactly when GridLLMShardLeaseLost must
        # fire) the live envelopes alone would say numShards=0 and the
        # lease-held gauges would freeze at their last value instead of
        # dropping to 0; the remembered fleet size keeps driving them
        self._max_shards = 0
        self._sub: Subscription | None = None
        self._queue_gauge = metrics.gauge(
            "gridllm_shard_queue_depth",
            "Jobs queued per scheduler-shard partition, aggregated from "
            "the shards' ctrl:status envelopes by the gateway replica "
            "serving the scrape.",
            ("shard",))
        self._active_gauge = metrics.gauge(
            "gridllm_shard_active_jobs",
            "Jobs assigned per scheduler-shard partition, aggregated "
            "from the shards' ctrl:status envelopes.",
            ("shard",))
        self._held_gauge = metrics.gauge(
            "gridllm_shard_lease_held",
            "1 while some live scheduler shard holds the partition's "
            "lease (per its fresh ctrl:status envelope), 0 while the "
            "partition is orphaned awaiting adoption — the "
            "GridLLMShardLeaseLost alert watches this.",
            ("shard",))
        self._members_gauge = metrics.gauge(
            "gridllm_controlplane_members",
            "Live control-plane members by role (gateway replicas and "
            "scheduler shards with a fresh status envelope).",
            ("role",))
        metrics.add_collector("controlplane_fleet", self._collect)

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        self._sub = await self.bus.subscribe(CH_CTRL_STATUS, self._on_status)

    async def stop(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
            self._sub = None

    async def _on_status(self, _ch: str, raw: str) -> None:
        try:
            env = json.loads(raw)
            member = str(env["member"])
        except Exception:
            return
        env["receivedAt"] = time.monotonic()
        ident = (env.get("stats") or {}).get("shard") or {}
        self._max_shards = max(self._max_shards,
                               int(ident.get("numShards") or 0))
        self._members[member] = env

    # -- aggregation ---------------------------------------------------------
    def _live_members(self) -> dict[str, dict[str, Any]]:
        now = time.monotonic()
        self._members = {
            m: env for m, env in self._members.items()
            if now - env.get("receivedAt", 0) < self.stale_after_s}
        return dict(self._members)

    def num_shards(self) -> int:
        """Fleet shard count: the high-water mark over every shard
        identity ever seen, so a total shard outage (no live envelopes)
        still reports the real fleet size and the per-shard gauges keep
        being driven (to 0 — the alert condition)."""
        for env in self._members.values():
            ident = (env.get("stats") or {}).get("shard") or {}
            self._max_shards = max(self._max_shards,
                                   int(ident.get("numShards") or 0))
        return self._max_shards

    def _collect(self) -> None:
        members = self._live_members()
        roles: dict[str, int] = {"gateway": 0, "shard": 0}
        claimed: dict[int, dict[str, Any]] = {}
        for env in members.values():
            roles[env.get("role", "?")] = roles.get(env.get("role", "?"),
                                                    0) + 1
            for idx_s, rec in (env.get("leases") or {}).items():
                try:
                    claimed[int(idx_s)] = rec
                except (TypeError, ValueError):
                    continue
        for role, n in roles.items():
            self._members_gauge.set(n, role=role)
        for idx in range(self.num_shards()):
            rec = claimed.get(idx)
            self._held_gauge.set(1 if rec is not None else 0,
                                 shard=str(idx))
            if rec is not None:
                self._queue_gauge.set(int(rec.get("queued") or 0),
                                      shard=str(idx))
                self._active_gauge.set(int(rec.get("active") or 0),
                                      shard=str(idx))

    def members(self) -> dict[str, dict[str, Any]]:
        """Envelope summaries for /health and /admin/dump — keyed by
        member id, shard identity preserved."""
        out = {}
        for member, env in self._live_members().items():
            out[member] = {
                "role": env.get("role"),
                "shards": env.get("shards"),
                "queued": env.get("queued"),
                "active": env.get("active"),
                "hangs": env.get("hangs"),
                "ageS": round(time.monotonic()
                              - env.get("receivedAt", 0), 3),
            }
        return out

    def merged_stats(self) -> dict[str, Any]:
        """Fleet job stats: per-member blocks (shard identity attached)
        plus shard-only totals — gateway replicas' submit counters are
        reported but never summed into the shard totals (they count the
        same jobs from the other side)."""
        members = self._live_members()
        per_member: dict[str, Any] = {}
        totals: dict[str, float] = {}
        for member, env in members.items():
            stats = env.get("stats") or {}
            per_member[member] = stats
            if env.get("role") != "shard":
                continue
            for key, val in stats.items():
                if isinstance(val, (int, float)) and not isinstance(
                        val, bool):
                    totals[key] = totals.get(key, 0) + val
        return {"perMember": per_member, "shardTotals": totals,
                "numShards": self.num_shards()}

    def merged_slo(self) -> dict[str, Any]:
        """Every member's SLO snapshot, keyed by member id with its role
        — attainment ratios from different members are never averaged
        into one unlabeled number."""
        return {
            member: {"role": env.get("role"), "slo": env.get("slo")}
            for member, env in self._live_members().items()}

    def merged_health(self) -> dict[str, Any]:
        """Fleet health: every member's worker-health verdicts
        and canary summary, keyed by member id with its role — verdicts
        from different monitors are presented side by side, never merged
        into one unlabeled state."""
        return {
            member: {"role": env.get("role"),
                     "health": env.get("health"),
                     "canary": env.get("canary")}
            for member, env in self._live_members().items()}

    def merged_capacity(self) -> dict[str, Any]:
        """Fleet capacity: per-member snapshots (identity
        preserved) plus the cross-shard merge — demand sums across shards
        (they partition the job-id space), worker headroom does not
        (every shard's registry observes the same workers), so the merge
        rules live in obs.capacity.merge_capacity."""
        members = self._live_members()
        per_member = {
            member: {"role": env.get("role"),
                     "capacity": env.get("capacity")}
            for member, env in members.items()}
        fleet = merge_capacity(
            env.get("capacity") or {}
            for env in members.values() if env.get("role") == "shard")
        return {"perMember": per_member, "fleet": fleet,
                "numShards": self.num_shards()}
