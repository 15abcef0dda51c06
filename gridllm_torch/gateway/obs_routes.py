"""Observability endpoints + HTTP metrics middleware (the JAX package's
gateway/obs_routes.py).

- ``GET /metrics``: Prometheus text exposition. Renders the scheduler's
  per-instance registry (gateway/scheduler/worker-liveness/SLO series) plus
  the process-global default registry (bus, and — in single-process
  deployments — engine/kernel series).
- ``GET /admin/trace/{request_id}``: the stitched gateway+worker span
  timeline recorded by obs/tracer.py.
- ``GET /admin/timeline[/{request_id}]`` and ``GET /admin/incidents``: the
  HLC-ordered fleet timeline (obs/timeline.py TimelineStore) and the
  incident reports assembled from it (obs/forensics.py).
- ``GET /admin/slo``: per-class SLO attainment, burn rates, and goodput
  from obs/slo.py — the same state the ``gridllm_slo_*`` gauges render.
- ``GET /admin/capacity``: per-model demand/utilization/headroom and the
  derived scale hint from obs/capacity.py (plus the per-tenant usage
  ledger) — the same state the ``gridllm_capacity_*`` gauges render.
- ``GET /admin/dump``: the flight-recorder post-mortem artifact
  (obs/flightrec.py): event rings, active traces, SLO snapshot, registry
  and engine state, plus any retained auto dumps from hang/crash detection.
- ``GET /admin/memory``: per-device weights/KV/workspace breakdown with
  headroom (obs/perf.py). Covers THIS process's devices: in single-process
  stacks that includes the engines; in a split deployment the worker
  health port serves the engine-side view.
- ``POST /admin/profile?seconds=N``: refused with 501 (obs/perf.py
  handle_profile_request): a capture runs through an engine, so it is the
  worker health port's route.
- ``metrics_middleware``: request count by route/method/status and
  end-to-end latency histogram by route. Route labels use the matched
  route's canonical pattern (``/inference/{job_id}/status``), never the raw
  path, so label cardinality stays bounded. Server-fault responses (5xx)
  also land in the gateway flight-recorder ring.
"""

from __future__ import annotations

import asyncio
import time

from aiohttp import web

from gridllm_torch.obs import (
    PROMETHEUS_CONTENT_TYPE,
    build_dump,
    default_flight_recorder,
    default_registry,
    render_registries,
    stamp_key,
    timeline_emitter,
)
from gridllm_torch.scheduler import JobScheduler

def metrics_middleware(scheduler: JobScheduler):
    requests_total = scheduler.metrics.counter(
        "gridllm_gateway_requests_total",
        "HTTP requests handled by the gateway, by route/method/status.",
        ("route", "method", "status"),
    )
    duration = scheduler.metrics.histogram(
        "gridllm_gateway_request_duration_seconds",
        "End-to-end HTTP request latency (including streaming bodies), "
        "by route.",
        ("route",),
    )

    def route_of(request: web.Request) -> str:
        info = request.match_info
        resource = info.route.resource if info.route is not None else None
        canonical = getattr(resource, "canonical", None)
        return canonical or "unmatched"

    @web.middleware
    async def middleware(request: web.Request, handler):
        if request.path == "/metrics":
            return await handler(request)  # don't count scrapes
        t0 = time.monotonic()
        status = 500
        try:
            response = await handler(request)
            status = response.status
            return response
        except web.HTTPException as e:
            status = e.status
            raise
        except asyncio.CancelledError:
            # client closed the connection mid-stream — not a server fault;
            # 499 per the nginx convention so disconnects don't pollute the
            # 5xx error rate
            status = 499
            raise
        finally:
            route = route_of(request)
            requests_total.inc(route=route, method=request.method,
                               status=str(status))
            duration.observe(time.monotonic() - t0, route=route)
            if status >= 500:  # server faults only — the ring is for
                default_flight_recorder().record(  # post-mortems, not access logs
                    "gateway", "server_error", route=route,
                    method=request.method, status=status)

    return middleware


def build_routes(scheduler: JobScheduler, timeline=None,
                 incidents=None) -> list[web.RouteDef]:
    """The JAX package's routes in its local control-plane mode (its
    FleetView's fleet-wide additions to /admin/slo, /admin/capacity,
    /admin/health/fleet and /admin/dump come with the scaled control
    plane).

    ``timeline`` / ``incidents`` (obs/timeline.py TimelineStore +
    obs/forensics.py IncidentCollector) arm the
    /admin/timeline/{request_id} and /admin/incidents forensic surfaces;
    None (timeline disabled) serves 503 so a disarmed member is
    distinguishable from an empty timeline."""

    async def _flush_local_timeline() -> None:
        # serving a forensic read flushes THIS process's pending events
        # first, so single-process fleets (tests, the smoke run) read their own
        # just-emitted history without waiting a flush interval
        pub = timeline_emitter()
        if pub is not None:
            for _ in range(8):
                if await pub.flush_once() == 0:
                    break
        drain = getattr(scheduler.bus, "flush", None)
        if drain is not None:
            try:
                await drain()
            except Exception:  # noqa: BLE001 — reads stay best-effort
                pass

    async def timeline_slice(request: web.Request) -> web.Response:
        if timeline is None:
            raise web.HTTPServiceUnavailable(
                text="timeline disabled (GRIDLLM_TIMELINE=0)")
        request_id = request.match_info["request_id"]
        await _flush_local_timeline()
        events = timeline.slice(request_id)
        spans = scheduler.tracer.export(request_id) or []
        if not events and not spans:
            from gridllm_torch.gateway.errors import ApiError

            raise ApiError(
                f"No timeline recorded for request '{request_id}'",
                404, "TIMELINE_NOT_FOUND")
        return web.json_response({
            "requestId": request_id,
            "events": events,  # HLC (causal) order, fleet-stitched
            "spans": spans,    # tracer wall-clock intervals, merged in
            "members": sorted({str(ev.get("member") or "?")
                               for ev in events}),
        })

    async def timeline_window(request: web.Request) -> web.Response:
        if timeline is None:
            raise web.HTTPServiceUnavailable(
                text="timeline disabled (GRIDLLM_TIMELINE=0)")
        await _flush_local_timeline()
        events = sorted(timeline.events(), key=stamp_key)
        try:
            limit = int(request.query.get("limit", "256"))
        except ValueError:
            limit = 256
        if limit > 0:
            events = events[-limit:]
        return web.json_response({
            "events": events,  # HLC (causal) order, fleet-merged
            "members": sorted({str(ev.get("member") or "?")
                               for ev in events}),
        })

    async def incident_reports(request: web.Request) -> web.Response:
        if incidents is None:
            raise web.HTTPServiceUnavailable(
                text="timeline disabled (GRIDLLM_TIMELINE=0)")
        await _flush_local_timeline()
        return web.json_response({
            "member": scheduler.identity(),
            "incidents": incidents.reports(),
        })

    async def metrics(request: web.Request) -> web.Response:
        text = render_registries(scheduler.metrics, default_registry())
        return web.Response(text=text,
                            headers={"Content-Type": PROMETHEUS_CONTENT_TYPE})

    async def trace(request: web.Request) -> web.Response:
        request_id = request.match_info["request_id"]
        spans = scheduler.tracer.export(request_id)
        if spans is None:
            from gridllm_torch.gateway.errors import ApiError

            raise ApiError(f"No trace recorded for request '{request_id}'",
                           404, "TRACE_NOT_FOUND")
        return web.json_response({
            "requestId": request_id,
            "spans": spans,
            "sources": sorted({s["source"] for s in spans}),
        })

    async def slo(request: web.Request) -> web.Response:
        snap = scheduler.slo.snapshot()
        # shard identity label: the snapshot always
        # says WHOSE judgments these are, so sharded deployments cannot
        # silently aggregate per-member numbers into one unlabeled view
        snap["shard"] = scheduler.identity()
        return web.json_response(snap)

    async def capacity(request: web.Request) -> web.Response:
        # fleet capacity & demand: this member's per-model
        # snapshot plus — on scaled control planes — the cross-shard
        # merge, so any replica serves the same fleet-wide view the
        # future autoscaler consumes
        snap = scheduler.capacity.snapshot()
        snap["shard"] = scheduler.identity()
        snap["usage"] = scheduler.usage.snapshot()
        return web.json_response(snap)

    async def health_fleet(request: web.Request) -> web.Response:
        # active fleet health: this member's worker health
        # verdicts + canary prober summary, plus — on scaled control
        # planes — every member's view keyed by identity, so any replica
        # answers "which workers are degraded/quarantined and why"
        snap = {
            "shard": scheduler.identity(),
            "health": (scheduler.health.snapshot()
                       if getattr(scheduler, "health", None) is not None
                       else None),
            "canary": (scheduler.prober.summary()
                       if getattr(scheduler, "prober", None) is not None
                       else None),
        }
        return web.json_response(snap)

    async def dump(request: web.Request) -> web.Response:
        return web.json_response(build_dump(scheduler, reason="on_demand"))

    async def memory(request: web.Request) -> web.Response:
        from gridllm_torch.obs import memory_snapshot

        # to_thread: the snapshot reads every engine's probe and the CUDA
        # allocator's statistics synchronously
        return web.json_response(await asyncio.to_thread(memory_snapshot))

    async def profile(request: web.Request) -> web.Response:
        return await start_profile_capture(request)

    return [
        web.get("/metrics", metrics),
        web.get("/admin/trace/{request_id}", trace),
        web.get("/admin/timeline", timeline_window),
        web.get("/admin/timeline/{request_id}", timeline_slice),
        web.get("/admin/incidents", incident_reports),
        web.get("/admin/slo", slo),
        web.get("/admin/capacity", capacity),
        web.get("/admin/health/fleet", health_fleet),
        web.get("/admin/dump", dump),
        web.get("/admin/memory", memory),
        web.post("/admin/profile", profile),
    ]


async def start_profile_capture(request: web.Request) -> web.Response:
    """``POST /admin/profile?seconds=N``: the gateway holds no engine, so
    obs/perf.py's handle_profile_request refuses and names the worker
    health port, whose route takes the capture."""
    from gridllm_torch.obs.perf import handle_profile_request

    status, payload = handle_profile_request()
    return web.json_response(payload, status=status)
