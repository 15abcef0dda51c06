"""Health/observability endpoints (the JAX package's gateway/health_routes.py).

Reference analogue: server/src/routes/health.ts (172 LoC): /health basic,
/health/live, /health/ready (503 when bus/registry/scheduler not ready),
/health/system (workers/jobs/memory/CPU), /health/workers, /health/jobs.
"""

from __future__ import annotations

import os
import time

from aiohttp import web

from gridllm_torch.bus.base import MessageBus
from gridllm_torch.scheduler import JobScheduler, WorkerRegistry

_START = time.time()


def build_routes(bus: MessageBus, registry: WorkerRegistry,
                 scheduler: JobScheduler, version: str,
                 fleet=None) -> list[web.RouteDef]:

    async def health(request: web.Request) -> web.Response:
        return web.json_response({
            "status": "healthy",
            "timestamp": time.time(),
            "uptime": time.time() - _START,
            "version": version,
        })

    async def live(request: web.Request) -> web.Response:
        return web.json_response({"status": "alive"})

    async def ready(request: web.Request) -> web.Response:
        bus_ok = await bus.is_healthy()
        checks = {
            "redis": bus_ok,
            "workerRegistry": registry is not None,
            "jobScheduler": scheduler is not None,
        }
        ok = all(checks.values())
        return web.json_response(
            {"status": "ready" if ok else "not_ready", "checks": checks},
            status=200 if ok else 503)

    async def system(request: web.Request) -> web.Response:
        try:
            import resource

            max_rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        except Exception:
            max_rss_kb = 0
        la1, la5, la15 = os.getloadavg()
        stats = scheduler.get_stats()
        return web.json_response({
            "status": "healthy",
            "workers": registry.get_worker_count(),
            "jobs": stats,
            "system": {
                "maxRssMB": round(max_rss_kb / 1024, 1),
                "loadAvg": [la1, la5, la15],
                "cpuCount": os.cpu_count(),
                "uptime": time.time() - _START,
            },
        })

    async def workers(request: web.Request) -> web.Response:
        detail = []
        for w in registry.get_all_workers():
            detail.append({
                "workerId": w.workerId,
                "status": w.status,
                "healthState": w.healthState,
                "role": w.role,
                "decodeSlotsFree": w.decodeSlotsFree,
                "currentJobs": w.currentJobs,
                "totalJobsProcessed": w.totalJobsProcessed,
                "lastHeartbeat": w.lastHeartbeat,
                "connectionHealth": w.connectionHealth,
                "models": w.model_names(),
                "maxConcurrentTasks": w.capabilities.maxConcurrentTasks,
                "performanceTier": w.capabilities.performanceTier,
                "topology": (w.capabilities.topology.model_dump()
                             if w.capabilities.topology else None),
            })
        body = {"workers": detail,
                "counts": registry.get_worker_count(),
                "roles": registry.role_counts()}
        if fleet is not None:
            # scaled control plane: the worker table above is already
            # fleet-wide (heartbeats fan out to every member); attach the
            # control-plane members so one call shows both planes
            # regardless of which replica answered
            body["controlPlane"] = {"member": scheduler.identity(),
                                    "members": fleet.members(),
                                    "numShards": fleet.num_shards()}
        return web.json_response(body)

    async def jobs(request: web.Request) -> web.Response:
        return web.json_response({
            "queue": [
                {"id": r.id, "model": r.model, "priority": r.priority.value,
                 "requestType": r.request_type}
                for r in scheduler.get_job_queue()
            ],
            "active": [
                {"jobId": a.jobId, "workerId": a.workerId,
                 "model": a.request.model, "assignedAt": a.assignedAt}
                for a in scheduler.get_active_jobs()
            ],
            "stats": scheduler.get_stats(),
        })

    return [
        web.get("/health", health),
        web.get("/health/live", live),
        web.get("/health/ready", ready),
        web.get("/health/system", system),
        web.get("/health/workers", workers),
        web.get("/health/jobs", jobs),
    ]
