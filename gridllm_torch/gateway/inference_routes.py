"""Native inference API at ``/inference`` (the JAX package's
gateway/inference_routes.py).

Reference analogue: server/src/routes/inference.ts (289 LoC):
- POST /inference            (:35-125)  validate + submit_and_wait
- GET  /inference/models     (:195-250) per-model worker counts
- GET  /inference/queue      (:253-286) queue stats
- GET  /inference/{id}/status (:128-167) queued position / processing
- DELETE /inference/{id}     (:170-192) cancel
"""

from __future__ import annotations

import uuid

from aiohttp import web

from gridllm_torch.gateway.common import new_request, prefix_key, tenant_of
from gridllm_torch.gateway.common import submit as submit_job
from gridllm_torch.gateway.errors import ApiError
from gridllm_torch.scheduler import JobScheduler, WorkerRegistry
from gridllm_torch.utils.types import Priority, iso_now


def build_routes(registry: WorkerRegistry, scheduler: JobScheduler) -> list[web.RouteDef]:

    async def submit(request: web.Request) -> web.Response:
        body = await request.json()
        model = body.get("model")
        prompt = body.get("prompt")
        if not model:
            raise ApiError("Validation error: \"model\" is required", 400)
        if not prompt:
            raise ApiError("Validation error: \"prompt\" is required", 400)
        if not registry.get_workers_with_model(model):
            raise ApiError(f"Model '{model}' is not available on any worker",
                           404, "MODEL_NOT_FOUND")
        priority = body.get("priority", "medium")
        if priority not in ("high", "medium", "low"):
            raise ApiError("Validation error: \"priority\" must be one of "
                           "[high, medium, low]", 400)
        req = new_request(
            id=str(uuid.uuid4()), model=model, prompt=prompt,
            stream=False,
            options=body.get("options") or {},
            priority=Priority(priority),
            timeout=body.get("timeout") or 300_000,
            metadata={"endpoint": "/inference", "requestType": "inference",
                      "tenant": tenant_of(request),
                      "prefixKey": prefix_key(model, str(prompt)[:512]),
                      "submittedAt": iso_now()},
        )
        result = await submit_job(req, scheduler)
        d = result.response.model_dump(exclude_none=True) if result.response else {}
        return web.json_response({
            "id": req.id,
            "model": model,
            "response": d.get("response", ""),
            "done": True,
            "processingTimeMs": result.processingTimeMs,
            "worker": result.workerId,
            **{k: d[k] for k in ("total_duration", "eval_count", "eval_duration",
                                 "prompt_eval_count") if k in d},
        })

    async def status(request: web.Request) -> web.Response:
        job_id = request.match_info["job_id"]
        position = scheduler.get_queue_position(job_id)
        if position is not None:
            return web.json_response({
                "id": job_id, "status": "queued", "queuePosition": position + 1,
                "queueLength": scheduler.get_stats()["queuedJobs"]})
        for assignment in scheduler.get_active_jobs():
            if assignment.jobId == job_id:
                return web.json_response({
                    "id": job_id, "status": "processing",
                    "workerId": assignment.workerId,
                    "assignedAt": assignment.assignedAt})
        raise ApiError(f"Job '{job_id}' not found", 404, "JOB_NOT_FOUND")

    async def cancel(request: web.Request) -> web.Response:
        job_id = request.match_info["job_id"]
        if await scheduler.cancel_job(job_id):
            return web.json_response({"id": job_id, "status": "cancelled"})
        raise ApiError(f"Job '{job_id}' not found", 404, "JOB_NOT_FOUND")

    async def models(request: web.Request) -> web.Response:
        out = []
        for m in registry.get_all_available_models():
            name = m.get("name")
            out.append({
                "name": name,
                "workersAvailable": len(registry.get_available_workers_by_model(name)),
                "workersTotal": len(registry.get_workers_with_model(name)),
            })
        return web.json_response({"models": sorted(out, key=lambda x: x["name"])})

    async def queue(request: web.Request) -> web.Response:
        stats = scheduler.get_stats()
        counts = registry.get_worker_count()
        return web.json_response({
            "queue": {
                "length": stats["queuedJobs"],
                "activeJobs": stats["activeJobs"],
                "totalProcessed": stats["totalJobsProcessed"],
                "totalFailed": stats["totalJobsFailed"],
                "totalTimedOut": stats["totalJobsTimedOut"],
                "totalCancelled": stats["totalJobsCancelled"],
                "totalRetried": stats["totalJobsRetried"],
                "totalOrphaned": stats["totalJobsOrphaned"],
            },
            "workers": counts,
        })

    return [
        web.post("/inference", submit),
        web.get("/inference/models", models),
        web.get("/inference/queue", queue),
        web.get("/inference/{job_id}/status", status),
        web.delete("/inference/{job_id}", cancel),
    ]
