"""Ollama-compatible API at ``/ollama`` (and also mounted bare at ``/api``);
the JAX package's gateway/ollama_routes.py.

Reference analogue: server/src/routes/ollama.ts (714 LoC). Endpoints:
- POST /api/generate  (:161-319) — incl. empty-prompt load/unload semantics
  (:177-214), stream default TRUE (:51), NDJSON streaming
- POST /api/chat      (:322-504) — FIXED vs reference (SURVEY.md §2.8):
  structured messages are carried end-to-end with requestType "chat" instead
  of being flattened into a prompt
- GET  /api/tags      (:507-571) — cross-worker aggregation with
  gridllm_metadata.num_workers_with_model
- POST /api/embed     (:574-643), POST /api/embeddings legacy (:646-711)
Plus endpoints the reference README claims but never implemented
(README.md:149, 207-211; SURVEY.md §2.2): /api/version, /api/ps, /api/show,
and real model management — /api/pull (cluster-wide load-on-demand from
each worker's checkpoint root, with streamed progress), /api/delete,
/api/copy. /api/push stays 501 (no remote registry to push to).

Validation mirrors the Joi schemas (ollama.ts:17-117): prompt ≤ 100 kB,
model required.
"""

from __future__ import annotations

import asyncio
import re
import time
import uuid
from typing import Any

from aiohttp import web

from gridllm_torch.gateway.convert import (
    start_ndjson,
    to_ollama_chat,
    to_ollama_generate,
    write_ndjson,
)
from gridllm_torch.gateway.common import (
    guarded_stream,
    new_request,
    prefix_key,
    response_dict,
    submit,
    tenant_of,
)
from gridllm_torch.gateway.errors import ApiError
from gridllm_torch.scheduler import JobScheduler, WorkerRegistry
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import StreamChunk, iso_now

log = get_logger("gateway.ollama")

MAX_PROMPT = 100 * 1024  # Joi max (ollama.ts:19)


def _require_model_name(body: dict) -> str:
    model = body.get("model")
    if not model or not isinstance(model, str):
        raise ApiError("Validation error: \"model\" is required", 400)
    return model


def _require_model(body: dict, registry: WorkerRegistry) -> str:
    model = _require_model_name(body)
    if not registry.get_workers_with_model(model):
        raise ApiError(
            f"Model '{model}' is not available on any worker", 404, "MODEL_NOT_FOUND")
    return model


def _validate_prompt(body: dict) -> str | None:
    prompt = body.get("prompt")
    if prompt is not None:
        if not isinstance(prompt, str):
            raise ApiError("Validation error: \"prompt\" must be a string", 400)
        if len(prompt) > MAX_PROMPT:
            raise ApiError(
                f"Validation error: \"prompt\" length must be less than or equal to "
                f"{MAX_PROMPT} characters long", 400)
    return prompt


_GO_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_GO_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
             "s": 1.0, "m": 60.0, "h": 3600.0}


def _parse_keep_alive(v: Any) -> float | None:
    """Ollama keep_alive → seconds. Numbers are seconds; strings take Go
    durations incl. compound forms ("1h30m", "500ms"); negative → keep
    forever (None); default 5m when unset or unparseable."""
    if v is None:
        return 300.0
    if isinstance(v, (int, float)):
        return None if v < 0 else float(v)
    s = str(v).strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    parts = _GO_DURATION_RE.findall(s)
    if parts and _GO_DURATION_RE.sub("", s) == "":
        sec = sum(float(n) * _GO_UNITS[u] for n, u in parts)
        return None if neg else sec
    try:
        sec = float(s)
        return None if neg or sec < 0 else sec
    except ValueError:
        return 300.0


def build_routes(registry: WorkerRegistry, scheduler: JobScheduler,
                 version: str, default_timeout_ms: int = 300_000,
                 admin=None) -> list[web.RouteDef]:
    from gridllm_torch.gateway.admin import get_admin

    routes: list[web.RouteDef] = []
    DEFAULT_TIMEOUT_MS = default_timeout_ms
    madmin = get_admin(registry, admin, default_timeout_ms)
    # keep_alive bookkeeping: /api/ps reports expires_at from the last
    # request's keep_alive; keep_alive=0 + empty prompt REALLY unloads
    # (worker admin broadcast) and the next request for the model
    # auto-loads it back (_require_servable) — full Ollama residency
    # semantics. Workers without management (multi-host slices) decline
    # unloads and stay resident.
    model_expiry = madmin.model_expiry

    def _touch_keep_alive(model: str, keep_alive: Any) -> None:
        madmin.touch_keep_alive(model, _parse_keep_alive(keep_alive))

    async def _require_servable(body: dict) -> str:
        """Ollama load-on-demand (gateway/admin.py): load the model on
        request when no worker serves it; 404 only when none can."""
        model = _require_model_name(body)
        if await madmin.ensure_servable(model):
            return model
        raise ApiError(
            f"Model '{model}' is not available on any worker", 404,
            "MODEL_NOT_FOUND")

    # ---------------- /api/generate ----------------
    async def generate(request: web.Request) -> web.StreamResponse:
        body = await request.json()
        prompt = _validate_prompt(body)
        stream = body.get("stream", True)  # Ollama default (ollama.ts:51)

        # empty prompt → load/unload semantics (ollama.ts:177-214)
        if not prompt or not prompt.strip():
            ka = body.get("keep_alive")
            # NOT isinstance bool: JSON false == 0 in Python, and a client
            # sending keep_alive:false must not nuke the weights
            if ka == 0 and not isinstance(ka, bool):
                # REAL unload (Ollama drops the weights on keep_alive=0);
                # must NOT go through load-on-demand first — unloading an
                # unloaded model is a no-op, not a load. Workers without
                # management (multi-host groups) decline and stay loaded.
                model = _require_model_name(body)
                await _admin_broadcast("unload_model", {"model": model}, 30.0)
                payload: dict[str, Any] = {
                    "model": model, "created_at": iso_now(), "response": "",
                    "done": True, "done_reason": "unload"}
            else:
                # load/warmup semantics: an empty prompt loads the model
                # and its keep_alive sets the residency window
                model = await _require_servable(body)
                _touch_keep_alive(model, body.get("keep_alive"))
                payload = {
                    "model": model, "created_at": iso_now(), "response": "",
                    "done": True}
            if stream:
                resp = await start_ndjson(request)
                await write_ndjson(resp, payload)
                await resp.write_eof()
                return resp
            return web.json_response(payload)

        model = await _require_servable(body)
        req = new_request(
            id=str(uuid.uuid4()), model=model, prompt=prompt, stream=stream,
            options=body.get("options") or {},
            images=body.get("images"),
            timeout=DEFAULT_TIMEOUT_MS,
            metadata={
                "ollamaEndpoint": "/api/generate",
                "requestType": "inference",
                "tenant": tenant_of(request),
                "suffix": body.get("suffix"),
                "think": body.get("think"),
                "format": body.get("format"),
                "system": body.get("system"),
                "template": body.get("template"),
                "raw": body.get("raw"),
                "keep_alive": body.get("keep_alive"),
                "context": body.get("context"),
                # stable prefix identity (system prompt + leading prompt
                # text) for the scheduler's prefix-affinity routing
                "prefixKey": prefix_key(model, body.get("system"),
                                        (prompt or "")[:512]),
                "submittedAt": iso_now(),
            },
        )
        _touch_keep_alive(model, body.get("keep_alive"))
        log.job("ollama generate submitted", req.id, model=model, stream=stream)

        if not stream:
            result = await submit(req, scheduler)
            # keep_alive measures IDLE time: restart the window when the
            # request COMPLETES (the submit-time touch alone would let the
            # sweeper expire a model mid-generation)
            _touch_keep_alive(model, body.get("keep_alive"))
            return web.json_response(
                to_ollama_generate(response_dict(result), model))

        resp = await start_ndjson(request)

        async def on_chunk(chunk: StreamChunk) -> None:
            await write_ndjson(resp, to_ollama_generate(
                chunk.model_dump(exclude_none=True), model))

        async def run() -> None:
            result = await scheduler.submit_streaming_job(req, on_chunk)
            _touch_keep_alive(model, body.get("keep_alive"))  # idle clock
            if result.success:
                await write_ndjson(resp, to_ollama_generate(response_dict(result), model))
            else:
                await on_error(result.error or "Inference failed")

        async def on_error(message: str) -> None:
            await write_ndjson(resp, {
                "model": model, "created_at": iso_now(), "response": "",
                "done": True, "error": message})

        return await guarded_stream(resp, run, on_error)

    # ---------------- /api/chat ----------------
    async def chat(request: web.Request) -> web.StreamResponse:
        body = await request.json()
        model = await _require_servable(body)
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ApiError("Validation error: \"messages\" is required", 400)
        stream = body.get("stream", True)

        req = new_request(
            id=str(uuid.uuid4()), model=model, stream=stream,
            messages=messages,
            tools=body.get("tools"),
            format=body.get("format"),
            options=body.get("options") or {},
            timeout=DEFAULT_TIMEOUT_MS,
            metadata={
                "ollamaEndpoint": "/api/chat",
                "requestType": "chat",   # fix: reference never set this (§2.8)
                "tenant": tenant_of(request),
                "think": body.get("think"),
                "keep_alive": body.get("keep_alive"),
                # system prompt + leading messages identify the reusable
                # conversation prefix (prefix-affinity routing)
                "prefixKey": prefix_key(model, messages[:2]),
                "submittedAt": iso_now(),
            },
        )
        _touch_keep_alive(model, body.get("keep_alive"))
        log.job("ollama chat submitted", req.id, model=model,
                stream=stream, messages=len(messages))

        if not stream:
            result = await submit(req, scheduler)
            _touch_keep_alive(model, body.get("keep_alive"))  # idle clock
            return web.json_response(to_ollama_chat(response_dict(result), model))

        resp = await start_ndjson(request)

        async def on_chunk(chunk: StreamChunk) -> None:
            d = chunk.model_dump(exclude_none=True)
            if "message" not in d:
                d["message"] = {"role": "assistant", "content": d.get("response", "")}
            await write_ndjson(resp, to_ollama_chat(d, model))

        async def run() -> None:
            result = await scheduler.submit_streaming_job(req, on_chunk)
            _touch_keep_alive(model, body.get("keep_alive"))  # idle clock
            if result.success:
                await write_ndjson(resp, to_ollama_chat(response_dict(result), model))
            else:
                await on_error(result.error or "Inference failed")

        async def on_error(message: str) -> None:
            await write_ndjson(resp, {
                "model": model, "created_at": iso_now(),
                "message": {"role": "assistant", "content": ""},
                "done": True, "error": message})

        return await guarded_stream(resp, run, on_error)

    # ---------------- /api/tags ----------------
    async def tags(request: web.Request) -> web.Response:
        models_map: dict[str, dict] = {}
        count: dict[str, int] = {}
        for worker in registry.get_all_workers():
            for m in worker.capabilities.availableModels:
                count[m.name] = count.get(m.name, 0) + 1
                if m.name not in models_map:
                    models_map[m.name] = {
                        "name": m.name,
                        "model": m.model or m.name,
                        "modified_at": m.modified_at or iso_now(),
                        "size": m.size or 0,
                        "digest": m.digest or "",
                        "details": m.details or {
                            "parent_model": "", "format": "safetensors",
                            "family": "unknown", "families": ["unknown"],
                            "parameter_size": "Unknown",
                            "quantization_level": "Unknown",
                        },
                        "gridllm_metadata": {"num_workers_with_model": 0},
                    }
        for name, entry in models_map.items():
            entry["gridllm_metadata"]["num_workers_with_model"] = count[name]
        models = sorted(models_map.values(), key=lambda m: m["name"])
        return web.json_response({"models": models})

    # ---------------- /api/embed (+ legacy /api/embeddings) ----------------
    async def embed(request: web.Request) -> web.Response:
        body = await request.json()
        model = await _require_servable(body)
        input_val = body.get("input")
        if input_val is None or (isinstance(input_val, list) and not input_val):
            raise ApiError("Validation error: \"input\" is required", 400)
        req = new_request(
            id=str(uuid.uuid4()), model=model, input=input_val,
            truncate=body.get("truncate"),
            options=body.get("options") or {},
            timeout=DEFAULT_TIMEOUT_MS,
            metadata={"ollamaEndpoint": "/api/embed",
                      "requestType": "embedding",
                      "tenant": tenant_of(request), "submittedAt": iso_now()},
        )
        result = await submit(req, scheduler)
        d = response_dict(result)
        return web.json_response({
            "model": model,
            "embeddings": d.get("embeddings") or [],
            "total_duration": d.get("total_duration") or 0,
            "load_duration": d.get("load_duration") or 0,
            "prompt_eval_count": d.get("prompt_eval_count") or 0,
        })

    async def embeddings_legacy(request: web.Request) -> web.Response:
        """Single-embedding legacy shape (ollama.ts:646-711)."""
        body = await request.json()
        model = await _require_servable(body)
        prompt = body.get("prompt")
        if prompt is None:
            raise ApiError("Validation error: \"prompt\" is required", 400)
        req = new_request(
            id=str(uuid.uuid4()), model=model, input=prompt,
            options=body.get("options") or {},
            timeout=DEFAULT_TIMEOUT_MS,
            metadata={"ollamaEndpoint": "/api/embeddings",
                      "requestType": "embedding",
                      "tenant": tenant_of(request), "submittedAt": iso_now()},
        )
        result = await submit(req, scheduler)
        d = response_dict(result)
        embeddings = d.get("embeddings") or []
        return web.json_response({
            "embedding": embeddings[0] if embeddings else (d.get("embedding") or [])})

    # ---------------- parity endpoints beyond the reference ----------------
    version_str = version

    async def api_version(request: web.Request) -> web.Response:
        return web.json_response({"version": version_str})

    async def ps(request: web.Request) -> web.Response:
        """Running models across workers (real Ollama /api/ps shape)."""
        seen: dict[str, dict] = {}
        for worker in registry.get_online_workers():
            for m in worker.capabilities.availableModels:
                mkey = madmin.canonical(m.name)
                if mkey in model_expiry:
                    exp = model_expiry[mkey]
                    expires = (
                        "never" if exp is None else
                        time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(exp))
                    )
                else:
                    expires = ""
                entry = seen.setdefault(m.name, {
                    "name": m.name, "model": m.model or m.name,
                    "size": m.size or 0, "digest": m.digest or "",
                    "details": m.details or {},
                    "expires_at": expires,
                    "size_vram": 0,
                    "gridllm_metadata": {"workers": []},
                })
                entry["gridllm_metadata"]["workers"].append(worker.workerId)
        return web.json_response({"models": sorted(seen.values(), key=lambda m: m["name"])})

    async def show(request: web.Request) -> web.Response:
        body = await request.json()
        model = _require_model(body, registry)
        for worker in registry.get_all_workers():
            for m in worker.capabilities.availableModels:
                if m.name == model:
                    details = m.details or {}
                    if details.get("family") == "bert_embed":
                        caps = ["embedding"]  # Ollama's shape for embed-only
                    else:
                        caps = ["completion"]
                    if details.get("vision") or "clip" in (
                        details.get("families") or []
                    ):
                        caps.append("vision")
                    return web.json_response({
                        "modelfile": "", "parameters": "", "template": "",
                        "details": details,
                        "model_info": {"general.name": model,
                                       "general.size": m.size or 0},
                        "capabilities": caps,
                    })
        raise ApiError(f"Model '{model}' not found", 404, "MODEL_NOT_FOUND")

    # ------------- model management (/api/pull, /api/delete, /api/copy) --
    #
    # Cluster semantics: the op broadcasts to every online worker over the
    # bus admin channel (worker/service.py _on_admin); "pull" means
    # load-on-demand from each worker's local checkpoint root (there is no
    # remote registry in this deployment — the reference's pullModel/
    # deleteModel were dead client-side stubs, OllamaService.ts:286-331).

    async def _admin_broadcast(
        op: str, payload: dict, timeout_s: float,
        on_result=None,
    ) -> list[dict]:
        return await madmin.broadcast(op, payload, timeout_s, on_result)

    def _mgmt_model(body: dict) -> str:
        model = body.get("model") or body.get("name")
        if not model or not isinstance(model, str):
            raise ApiError("Validation error: \"model\" is required", 400)
        return model

    async def pull(request: web.Request) -> web.StreamResponse:
        body = await request.json()
        model = _mgmt_model(body)
        stream = body.get("stream", True)
        if not registry.get_online_workers():
            raise ApiError("no workers online", 503, "NO_WORKERS")
        timeout_s = DEFAULT_TIMEOUT_MS / 1000.0
        if stream:
            resp = await start_ndjson(request)
            await write_ndjson(resp, {"status": "pulling manifest"})

            async def progress(rec: dict) -> None:
                await write_ndjson(resp, {
                    "status": f"{rec.get('detail') or 'done'} "
                              f"on {rec.get('workerId')}"
                })

            results = await _admin_broadcast(
                "load_model", {"model": model}, timeout_s, progress)
            ok = any(r.get("ok") for r in results)
            if ok:
                await write_ndjson(resp, {"status": "verifying sha256 digest"})
                await write_ndjson(resp, {"status": "success"})
            else:
                detail = "; ".join(
                    str(r.get("detail")) for r in results) or "no worker replied"
                await write_ndjson(resp, {"error": f"pull failed: {detail}"})
            await resp.write_eof()
            return resp
        results = await _admin_broadcast("load_model", {"model": model}, timeout_s)
        if any(r.get("ok") for r in results):
            return web.json_response({"status": "success"})
        detail = "; ".join(str(r.get("detail")) for r in results) or "no worker replied"
        raise ApiError(f"pull failed: {detail}", 500, "PULL_FAILED")

    async def delete_model(request: web.Request) -> web.Response:
        body = await request.json()
        model = _mgmt_model(body)
        results = await _admin_broadcast("unload_model", {"model": model}, 30.0)
        if any(r.get("ok") for r in results):
            model_expiry.pop(madmin.canonical(model), None)
            return web.json_response({})  # Ollama: 200 empty on success
        raise ApiError(f"Model '{model}' not found", 404, "MODEL_NOT_FOUND")

    async def copy_model(request: web.Request) -> web.Response:
        body = await request.json()
        src, dst = body.get("source"), body.get("destination")
        if not src or not dst:
            raise ApiError(
                "Validation error: \"source\" and \"destination\" are required",
                400)
        results = await _admin_broadcast(
            "copy_model", {"source": src, "destination": dst}, 30.0)
        if any(r.get("ok") for r in results):
            return web.json_response({})
        raise ApiError(f"Model '{src}' not found", 404, "MODEL_NOT_FOUND")

    async def not_supported(request: web.Request) -> web.Response:
        raise ApiError(
            "There is no remote model registry in GridLLM-TPU; "
            f"{request.path} is not supported by the gateway", 501,
            "NOT_SUPPORTED")

    routes.append(web.post("/api/generate", generate))
    routes.append(web.post("/api/chat", chat))
    routes.append(web.get("/api/tags", tags))
    routes.append(web.post("/api/embed", embed))
    routes.append(web.post("/api/embeddings", embeddings_legacy))
    routes.append(web.get("/api/version", api_version))
    routes.append(web.get("/api/ps", ps))
    routes.append(web.post("/api/show", show))
    routes.append(web.post("/api/pull", pull))
    routes.append(web.post("/api/copy", copy_model))
    routes.append(web.delete("/api/delete", delete_model))
    routes.append(web.post("/api/push", not_supported))
    return routes

