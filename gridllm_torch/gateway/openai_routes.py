"""OpenAI-compatible API at ``/v1`` (the JAX package's gateway/openai_routes.py).

Reference analogue: server/src/routes/openai.ts (877 LoC):
- POST /v1/completions (:363-578): SSE streaming with `[DONE]` sentinel
  (:526), echo and stream_options handling (:470-523)
- POST /v1/chat/completions (:581-819): multimodal content→text+images
  (:205-243), OpenAI→Ollama option mapping (:606-642) incl.
  response_format→format (:637-642), requestType "chat" + structured
  messages in metadata (:644-669)
- GET /v1/models (:822-874)

OpenAI-style error envelope: {"error": {"message", "type", "code"}}.
"""

from __future__ import annotations

import time
import uuid
from typing import Any

from aiohttp import web

from gridllm_torch.gateway.convert import (
    start_sse,
    to_openai_chat,
    to_openai_completion,
    write_sse,
)
from gridllm_torch.gateway.common import (
    guarded_stream,
    new_request,
    prefix_key,
    response_dict,
    submit,
    tenant_of,
)
from gridllm_torch.gateway.errors import OpenAIApiError
from gridllm_torch.scheduler import JobScheduler, WorkerRegistry
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import StreamChunk, iso_now

log = get_logger("gateway.openai")


def convert_messages(messages: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """OpenAI multimodal content arrays → Ollama text+images messages
    (reference: openai.ts:205-243)."""
    out = []
    for msg in messages:
        content = msg.get("content")
        if isinstance(content, list):
            text_parts: list[str] = []
            images: list[str] = []
            for part in content:
                if part.get("type") == "text":
                    text_parts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    # data URLs carry base64 payloads Ollama-style
                    if url.startswith("data:") and "," in url:
                        images.append(url.split(",", 1)[1])
                    else:
                        images.append(url)
            converted: dict[str, Any] = {
                "role": msg.get("role", "user"), "content": "\n".join(text_parts)}
            if images:
                converted["images"] = images
        else:
            converted = {"role": msg.get("role", "user"), "content": content or ""}
        for key in ("name", "tool_calls", "tool_call_id"):
            if key in msg:
                converted[key] = msg[key]
        out.append(converted)
    return out


def map_options(body: dict[str, Any]) -> dict[str, Any]:
    """OpenAI params → engine options (reference: openai.ts:606-642)."""
    opts: dict[str, Any] = {}
    if body.get("temperature", 1) != 1:
        opts["temperature"] = body["temperature"]
    if body.get("top_p", 1) != 1:
        opts["top_p"] = body["top_p"]
    max_tokens = body.get("max_completion_tokens") or body.get("max_tokens")
    if max_tokens is not None:
        opts["num_predict"] = max_tokens
    if body.get("seed") is not None:
        opts["seed"] = body["seed"]
    if body.get("stop") is not None:
        stop = body["stop"]
        opts["stop"] = stop if isinstance(stop, list) else [stop]
    if body.get("frequency_penalty"):
        opts["frequency_penalty"] = body["frequency_penalty"]
    if body.get("presence_penalty"):
        opts["presence_penalty"] = body["presence_penalty"]
    rf = body.get("response_format") or {}
    if rf.get("type") == "json_object":
        opts["format"] = "json"
    elif rf.get("type") == "json_schema":
        opts["format"] = (rf.get("json_schema") or {}).get("schema")
    return opts


def build_routes(registry: WorkerRegistry, scheduler: JobScheduler,
                 default_timeout_ms: int = 300_000,
                 admin=None) -> list[web.RouteDef]:
    from gridllm_torch.gateway.admin import get_admin

    DEFAULT_TIMEOUT_MS = default_timeout_ms
    madmin = get_admin(registry, admin, default_timeout_ms)

    async def _require_model(body: dict) -> str:
        model = body.get("model")
        if not model or not isinstance(model, str):
            raise OpenAIApiError("you must provide a model parameter", 400,
                                 "invalid_request_error")
        # same load-on-demand residency semantics as the Ollama surface
        # (gateway/admin.py): a cold model gets a cluster load before 404
        if not await madmin.ensure_servable(model):
            raise OpenAIApiError(
                f"The model '{model}' does not exist or is not available",
                404, "invalid_request_error", "model_not_found")
        return model

    async def _submit_touch(req, scheduler_, model, **kw):
        result = await submit(req, scheduler_, **kw)
        _touch(model)
        return result

    def _touch(model: str) -> None:
        # the OpenAI API has no keep_alive knob; Ollama applies its 5m
        # default per request — requests here must restart the idle clock
        # too or the cross-surface keep_alive sweeper would unload a model
        # that only /v1 clients are using
        madmin.touch_keep_alive(model, 300.0)

    # ---------------- /v1/chat/completions ----------------
    async def chat_completions(request: web.Request) -> web.StreamResponse:
        body = await request.json()
        model = await _require_model(body)
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise OpenAIApiError("'messages' is a required property", 400,
                                 "invalid_request_error")
        stream = bool(body.get("stream", False))
        ollama_messages = convert_messages(messages)

        req = new_request(
            id=str(uuid.uuid4()), model=model, stream=stream,
            messages=ollama_messages,
            tools=body.get("tools"),
            options=map_options(body),
            timeout=DEFAULT_TIMEOUT_MS,
            metadata={
                "openaiEndpoint": "/v1/chat/completions",
                "requestType": "chat",
                "tenant": tenant_of(request),
                "ollamaEndpoint": "/api/chat",
                "originalRequest": {
                    "n": body.get("n"), "logprobs": body.get("logprobs"),
                    "tools": body.get("tools"),
                    "tool_choice": body.get("tool_choice"),
                    "user": body.get("user"),
                },
                "prefixKey": prefix_key(model, ollama_messages[:2]),
                "submittedAt": iso_now(),
            },
        )
        log.job("openai chat completions submitted", req.id,
                model=model, stream=stream)

        if not stream:
            result = await _submit_touch(req, scheduler, model,
                                         timeout_code="server_error",
                      failure_code="server_error", error_cls=OpenAIApiError)
            return web.json_response(
                to_openai_chat(response_dict(result), model, req.id))

        resp = await start_sse(request)
        created = int(time.time())
        sent_any = False

        async def on_chunk(chunk: StreamChunk) -> None:
            nonlocal sent_any
            delta_content = (chunk.message or {}).get("content") or chunk.response or ""
            openai_chunk: dict[str, Any] = {
                "id": f"chatcmpl-{req.id}",
                "object": "chat.completion.chunk",
                "created": created,
                "model": model,
                "system_fingerprint": "fp_gridllm_tpu",
                "choices": [{
                    "index": 0,
                    "delta": (
                        {"role": "assistant", "content": delta_content}
                        if not sent_any else {"content": delta_content}),
                    "logprobs": None,
                    "finish_reason": None,
                }],
            }
            sent_any = True
            await write_sse(resp, openai_chunk)

        async def run() -> None:
            result = await scheduler.submit_streaming_job(req, on_chunk)
            _touch(model)
            if not result.success:
                await on_error(result.error or "Inference failed")
                return
            d = response_dict(result)
            final_chunk: dict[str, Any] = {
                "id": f"chatcmpl-{req.id}",
                "object": "chat.completion.chunk",
                "created": created,
                "model": model,
                "system_fingerprint": "fp_gridllm_tpu",
                "choices": [{"index": 0, "delta": {}, "logprobs": None,
                             "finish_reason": _chunk_finish_reason(d)}],
            }
            if (body.get("stream_options") or {}).get("include_usage"):
                p = d.get("prompt_eval_count") or 0
                c = d.get("eval_count") or 0
                final_chunk["usage"] = {
                    "prompt_tokens": p, "completion_tokens": c, "total_tokens": p + c}
            await write_sse(resp, final_chunk)
            await write_sse(resp, "[DONE]")

        async def on_error(message: str) -> None:
            await write_sse(resp, {"error": {"message": message,
                                             "type": "server_error"}})
            await write_sse(resp, "[DONE]")

        return await guarded_stream(resp, run, on_error)

    # ---------------- /v1/completions ----------------
    async def completions(request: web.Request) -> web.StreamResponse:
        body = await request.json()
        model = await _require_model(body)
        prompt = body.get("prompt")
        if isinstance(prompt, list):
            prompt = "".join(str(p) for p in prompt)
        if not isinstance(prompt, str) or not prompt:
            raise OpenAIApiError("'prompt' is a required property", 400,
                                 "invalid_request_error")
        stream = bool(body.get("stream", False))
        echo = bool(body.get("echo", False))

        req = new_request(
            id=str(uuid.uuid4()), model=model, prompt=prompt, stream=stream,
            options=map_options(body),
            timeout=DEFAULT_TIMEOUT_MS,
            metadata={
                "openaiEndpoint": "/v1/completions",
                "requestType": "inference",
                "tenant": tenant_of(request),
                "ollamaEndpoint": "/api/generate",
                "prefixKey": prefix_key(model, prompt[:512]),
                "submittedAt": iso_now(),
            },
        )
        log.job("openai completions submitted", req.id, model=model, stream=stream)

        if not stream:
            result = await _submit_touch(req, scheduler, model,
                                         timeout_code="server_error",
                      failure_code="server_error", error_cls=OpenAIApiError)
            return web.json_response(to_openai_completion(
                response_dict(result), model, req.id, prompt, echo))

        resp = await start_sse(request)
        created = int(time.time())
        first = True

        async def on_chunk(chunk: StreamChunk) -> None:
            nonlocal first
            text = chunk.response or ""
            if first and echo:
                text = prompt + text
            first = False
            await write_sse(resp, {
                "id": f"cmpl-{req.id}", "object": "text_completion",
                "created": created, "model": model,
                "system_fingerprint": "fp_gridllm_tpu",
                "choices": [{"text": text, "index": 0, "logprobs": None,
                             "finish_reason": None}],
            })

        async def run() -> None:
            result = await scheduler.submit_streaming_job(req, on_chunk)
            _touch(model)
            if not result.success:
                await on_error(result.error or "Inference failed")
                return
            d = response_dict(result)
            final: dict[str, Any] = {
                "id": f"cmpl-{req.id}", "object": "text_completion",
                "created": created, "model": model,
                "system_fingerprint": "fp_gridllm_tpu",
                "choices": [{"text": "", "index": 0, "logprobs": None,
                             "finish_reason": _chunk_finish_reason(d)}],
            }
            if (body.get("stream_options") or {}).get("include_usage"):
                p = d.get("prompt_eval_count") or 0
                c = d.get("eval_count") or 0
                final["usage"] = {
                    "prompt_tokens": p, "completion_tokens": c, "total_tokens": p + c}
            await write_sse(resp, final)
            await write_sse(resp, "[DONE]")

        async def on_error(message: str) -> None:
            await write_sse(resp, {"error": {"message": message,
                                             "type": "server_error"}})
            await write_sse(resp, "[DONE]")

        return await guarded_stream(resp, run, on_error)

    # ---------------- /v1/models ----------------
    async def models(request: web.Request) -> web.Response:
        models_map: dict[str, dict] = {}
        for worker in registry.get_all_workers():
            for m in worker.capabilities.availableModels:
                if m.name not in models_map:
                    # exactly Ollama's facade field set {id, object,
                    # created, owned_by} — extra legacy-OpenAI keys
                    # (permission/root/parent) break shape parity
                    models_map[m.name] = {
                        "id": m.name,
                        "object": "model",
                        "created": int(time.time()),
                        "owned_by": "gridllm",
                    }
        data = sorted(models_map.values(), key=lambda m: m["id"])
        return web.json_response({"object": "list", "data": data})

    return [
        web.post("/v1/chat/completions", chat_completions),
        web.post("/v1/completions", completions),
        web.get("/v1/models", models),
    ]


def _chunk_finish_reason(d: dict[str, Any]) -> str:
    if d.get("done_reason") == "length":
        return "length"
    if (d.get("message") or {}).get("tool_calls"):
        return "tool_calls"
    return "stop"
