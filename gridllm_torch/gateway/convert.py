"""Response conversion + streaming framing helpers (the JAX package's
gateway/convert.py; the wire values, `system_fingerprint` included, are its
own, so a client sees one gateway whichever package serves it).

Reference analogues:
- convertToOllamaResponse (server/src/routes/ollama.ts:137-158): zero-filled
  timing fields, `thinking` only when present
- convertOllamaChatToOpenAI / convertToOpenAICompletionsResponse
  (server/src/routes/openai.ts:246-355): usage from prompt_eval_count /
  eval_count, finish_reason mapping, optional system_fingerprint passthrough
- NDJSON framing (ollama.ts:131-134) and SSE framing (openai.ts:357-360)
"""

from __future__ import annotations

import json
import time
from typing import Any

from aiohttp import web

from gridllm_torch.utils.types import iso_now


# -- Ollama ----------------------------------------------------------------

def to_ollama_generate(response: dict[str, Any], model: str) -> dict[str, Any]:
    out = {
        "model": model,
        "created_at": response.get("created_at") or iso_now(),
        "response": response.get("response") or "",
        "done": response.get("done") or False,
        "context": response.get("context") or [],
        "total_duration": response.get("total_duration") or 0,
        "load_duration": response.get("load_duration") or 0,
        "prompt_eval_count": response.get("prompt_eval_count") or 0,
        "prompt_eval_duration": response.get("prompt_eval_duration") or 0,
        "eval_count": response.get("eval_count") or 0,
        "eval_duration": response.get("eval_duration") or 0,
    }
    if response.get("done_reason"):
        out["done_reason"] = response["done_reason"]
    if response.get("thinking"):
        out["thinking"] = response["thinking"]
    return out


def to_ollama_chat(response: dict[str, Any], model: str) -> dict[str, Any]:
    message = response.get("message") or {
        "role": "assistant", "content": response.get("response") or ""}
    out = {
        "model": model,
        "created_at": response.get("created_at") or iso_now(),
        "message": message,
        "done": response.get("done") or False,
        "total_duration": response.get("total_duration") or 0,
        "load_duration": response.get("load_duration") or 0,
        "prompt_eval_count": response.get("prompt_eval_count") or 0,
        "prompt_eval_duration": response.get("prompt_eval_duration") or 0,
        "eval_count": response.get("eval_count") or 0,
        "eval_duration": response.get("eval_duration") or 0,
    }
    if response.get("done_reason"):
        out["done_reason"] = response["done_reason"]
    return out


# -- OpenAI ----------------------------------------------------------------

def _finish_reason(response: dict[str, Any]) -> str:
    done_reason = response.get("done_reason")
    if done_reason == "stop":
        return "stop"
    if done_reason == "length":
        return "length"
    message = response.get("message") or {}
    if message.get("tool_calls"):
        return "tool_calls"
    if response.get("eval_count") == 0:
        return "length"
    return "stop"


def _usage(response: dict[str, Any]) -> dict[str, int]:
    p = response.get("prompt_eval_count") or 0
    c = response.get("eval_count") or 0
    return {"prompt_tokens": p, "completion_tokens": c, "total_tokens": p + c}


def to_openai_chat(response: dict[str, Any], model: str, request_id: str) -> dict[str, Any]:
    message = response.get("message") or {
        "role": "assistant", "content": response.get("response")}
    choice: dict[str, Any] = {
        "index": 0,
        "message": {"role": "assistant", "content": message.get("content")},
        "logprobs": None,
        "finish_reason": _finish_reason(response),
    }
    if message.get("tool_calls"):
        # Ollama shape (arguments: object) → OpenAI shape (id/type +
        # arguments as a JSON string), matching the reference's facade
        choice["message"]["tool_calls"] = [
            {
                "id": f"call_{request_id[:8]}_{i}",
                "type": "function",
                "function": {
                    "name": (tc.get("function") or {}).get("name", ""),
                    "arguments": json.dumps(
                        (tc.get("function") or {}).get("arguments", {})
                    ),
                },
            }
            for i, tc in enumerate(message["tool_calls"])
        ]
    out: dict[str, Any] = {
        "id": f"chatcmpl-{request_id}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
        "usage": _usage(response),
        # Ollama's facade always stamps system_fingerprint ("fp_ollama");
        # drop-in clients see the same key here (reference passes it
        # through end-to-end, openai.ts:298-301)
        "system_fingerprint": response.get("system_fingerprint")
        or "fp_gridllm_tpu",
    }
    return out


def to_openai_completion(response: dict[str, Any], model: str, request_id: str,
                         prompt: str = "", echo: bool = False) -> dict[str, Any]:
    text = response.get("response") or ""
    out: dict[str, Any] = {
        "id": f"cmpl-{request_id}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "text": (prompt + text) if echo else text,
            "index": 0,
            "logprobs": None,
            "finish_reason": _finish_reason(response),
        }],
        "usage": _usage(response),
        "system_fingerprint": response.get("system_fingerprint")
        or "fp_gridllm_tpu",
    }
    return out


# -- streaming framing -----------------------------------------------------

async def start_ndjson(request: web.Request) -> web.StreamResponse:
    """Ollama streams NDJSON with Content-Type application/json + chunked
    transfer (reference: ollama.ts:248-250)."""
    resp = web.StreamResponse(status=200, headers={
        "Content-Type": "application/x-ndjson"})
    resp.enable_chunked_encoding()
    await resp.prepare(request)
    return resp


async def write_ndjson(resp: web.StreamResponse, data: dict[str, Any]) -> None:
    await resp.write((json.dumps(data) + "\n").encode())


async def start_sse(request: web.Request) -> web.StreamResponse:
    """reference: openai.ts:686-690."""
    resp = web.StreamResponse(status=200, headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Connection": "keep-alive",
        "Access-Control-Allow-Origin": "*",
    })
    resp.enable_chunked_encoding()
    await resp.prepare(request)
    return resp


async def write_sse(resp: web.StreamResponse, data: dict[str, Any] | str) -> None:
    payload = data if isinstance(data, str) else json.dumps(data)
    await resp.write(f"data: {payload}\n\n".encode())
