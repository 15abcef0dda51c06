"""Shared route plumbing: request construction, submit helpers and
streaming error guards (the JAX package's gateway/common.py)."""

from __future__ import annotations

import hashlib
import json as _json
from typing import Any, Awaitable, Callable

from aiohttp import web

from gridllm_torch.gateway.errors import ApiError
from gridllm_torch.obs import resolve_tenant
from gridllm_torch.scheduler import JobScheduler
from gridllm_torch.scheduler.scheduler import JobTimeoutError
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import InferenceRequest, JobResult

log = get_logger("gateway.common")


def tenant_of(request: web.Request) -> str:
    """Tenant id for usage attribution: the configured
    GRIDLLM_TENANT_HEADER value, else a truncated hash of the
    Authorization bearer, else 'anonymous'. Stamped into every
    request's metadata at the gateway — the one ingress point — so
    traces, flight-recorder events, and the shard usage ledger all
    agree on who a request belongs to."""
    return resolve_tenant(request.headers)


def _truncate_part(v: Any, limit: int = 1024) -> Any:
    """Bound a structured prefix-key part BEFORE serialization — a 500 KB
    system message must not be json.dumps'd in full on the request hot
    path just to keep its first kilobyte."""
    if isinstance(v, str):
        return v[:limit]
    if isinstance(v, dict):
        return {k: _truncate_part(x, limit) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_truncate_part(x, limit) for x in v[:8]]
    return v


def prefix_key(model: str, *parts: Any) -> str:
    """Stable content key for a request's reusable prompt prefix.

    Hash of the model plus the rendered system prompt / leading message
    content (first ~1 KiB per string) — enough to identify the shared
    prefix of templated and multi-turn workloads WITHOUT the scheduler
    ever seeing token ids. Stamped as metadata.prefixKey by the inference
    routes; workers heartbeat the keys they recently served and worker
    selection scores the overlap (prefix-affinity routing)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(model.encode("utf-8", "replace"))
    for p in parts:
        h.update(b"\x1f")
        if p is None:
            continue
        if not isinstance(p, str):
            p = _json.dumps(_truncate_part(p), sort_keys=True, default=str)
        h.update(p[:1024].encode("utf-8", "replace"))
    return h.hexdigest()


def new_request(**fields: Any) -> InferenceRequest:
    """An InferenceRequest validated field by field, as the JAX gateway's
    pydantic constructor validates it: a field of the wrong type raises
    `utils.types.ValidationError`, which error_middleware answers with 400."""
    return InferenceRequest.model_validate(fields)


async def submit(req: InferenceRequest, scheduler: JobScheduler,
                 timeout_code: str = "JOB_TIMEOUT",
                 failure_code: str = "INFERENCE_FAILED",
                 error_cls: type[ApiError] = ApiError) -> JobResult:
    """submit_and_wait with HTTP error translation (timeout→504, failure→500)."""
    try:
        result = await scheduler.submit_and_wait(req)
    except JobTimeoutError as e:
        raise error_cls(str(e), 504, timeout_code) from None
    if not result.success:
        if result.error and result.error.startswith("deadline_exceeded"):
            # queued past its class deadline and shed: the
            # structured 504 tells the client to back off, not retry hot
            raise error_cls("Request deadline exceeded while queued", 504,
                            "DEADLINE_EXCEEDED")
        raise error_cls(result.error or "Inference failed", 500, failure_code)
    return result


def response_dict(result: JobResult) -> dict[str, Any]:
    return result.response.model_dump(exclude_none=True) if result.response else {}


async def guarded_stream(resp: web.StreamResponse,
                         run: Callable[[], Awaitable[None]],
                         on_error: Callable[[str], Awaitable[None]]) -> web.StreamResponse:
    """Run a streaming body after the response is prepared. Any failure is
    delivered as an in-stream error frame (a second JSON response can't be
    started once headers are out); client disconnects end the stream quietly."""
    try:
        await run()
    except JobTimeoutError as e:
        try:
            await on_error(str(e))
        except (ConnectionResetError, ConnectionError):
            pass
    except (ConnectionResetError, ConnectionError):
        log.info("client disconnected mid-stream")
    except Exception as e:
        log.error("streaming handler failed", error=str(e))
        try:
            await on_error("Internal error during streaming")
        except (ConnectionResetError, ConnectionError):
            pass
    try:
        await resp.write_eof()
    except (ConnectionResetError, ConnectionError):
        pass
    return resp
