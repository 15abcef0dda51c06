"""HTTP error machinery (the JAX package's gateway/errors.py).

Reference analogue: server/src/middleware/errorHandler.ts — createError with
(message, status, code, details), JSON error envelope
``{"error": {"message", "code", "details"}, "timestamp", "path", "method"}``
(details only in development), and a 404 envelope with code NOT_FOUND.
A request field that fails its wire type (`utils.types.ValidationError`,
pydantic's wording and location) is the same 400 the JAX gateway gives for
a pydantic ValidationError.
"""

from __future__ import annotations

import json
from typing import Any

from aiohttp import web
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import ValidationError, iso_now

log = get_logger("gateway.errors")

APP_ENV: web.AppKey[str] = web.AppKey("env", str)


class ApiError(Exception):
    def __init__(self, message: str, status: int = 500,
                 code: str | None = None, details: Any = None):
        super().__init__(message)
        self.message = message
        self.status = status
        self.code = code
        self.details = details


class OpenAIApiError(ApiError):
    """Rendered in the OpenAI error envelope
    ``{"error": {"message", "type", "code"}}`` for /v1 routes."""

    def __init__(self, message: str, status: int = 500,
                 etype: str = "invalid_request_error", code: str | None = None):
        super().__init__(message, status, code)
        self.etype = etype


def error_body(request: web.Request, message: str, code: str | None = None,
               details: Any = None, dev: bool = False) -> dict:
    err: dict[str, Any] = {"message": message}
    if code is not None:
        err["code"] = code
    if dev and details is not None:
        err["details"] = details
    return {
        "error": err,
        "timestamp": iso_now(),
        "path": request.path,
        "method": request.method,
    }


@web.middleware
async def error_middleware(request: web.Request, handler):
    dev = request.app.get(APP_ENV, "development") == "development"
    try:
        return await handler(request)
    except OpenAIApiError as e:
        log.error("request error", path=request.path, status=e.status,
                  message=e.message, code=e.code)
        return web.json_response(
            {"error": {"message": e.message, "type": e.etype, "code": e.code}},
            status=e.status)
    except ApiError as e:
        log.error("request error", path=request.path, status=e.status,
                  message=e.message, code=e.code)
        return web.json_response(
            error_body(request, e.message, e.code, e.details, dev), status=e.status)
    except web.HTTPNotFound:
        return web.json_response(
            error_body(request, "Route not found", "NOT_FOUND"), status=404)
    except web.HTTPException:
        raise
    except json.JSONDecodeError:
        return web.json_response(
            error_body(request, "Invalid JSON body", "BAD_JSON"), status=400)
    except ValidationError as e:
        # malformed request fields surface as 400, not 500
        loc = ".".join(str(p) for p in e.loc)
        msg = f"Validation error: \"{loc}\" {e.msg}"
        return web.json_response(
            error_body(request, msg, "VALIDATION_ERROR"), status=400)
    except Exception as e:  # unexpected
        log.error("unhandled request error", path=request.path, error=str(e))
        return web.json_response(
            error_body(request, "Internal Server Error", details=str(e), dev=dev),
            status=500)
