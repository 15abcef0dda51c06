"""Structured logging.

Reference analogue: winston logger with domain helpers ``logger.worker`` /
``logger.job`` / ``logger.performance`` (server/src/utils/logger.ts:104-126).
Here: stdlib logging with a structured ``extra``-style kwargs API and the same
domain tags, JSON-ish single-line output, circular-safe serialization
(reference: server/src/utils/logger.ts:12-36).
"""

from __future__ import annotations

import contextvars
import json
import logging
import sys
import time
from contextlib import contextmanager
from typing import Any, Iterator

from gridllm_torch.utils.config import env_str

_LEVEL = env_str("GRIDLLM_LOG_LEVEL").upper()
_CONFIGURED = False

# Active request id (set while a trace span is open for the request, see
# obs/tracer.py): every structured log record emitted inside the context
# gains a request_id field, so log lines grep-join with span timelines.
_REQUEST_ID: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "gridllm_request_id", default=None
)


@contextmanager
def bind_request_id(request_id: str | None) -> Iterator[None]:
    """Attach ``request_id`` to all structured logs emitted in this context
    (async-task-local via contextvars; engine threads are outside it and
    keep passing ids explicitly)."""
    token = _REQUEST_ID.set(request_id)
    try:
        yield
    finally:
        _REQUEST_ID.reset(token)


def current_request_id() -> str | None:
    return _REQUEST_ID.get()


def _safe(obj: Any, _depth: int = 0) -> Any:
    """Best-effort JSON-serializable projection (circular/huge-safe)."""
    if _depth > 4:
        return "<depth>"
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _safe(v, _depth + 1) for k, v in list(obj.items())[:50]}
    if isinstance(obj, (list, tuple)):
        return [_safe(v, _depth + 1) for v in list(obj)[:50]]
    if isinstance(obj, BaseException):
        return f"{type(obj).__name__}: {obj}"
    return repr(obj)[:200]


class StructuredLogger:
    """Thin wrapper: ``log.info("msg", job_id=..., worker_id=...)``."""

    def __init__(self, name: str):
        self._log = logging.getLogger(name)

    def _emit(self, level: int, msg: str, kw: dict[str, Any]) -> None:
        rid = _REQUEST_ID.get()
        if rid is not None and "request_id" not in kw:
            kw = {"request_id": rid, **kw}
        if kw:
            try:
                msg = f"{msg} {json.dumps(_safe(kw), default=str)}"
            except Exception:
                msg = f"{msg} <unserializable>"
        self._log.log(level, msg)

    def debug(self, msg: str, **kw: Any) -> None:
        self._emit(logging.DEBUG, msg, kw)

    def info(self, msg: str, **kw: Any) -> None:
        self._emit(logging.INFO, msg, kw)

    def warning(self, msg: str, **kw: Any) -> None:
        self._emit(logging.WARNING, msg, kw)

    def error(self, msg: str, **kw: Any) -> None:
        self._emit(logging.ERROR, msg, kw)

    # Domain helpers (reference: server/src/utils/logger.ts:114-126)
    def worker(self, msg: str, worker_id: str, **kw: Any) -> None:
        self._emit(logging.INFO, msg, {"type": "worker", "worker_id": worker_id, **kw})

    def job(self, msg: str, job_id: str, **kw: Any) -> None:
        self._emit(logging.INFO, msg, {"type": "job", "job_id": job_id, **kw})

    def performance(self, msg: str, **kw: Any) -> None:
        self._emit(logging.INFO, msg, {"type": "performance", **kw})


def get_logger(name: str) -> StructuredLogger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s.%(msecs)03dZ %(levelname)s [%(name)s] %(message)s",
                datefmt="%Y-%m-%dT%H:%M:%S",
            )
        )
        handler.formatter.converter = time.gmtime  # type: ignore[union-attr]
        root = logging.getLogger("gridllm_torch")
        root.addHandler(handler)
        root.setLevel(getattr(logging, _LEVEL, logging.INFO))
        root.propagate = False
        _CONFIGURED = True
    if not name.startswith("gridllm_torch"):
        name = f"gridllm_torch.{name}"
    return StructuredLogger(name)
