"""Tiny async event emitter.

Reference analogue: Node's EventEmitter as used by JobScheduler/WorkerRegistry
(events wired to logs at server/src/index.ts:119-212). Handlers may be sync
or async; emission never raises."""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Callable

from gridllm_torch.utils.logging import get_logger

log = get_logger("utils.events")


class EventEmitter:
    def __init__(self) -> None:
        self._handlers: dict[str, list[Callable[..., Any]]] = {}

    def on(self, event: str, handler: Callable[..., Any]) -> None:
        self._handlers.setdefault(event, []).append(handler)

    def off(self, event: str, handler: Callable[..., Any]) -> None:
        lst = self._handlers.get(event, [])
        if handler in lst:
            lst.remove(handler)

    def emit(self, event: str, *args: Any) -> None:
        for h in list(self._handlers.get(event, [])):
            try:
                result = h(*args)
                if inspect.isawaitable(result):
                    task = asyncio.ensure_future(result)
                    task.add_done_callback(
                        lambda t, ev=event: (
                            t.cancelled() or t.exception() is None or
                            log.error("async event handler failed", event=ev,
                                      error=str(t.exception()))
                        )
                    )
            except Exception as e:
                log.error("event handler failed", event=event, error=str(e))
