"""Cluster model administration from the gateway (the JAX package's
gateway/admin.py): the admin broadcast protocol (worker/service.py
_on_admin) and Ollama residency semantics (load-on-demand), shared by every
API surface (ollama/openai routes).

One instance per app (gateway/app.py) so concurrent cold-model requests
coalesce across surfaces."""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Callable

from gridllm_torch.bus.base import CH_WORKER_ADMIN, admin_result_channel
from gridllm_torch.scheduler import WorkerRegistry
from gridllm_torch.utils.logging import get_logger

log = get_logger("gateway.admin")


class ModelAdmin:
    # retry spacing for models whose every sweep reply said "model
    # management disabled" (multi-host groups can't unload)
    SWEEP_BACKOFF_S = 300.0

    def __init__(self, registry: WorkerRegistry,
                 default_timeout_ms: int = 300_000) -> None:
        self.registry = registry
        self.default_timeout_s = default_timeout_ms / 1000.0
        # in-flight load-on-demand broadcasts, coalesced per model: N
        # concurrent requests for a cold model must not fire N cluster
        # broadcasts + N propagation polls. DETACHED tasks, not futures
        # tied to a requesting handler: a leader client disconnecting must
        # not cancel a load other requests (on either surface) wait on.
        self._load_tasks: dict[str, asyncio.Task] = {}
        # short negative cache: a model the cluster just failed to load is
        # not re-broadcast for every retry (typo storms would otherwise
        # queue behind real loads on the workers' serialized admin lock)
        self._fail_at: dict[str, float] = {}
        self.fail_ttl_s = 30.0
        # advertised residency: model → wall-clock expiry of its last
        # request's keep_alive window (None = keep forever). /api/ps
        # reports it; the opt-in sweeper (enforce_keep_alive) REALLY
        # unloads when it passes — Ollama's idle-unload behavior.
        self.model_expiry: dict[str, float | None] = {}
        self._sweeper: asyncio.Task | None = None
        # set by app.py: () -> set of model names with jobs in flight —
        # the sweeper must never unload under an active request (the
        # keep_alive clock measures IDLE time, and gateway handlers
        # re-touch expiry at completion; this probe is the belt to that
        # suspender for queued/retrying jobs the gateway can't see)
        self.active_models = None

    @staticmethod
    def canonical(model: str) -> str:
        """The ':latest' alias normalized away — expiry/busy bookkeeping
        must use ONE name per model, like the workers' _resolve_name."""
        return model[: -len(":latest")] if model.endswith(":latest") else model

    def touch_keep_alive(self, model: str, seconds: float | None) -> None:
        """Restart the idle window: None = keep forever."""
        self.model_expiry[self.canonical(model)] = (
            None if seconds is None else time.time() + seconds
        )

    def servable_now(self, model: str) -> bool:
        """Alias-aware registry check: workers resolve the ':latest' tag
        both ways (worker/service.py _resolve_name), so the gateway
        lookup must too or alias-named requests could never observe the
        load they just triggered."""
        reg = self.registry
        if reg.get_workers_with_model(model):
            return True
        if model.endswith(":latest") and reg.get_workers_with_model(
            model[: -len(":latest")]
        ):
            return True
        return (":" not in model
                and bool(reg.get_workers_with_model(f"{model}:latest")))

    async def broadcast(
        self, op: str, payload: dict, timeout_s: float,
        on_result: Callable | None = None,
    ) -> list[dict]:
        """One admin op to every worker; collects their results. Workers
        ack instantly then work (worker/service.py), so a missing ack
        within the grace window means nobody speaks the protocol."""
        bus = self.registry.bus
        rid = uuid.uuid4().hex
        expect = max(len(self.registry.get_online_workers()), 1)
        results: list[dict] = []
        acks = 0
        done = asyncio.Event()

        async def handler(_ch: str, raw: str) -> None:
            nonlocal acks
            rec = json.loads(raw)
            if rec.get("ack"):
                acks += 1
                return
            results.append(rec)
            # count/done BEFORE the progress callback: a raising on_result
            # (e.g. streamed-pull client disconnect mid-write) must not
            # leave the broadcast waiting out its whole timeout
            if len(results) >= expect:
                done.set()
            if on_result is not None:
                await on_result(rec)

        sub = await bus.subscribe(admin_result_channel(rid), handler)
        try:
            await asyncio.sleep(0.05)  # pub/sub delivery is async (broker)
            await bus.publish(CH_WORKER_ADMIN,
                              json.dumps({"op": op, "id": rid, **payload}))
            try:
                await asyncio.wait_for(done.wait(), min(5.0, timeout_s))
            except asyncio.TimeoutError:
                if acks or results:
                    try:
                        await asyncio.wait_for(done.wait(),
                                               max(timeout_s - 5.0, 0.0))
                    except asyncio.TimeoutError:
                        pass
        finally:
            # also on cancellation (client disconnect mid-load): the
            # admin:result subscription must never outlive the broadcast
            await sub.unsubscribe()
        return results

    async def _load(self, model: str) -> bool:
        results = await self.broadcast(
            "load_model", {"model": model}, self.default_timeout_s)
        if any(r.get("ok") for r in results):
            for _ in range(100):  # registration propagation
                if self.servable_now(model):
                    return True
                await asyncio.sleep(0.1)
        return self.servable_now(model)

    async def ensure_servable(self, model: str) -> bool:
        """Ollama load-on-demand: if no worker serves `model`, ask the
        cluster to load it (the other half of keep_alive=0 actually
        unloading — Ollama reloads transparently on the next request).
        Returns whether the model is servable afterwards."""
        if self.servable_now(model):
            return True
        if not self.registry.get_online_workers():
            return False
        last_fail = self._fail_at.get(model)
        if last_fail is not None:
            if time.monotonic() - last_fail < self.fail_ttl_s:
                return False
            self._fail_at.pop(model, None)
        task = self._load_tasks.get(model)
        if task is None:
            task = asyncio.create_task(self._load(model))
            self._load_tasks[model] = task
            task.add_done_callback(
                lambda t, m=model: self._load_tasks.pop(m, None))
        try:
            # shield: a waiter's cancellation (client disconnect) must not
            # cancel the shared load, nor poison the other waiters
            ok = await asyncio.shield(task)
        except asyncio.CancelledError:
            raise  # THIS request was cancelled; the load continues
        except Exception:
            ok = False
        if not ok:
            self._fail_at[model] = time.monotonic()
        return ok


    # -------------------------------------------- keep_alive enforcement

    def start_keep_alive_sweeper(self, interval_s: float = 10.0) -> None:
        """Opt-in Ollama idle-unload (gateway.enforce_keep_alive): when a
        model's keep_alive window passes with no new requests, broadcast a
        real unload. The next request auto-loads it back."""
        if self._sweeper is None:
            self._sweeper = asyncio.create_task(
                self._sweep_loop(interval_s))

    async def stop_keep_alive_sweeper(self) -> None:
        if self._sweeper is not None:
            self._sweeper.cancel()
            try:
                await self._sweeper
            except asyncio.CancelledError:
                pass
            self._sweeper = None

    async def _sweep_loop(self, interval_s: float) -> None:
        while True:
            await asyncio.sleep(interval_s)
            now = time.time()
            busy = set()
            if self.active_models is not None:
                try:
                    busy = {self.canonical(m) for m in self.active_models()}
                except Exception:  # noqa: BLE001
                    busy = set()
            for model, exp in list(self.model_expiry.items()):
                if exp is None or now < exp or self.canonical(model) in busy:
                    continue
                try:
                    # if_idle: the WORKER declines when any request is in
                    # flight or queued on the engine — closes the window
                    # between this gateway-side busy check and the unload
                    # landing (a sweep must never abort work; an explicit
                    # /api/delete still force-unloads)
                    results = await self.broadcast(
                        "unload_model", {"model": model, "if_idle": True},
                        30.0)
                except Exception:  # noqa: BLE001 — sweep must keep running
                    continue
                if any(r.get("ok") for r in results):
                    self.model_expiry.pop(model, None)
                elif (
                    results
                    and any("model management disabled"
                            in str(r.get("detail", "")) for r in results)
                    and all(
                        "model management disabled" in str(r.get("detail", ""))
                        or "not loaded" in str(r.get("detail", ""))
                        for r in results
                    )
                    # don't clobber a keep_alive touch (possibly None =
                    # keep forever) that landed during the 30s broadcast
                    and self.model_expiry.get(model) == exp
                ):
                    # Every REPLYING worker that HOLDS the model is a
                    # multi-host group member (admin ops permanently
                    # disabled; workers without the model answer "not
                    # loaded here") — back the retry off instead of
                    # re-broadcasting cluster-wide every sweep. Backoff,
                    # not permanent disable: the result set can be partial
                    # (a single-host worker offline or past the timeout),
                    # so the conclusion stays revisitable. /api/ps keeps
                    # reporting it resident.
                    log.info("keep_alive: only non-evictable (multi-host "
                             "group) replies for model, backing off",
                             model=model, backoff_s=self.SWEEP_BACKOFF_S)
                    self.model_expiry[model] = now + self.SWEEP_BACKOFF_S
                # otherwise declined/failed: keep the expiry so /api/ps
                # stays honest and the next sweep retries


def get_admin(registry: WorkerRegistry, admin: "ModelAdmin | None",
              default_timeout_ms: int) -> ModelAdmin:
    """build_routes helper: use the app-shared instance when provided."""
    return admin if admin is not None else ModelAdmin(
        registry, default_timeout_ms)


__all__ = ["ModelAdmin", "get_admin"]
