"""Gateway server assembly (the JAX package's gateway/app.py, local
control-plane mode).

Reference analogue: server/src/index.ts (GridLLMServer, 330 LoC): middleware
stack, route mounting (/ollama, /v1, /inference, /health, root summary),
event→log wiring (:119-212), graceful shutdown (:272-301), 60 s status log
loop (:249-265). The reference also configured a rate limiter but never
mounted it (SURVEY.md §2.4) — here it is actually mounted.
"""

from __future__ import annotations

import asyncio
import time

from aiohttp import web

import gridllm_torch
from gridllm_torch.bus import create_bus
from gridllm_torch.bus.base import MessageBus
from gridllm_torch.gateway import (
    health_routes,
    inference_routes,
    obs_routes,
    ollama_routes,
    openai_routes,
)
from gridllm_torch.gateway.errors import APP_ENV, error_middleware
from gridllm_torch.gateway.ratelimit import rate_limit_middleware
from gridllm_torch.scheduler import JobScheduler, WorkerRegistry
from gridllm_torch.utils.config import Config, load_config
from gridllm_torch.utils.logging import get_logger

log = get_logger("gateway.app")


def create_app(bus: MessageBus, registry: WorkerRegistry, scheduler: JobScheduler,
               config: Config | None = None,
               timeline=None, incidents=None) -> web.Application:
    """The JAX package's create_app in local control-plane mode (its
    ``fleet``, a FleetView on scaled-control-plane replicas, comes with
    that control plane).
    ``timeline``/``incidents``: this member's TimelineStore +
    IncidentCollector behind /admin/timeline and /admin/incidents."""
    config = config or load_config()
    version = gridllm_torch.__version__
    app = web.Application(
        # metrics outermost: it must observe the FINAL status, including
        # error-middleware translations and 429s from the rate limiter
        middlewares=[obs_routes.metrics_middleware(scheduler),
                     error_middleware,
                     rate_limit_middleware(config.gateway, bus=bus,
                                           metrics=scheduler.metrics)],
        client_max_size=config.gateway.max_body_bytes,
    )
    app[APP_ENV] = config.env

    # /ollama/api/* is the canonical mount (reference mounts at /ollama);
    # the same handlers are also mounted bare at /api/* so native Ollama
    # SDKs pointed straight at the gateway work unchanged.
    timeout_ms = config.gateway.default_request_timeout_ms
    # ONE ModelAdmin across surfaces: concurrent cold-model requests from
    # the Ollama and OpenAI APIs coalesce behind the same load broadcast
    from gridllm_torch.gateway.admin import ModelAdmin

    admin = ModelAdmin(registry, timeout_ms)
    admin.active_models = lambda: {
        a.request.model for a in scheduler.get_active_jobs()
    } | {a.request.model for a in scheduler.job_queue}
    if config.gateway.enforce_keep_alive:
        # Ollama-exact idle residency (opt-in; see GatewayConfig)
        async def _start_sweeper(_app):
            admin.start_keep_alive_sweeper()

        async def _stop_sweeper(_app):
            await admin.stop_keep_alive_sweeper()

        app.on_startup.append(_start_sweeper)
        app.on_cleanup.append(_stop_sweeper)
    ollama = ollama_routes.build_routes(registry, scheduler, version,
                                        timeout_ms, admin=admin)
    app.add_routes([web.RouteDef(r.method, f"/ollama{r.path}", r.handler, r.kwargs)
                    for r in ollama])
    app.add_routes(ollama)
    app.add_routes(openai_routes.build_routes(registry, scheduler, timeout_ms,
                                              admin=admin))
    app.add_routes(inference_routes.build_routes(registry, scheduler))
    app.add_routes(health_routes.build_routes(bus, registry, scheduler, version))
    app.add_routes(obs_routes.build_routes(scheduler, timeline=timeline,
                                           incidents=incidents))

    async def root(request: web.Request) -> web.Response:
        """Root summary (reference: server/src/index.ts:86-109)."""
        stats = scheduler.get_stats()
        return web.json_response({
            "name": "GridLLM-TPU Server",
            "version": version,
            "status": "running",
            "workers": registry.get_worker_count(),
            "jobs": stats,
            "endpoints": {
                "ollama": "/ollama/api/*",
                "openai": "/v1/*",
                "inference": "/inference",
                "health": "/health",
            },
        })

    app.add_routes([web.get("/", root)])
    return app


class GatewayServer:
    """Full server lifecycle: bus + registry + scheduler + HTTP.

    Control-plane mode ``local`` (``GRIDLLM_CONTROLPLANE``, the default):
    the scheduler lives in this process, the single-box layout. The JAX
    package's ``gateway`` mode, a stateless replica in front of scheduler
    shards, is refused: the scaled control plane is not ported.
    """

    def __init__(self, config: Config | None = None, bus: MessageBus | None = None):
        self.config = config or load_config()
        if self.config.controlplane.mode != "local":
            raise NotImplementedError(
                f"GRIDLLM_CONTROLPLANE={self.config.controlplane.mode}: gateway "
                "replicas in front of scheduler shards are not ported to the torch "
                "gateway yet (ROADMAP A 10 3); run it in local mode")
        from gridllm_torch.obs import default_flight_recorder

        default_flight_recorder().set_capacity(
            self.config.obs.flightrec_capacity)
        self.bus = bus or create_bus(self.config.bus.url,
                                     key_prefix=self.config.bus.key_prefix,
                                     password=self.config.bus.password,
                                     db=self.config.bus.db,
                                     endpoints=self.config.bus.endpoints)
        self.registry = WorkerRegistry(self.bus, self.config.scheduler)
        self.scheduler = JobScheduler(
            self.bus, self.registry, self.config.scheduler,
            slo_config=self.config.obs.slo,
            watchdog_config=self.config.obs.watchdog)
        # fleet timeline & incident forensics: the gateway arms the event
        # publisher plus a store + collector behind /admin/timeline and
        # /admin/incidents
        self.timeline_store = None
        self.incidents = None
        self._timeline_pub = None
        tl = self.config.obs.timeline
        if tl.enabled:
            from gridllm_torch.obs import (
                IncidentCollector,
                TimelinePublisher,
                TimelineStore,
            )

            member = self.scheduler.identity().get("member") or "local"
            self._timeline_pub = TimelinePublisher(
                member, queue_capacity=tl.queue_capacity,
                flush_ms=tl.flush_ms, batch_max=tl.batch_max)
            self.timeline_store = TimelineStore(
                capacity=tl.store_capacity,
                max_requests=tl.store_requests)
            self.incidents = IncidentCollector(
                self.timeline_store, member=member,
                window_ms=tl.incident_window_ms,
                max_incidents=tl.max_incidents)
        self.app = create_app(self.bus, self.registry, self.scheduler,
                              self.config, timeline=self.timeline_store,
                              incidents=self.incidents)
        self._runner: web.AppRunner | None = None
        self._status_task: asyncio.Task | None = None
        self._wire_events()

    def _wire_events(self) -> None:
        """Event→log wiring (reference: server/src/index.ts:119-212)."""
        self.registry.on("worker_registered",
                         lambda info: log.worker("registered", info.workerId,
                                                 models=info.model_names()))
        self.registry.on("worker_removed",
                         lambda wid, info, reason: log.worker("removed", wid, reason=reason))
        self.scheduler.on("job_queued", lambda r: log.job("queued", r.id, model=r.model))
        self.scheduler.on("job_completed",
                          lambda res: log.job("completed", res.jobId,
                                              ms=round(res.processingTimeMs, 1)))
        self.scheduler.on("job_failed", lambda res: log.job("failed", res.jobId,
                                                            error=res.error))
        self.scheduler.on("job_orphaned", lambda r: log.job("orphaned", r.id))

    async def start(self, port: int | None = None) -> int:
        await self.bus.connect()
        if self._timeline_pub is not None:
            # armed before scheduler/registry init so their lifecycle
            # events are on the fleet timeline from the first moment
            self._timeline_pub.install()
            await self._timeline_pub.start(self.bus)
            await self.timeline_store.attach(self.bus)
        await self.registry.initialize()
        await self.scheduler.initialize()
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.config.gateway.host,
                           port if port is not None else self.config.gateway.port)
        await site.start()
        bound = self._runner.addresses[0][1] if self._runner.addresses else 0
        self._status_task = asyncio.create_task(self._status_loop())
        log.info("gateway started", host=self.config.gateway.host, port=bound)
        return bound

    async def _status_loop(self) -> None:
        """60 s performance snapshot (reference: server/src/index.ts:249-265)."""
        while True:
            await asyncio.sleep(60)
            log.performance("status", workers=self.registry.get_worker_count(),
                            jobs=self.scheduler.get_stats())

    async def shutdown(self) -> None:
        log.info("gateway shutting down")
        if self._status_task:
            self._status_task.cancel()
            self._status_task = None
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        await self.scheduler.shutdown()
        await self.registry.shutdown()
        if self._timeline_pub is not None:
            await self._timeline_pub.stop()
        if self.timeline_store is not None:
            await self.timeline_store.detach()
        await self.bus.disconnect()


def main() -> None:  # pragma: no cover
    """CLI entry: ``python -m gridllm_torch.gateway``."""
    import signal

    async def run() -> None:
        server = GatewayServer()
        await server.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await server.shutdown()

    asyncio.run(run())


if __name__ == "__main__":  # pragma: no cover
    main()
