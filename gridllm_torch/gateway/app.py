"""Gateway server assembly (the JAX package's gateway/app.py): a local
scheduler, or a stateless replica in front of scheduler shards.

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
               config: Config | None = None, fleet=None,
               timeline=None, incidents=None) -> web.Application:
    """``fleet``: a FleetView on scaled-control-plane gateway replicas —
    the admin/health surfaces then answer fleet-wide.
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
    app.add_routes(health_routes.build_routes(bus, registry, scheduler,
                                              version, fleet=fleet))
    app.add_routes(obs_routes.build_routes(scheduler, fleet=fleet,
                                           timeline=timeline,
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

    Control-plane modes (``GRIDLLM_CONTROLPLANE``):

    - ``local`` (default): the scheduler lives in this process — the
      single-box layout.
    - ``gateway``: this process is one of N stateless replicas. The
      scheduler is a GatewaySubmitter (submissions fan out to the
      scheduler shards on ``ctrl:submit``; results/streams arrive on
      the durable per-job channels), the registry runs in observer mode
      (shards own the worker-death verdicts), and a FleetView +
      StatusPublisher serve the fleet-wide admin/health surface.
    """

    def __init__(self, config: Config | None = None, bus: MessageBus | None = None):
        self.config = config or load_config()
        from gridllm_torch.obs import default_flight_recorder

        default_flight_recorder().set_capacity(
            self.config.obs.flightrec_capacity)
        self.bus = bus or create_bus(self.config.bus.url,
                                     key_prefix=self.config.bus.key_prefix,
                                     password=self.config.bus.password,
                                     db=self.config.bus.db,
                                     endpoints=self.config.bus.endpoints)
        cp = self.config.controlplane
        self.fleet = None
        self._status_pub = None
        if cp.mode == "gateway":
            from gridllm_torch.controlplane.client import GatewaySubmitter
            from gridllm_torch.controlplane.status import (
                FleetView,
                StatusPublisher,
            )

            self.registry = WorkerRegistry(self.bus, self.config.scheduler,
                                           observer=True)
            self.scheduler = GatewaySubmitter(
                self.bus, self.registry, self.config.scheduler,
                slo_config=self.config.obs.slo,
                member_id=cp.member_id)
            self.fleet = FleetView(
                self.bus, self.scheduler.metrics,
                stale_after_ms=3 * cp.status_interval_ms)
            self._status_pub = StatusPublisher(
                self.bus, self.scheduler, "gateway",
                self.scheduler.member_id, cp.status_interval_ms)
        else:
            self.registry = WorkerRegistry(self.bus, self.config.scheduler)
            self.scheduler = JobScheduler(
                self.bus, self.registry, self.config.scheduler,
                slo_config=self.config.obs.slo,
                watchdog_config=self.config.obs.watchdog)
        # fleet timeline & incident forensics: every gateway — local or
        # replica — arms the event publisher plus a store + collector, so
        # any member answers /admin/timeline + /admin/incidents
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
                              self.config, fleet=self.fleet,
                              timeline=self.timeline_store,
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
        if self.fleet is not None:
            await self.fleet.start()
        if self._status_pub is not None:
            await self._status_pub.start()
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
        if self._status_pub is not None:
            await self._status_pub.stop()
        if self.fleet is not None:
            await self.fleet.stop()
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
        # signals first: a SIGTERM that lands while the server starts still
        # shuts it down cleanly
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        server = GatewayServer()
        await server.start()
        await stop.wait()
        await server.shutdown()

    asyncio.run(run())


if __name__ == "__main__":  # pragma: no cover
    main()
