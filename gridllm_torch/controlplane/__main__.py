"""Scheduler-shard process entry: ``python -m gridllm_torch.controlplane``.

Builds bus → registry (full liveness — shards own the death verdicts
for their partitions' jobs) → SchedulerShard → StatusPublisher, plus a
small health HTTP listener (``GRIDLLM_SHARD_HEALTH_PORT``) serving this
shard's ``/metrics``, ``/admin/slo``, ``/admin/dump``, ``/admin/trace``
and ``/health/live`` so Prometheus can scrape shards directly — the
gateway replicas' FleetView serves the aggregated fleet view either way.

Configuration: ``GRIDLLM_SHARD_COUNT`` (fleet-wide M), ``GRIDLLM_SHARD_ID``
(this process's home partition), ``GRIDLLM_SHARD_LEASE_TTL_MS`` /
``GRIDLLM_SHARD_RENEW_MS`` (failover timers), ``GRIDLLM_BUS_URL`` /
``GRIDLLM_BUS_ENDPOINTS`` (the shared bus, HA pair supported).
"""

from __future__ import annotations

import asyncio
import signal

from gridllm_torch.utils.logging import get_logger

log = get_logger("controlplane.main")


async def run_shard() -> None:
    from aiohttp import web

    from gridllm_torch.bus import create_bus
    from gridllm_torch.controlplane.shard import SchedulerShard
    from gridllm_torch.controlplane.status import StatusPublisher
    from gridllm_torch.gateway import obs_routes
    from gridllm_torch.scheduler import WorkerRegistry
    from gridllm_torch.utils.config import load_config

    # signals first: a SIGTERM that lands while the shard starts up still
    # stops it cleanly, releasing its lease
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    config = load_config()
    cp = config.controlplane
    bus = create_bus(config.bus.url, key_prefix=config.bus.key_prefix,
                     password=config.bus.password, db=config.bus.db,
                     endpoints=config.bus.endpoints)
    await bus.connect()
    registry = WorkerRegistry(bus, config.scheduler)
    shard = SchedulerShard(bus, registry, config.scheduler, cp,
                           slo_config=config.obs.slo,
                           watchdog_config=config.obs.watchdog)
    # fleet timeline: shards publish their lifecycle events and
    # keep their own store + incident collector, so a surviving shard's
    # health port answers /admin/incidents even with every gateway down
    timeline_pub = None
    timeline_store = None
    incidents = None
    tl = config.obs.timeline
    if tl.enabled:
        from gridllm_torch.obs import (
            IncidentCollector,
            TimelinePublisher,
            TimelineStore,
        )

        timeline_pub = TimelinePublisher(
            shard.member_id, queue_capacity=tl.queue_capacity,
            flush_ms=tl.flush_ms, batch_max=tl.batch_max)
        timeline_store = TimelineStore(capacity=tl.store_capacity,
                                       max_requests=tl.store_requests)
        incidents = IncidentCollector(
            timeline_store, member=shard.member_id,
            window_ms=tl.incident_window_ms,
            max_incidents=tl.max_incidents)
        timeline_pub.install()
        await timeline_pub.start(bus)
        await timeline_store.attach(bus)
    await registry.initialize()
    await shard.start()
    status = StatusPublisher(bus, shard.scheduler, "shard",
                             shard.member_id, cp.status_interval_ms,
                             lease=shard.lease)
    await status.start()

    runner: web.AppRunner | None = None
    if cp.shard_health_port:
        app = web.Application()
        app.add_routes(obs_routes.build_routes(shard.scheduler,
                                               timeline=timeline_store,
                                               incidents=incidents))

        async def live(_request: web.Request) -> web.Response:
            return web.json_response({
                "status": "alive",
                "member": shard.member_id,
                "shards": shard.lease.held_shards(),
            })

        app.add_routes([web.get("/health/live", live)])
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "0.0.0.0", cp.shard_health_port)
        await site.start()
    log.info("scheduler shard serving", member=shard.member_id,
             home=cp.shard_id, num_shards=cp.num_shards,
             health_port=cp.shard_health_port or None)

    await stop.wait()

    log.info("scheduler shard shutting down", member=shard.member_id)
    await status.stop()
    if runner is not None:
        await runner.cleanup()
    await shard.stop()
    await registry.shutdown()
    if timeline_pub is not None:
        await timeline_pub.stop()
    if timeline_store is not None:
        await timeline_store.detach()
    await bus.disconnect()


def main() -> None:  # pragma: no cover
    asyncio.run(run_shard())


if __name__ == "__main__":  # pragma: no cover
    main()
