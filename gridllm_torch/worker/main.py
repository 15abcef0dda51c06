"""Torch worker process entry (``python -m gridllm_torch.worker``).

The JAX package's worker/main.py for one process and one device: the
models of GRIDLLM_MODELS, each an `InferenceEngine` on CUDA, served by a
`WorkerService` on the bus GRIDLLM_BUS_URL names (empty: an in-process
bus), plus the health port (WORKER_PORT) with /health, /metrics,
/admin/dump, /admin/memory, /admin/drain, POST /admin/profile and POST
/kvx/{request_id} (a KV migration's payload in one request). The
environment is the JAX worker's, so one deployment file sets up either.

A model with a directory under GRIDLLM_CHECKPOINT_DIR
(`resolve_checkpoint`) is served from its safetensors; one without serves
random weights, and a load-on-demand does so only under
GRIDLLM_ALLOW_SYNTHETIC_WEIGHTS=1, as the JAX worker's. The tokenizer
directory is passed on; where transformers is not installed (the card's
machine) the engine serves the byte tokenizer. GRIDLLM_PREWARM_COMPILES=1
makes each engine serve one token before the worker announces it.
GRIDLLM_WORKER_ROLE sets the fleet role: unified, prefill or decode.
aiohttp is imported by the health port alone.

A tensor-parallel worker group (the JAX worker's multi-host slice): one
process per device, GRIDLLM_NUM_PROCS of them, each with its
GRIDLLM_PROC_ID and the liaison's GRIDLLM_COORD_ADDR, and
GRIDLLM_MESH_SHAPE="tp:N" with N the process count. Every process joins
the torch.distributed group (NCCL, rank r on cuda:{r % device_count},
unless `run` is given another backend), builds the same engines on its
shard, and then:
  - process 0, the liaison, runs the WorkerService as ONE logical worker
    (no load-on-demand, no admin ops: every rank's engines must be built in
    lockstep) and publishes its engines' step plan (worker/plan.py);
  - the followers replay the plan, so every rank issues the same model
    calls and collectives;
  - any member's death fails the whole logical worker (worker/group.py):
    the liaison announces worker:disconnected and every process exits.
A group serves every family and mode one card serves (int8 weights,
either attention mode, images, embedding jobs, the prefix cache, a draft
model's trees) but mixtral. Refused, naming ROADMAP A 9: any mesh axis but
tp, and (in the engine) mixtral under a mesh. A mesh whose size is not
GRIDLLM_NUM_PROCS is refused: the torch worker drives one device per
process.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import platform
from typing import Any

from gridllm_torch.bus import create_bus
from gridllm_torch.engine import EngineConfig, InferenceEngine
from gridllm_torch.obs.perf import capture_profile
from gridllm_torch.parallel.mesh import AXES, MeshConfig, unported_axes
from gridllm_torch.utils.config import Config, env_bool, load_config
from gridllm_torch.utils.logging import get_logger
from gridllm_torch.utils.types import iso_now
from gridllm_torch.worker.capabilities import system_resources
from gridllm_torch.worker.service import WorkerService

log = get_logger("worker.main")

VERSION = "0.1.0"
# the JAX package's bound on an on-demand capture
PROFILE_MAX_SECONDS = 120.0


def resolve_checkpoint(root: str | None, model: str) -> tuple[str | None, str | None]:
    """(checkpoint_path, tokenizer_path) for `model` under a checkpoint root:
    weights at {root}/{name-with-:-replaced-by-_}, the tokenizer in a
    tokenizer/ subdirectory or beside the weights."""
    if not root:
        return None, None
    cand = os.path.join(root, model.replace(":", "_"))
    if not os.path.isdir(cand):
        return None, None
    tok_sub = os.path.join(cand, "tokenizer")
    return cand, tok_sub if os.path.isdir(tok_sub) else cand


def _mesh_config(config: Config) -> MeshConfig | None:
    """GRIDLLM_MESH_SHAPE ("tp:2", "pp:2,tp:4", ...) as a MeshConfig."""
    if not config.engine.mesh_shape:
        return None
    axes = dict(kv.split(":") for kv in config.engine.mesh_shape.split(",") if kv)
    return MeshConfig(**{k: int(v) for k, v in axes.items()})


def check_single_device(config: Config) -> None:
    """Refuse a group shape the torch worker cannot run: a mesh axis other
    than tp (ROADMAP A 9), a group without a mesh, and a mesh whose size is
    not the process count (one process per device)."""
    mesh, n = _mesh_config(config), config.engine.num_procs
    shape = config.engine.mesh_shape
    if mesh is None:
        if n > 1:
            raise SystemExit(
                f"GRIDLLM_NUM_PROCS={n} without GRIDLLM_MESH_SHAPE: a torch worker group "
                f"shards its models over tp, one process per device (GRIDLLM_MESH_SHAPE=tp:{n})")
        return
    try:
        dims = mesh.resolve(n)
    except ValueError as e:
        raise SystemExit(
            f"GRIDLLM_MESH_SHAPE={shape!r} over GRIDLLM_NUM_PROCS={n}: the torch worker "
            f"drives one device per process, so the mesh's size must be the process "
            f"count ({e})") from None
    bad = unported_axes(dict(zip(AXES, dims)))
    if bad:
        raise SystemExit(f"GRIDLLM_MESH_SHAPE={shape!r}: mesh axes {', '.join(bad)} are not "
                         "ported to the torch worker yet (ROADMAP A 9)")


def build_one_engine(config: Config, name: str, device: str = "cuda") -> InferenceEngine:
    """Engine for one model under this worker's settings: its checkpoint
    and tokenizer from `resolve_checkpoint`, else random weights."""
    ckpt, tok = resolve_checkpoint(config.engine.checkpoint_dir, name)
    buckets = tuple(int(b) for b in config.engine.prefill_buckets.split(",") if b)
    eng = InferenceEngine(EngineConfig(
        model=name,
        checkpoint_path=ckpt,
        tokenizer=tok,
        dtype=config.engine.dtype,
        max_slots=config.engine.max_batch_slots,
        page_size=config.engine.kv_page_size,
        prefill_buckets=buckets,
        mesh=_mesh_config(config),
    ), device=device)
    log.info("engine ready", model=name, checkpoint=ckpt or "random-init",
             weights=eng.load_source)
    return eng


def pull_engine_factory(config: Config, device: str = "cuda"):
    """WorkerService.engine_factory for load-on-demand: like
    build_one_engine, but refuses a model whose checkpoint does not resolve
    unless GRIDLLM_ALLOW_SYNTHETIC_WEIGHTS=1, as the JAX worker's does."""

    def factory(name: str) -> InferenceEngine:
        ckpt, _ = resolve_checkpoint(config.engine.checkpoint_dir, name)
        if ckpt is None and not env_bool("GRIDLLM_ALLOW_SYNTHETIC_WEIGHTS"):
            raise ValueError(
                f"no checkpoint for {name!r} under "
                f"{config.engine.checkpoint_dir or '$GRIDLLM_CHECKPOINT_DIR'} — refusing "
                "to serve random weights (set GRIDLLM_ALLOW_SYNTHETIC_WEIGHTS=1 to "
                "override)")
        return build_one_engine(config, name, device=device)

    return factory


def build_engines(config: Config, device: str = "cuda") -> dict[str, InferenceEngine]:
    names = [m.strip() for m in config.engine.models.split(",") if m.strip()]
    return {name: build_one_engine(config, name, device=device) for name in names}


def profile_capture(service: WorkerService, seconds: float) -> dict[str, Any]:
    """An on-demand capture of `seconds` while the worker serves
    (`obs.perf.capture_profile` through its first engine). Returns the
    kernels with the most device time."""
    engines = [e for e in service.engines.values() if not e.embedding_only]
    if not engines:
        raise RuntimeError("no engine to profile")
    return capture_profile(engines[0], seconds, "on_demand")


def handle_profile_request(service: WorkerService,
                           seconds_raw: str | None) -> tuple[int, dict[str, Any]]:
    """(http_status, json_payload) of ``POST /admin/profile?seconds=N``;
    blocks for the capture, so call it through asyncio.to_thread."""
    raw = seconds_raw if seconds_raw is not None else "5"
    try:
        seconds = float(raw)
    except ValueError:
        return 400, {"error": f"seconds must be a number, got {raw!r}",
                     "code": "BAD_REQUEST"}
    if not 0 < seconds <= PROFILE_MAX_SECONDS:
        return 400, {"error": f"seconds must be in (0, {PROFILE_MAX_SECONDS:g}]",
                     "code": "BAD_REQUEST"}
    try:
        return 200, profile_capture(service, seconds)
    except RuntimeError as e:  # another capture, or a foreign one
        return 409, {"error": str(e), "code": "CAPTURE_BUSY"}


async def start_health_port(service: WorkerService, host: str, port: int):
    """Serve the worker's health port (the JAX worker's routes); returns the
    aiohttp runner to clean up. The one place that imports aiohttp."""
    from aiohttp import web

    # client_max_size: the /kvx/ migration route receives whole KV payloads
    # in one POST (aiohttp's 1 MB default would refuse any real transfer)
    app = web.Application(client_max_size=1024**3)
    started = iso_now()

    async def health(_):
        return web.json_response({
            "status": "healthy", "timestamp": iso_now(),
            "worker": service.worker_id, "version": VERSION,
        })

    async def live(_):
        return web.json_response({"status": "alive", "timestamp": iso_now()})

    async def ready(_):
        return web.json_response({"status": "ready", "timestamp": iso_now()})

    async def system(_):
        return web.json_response({
            "status": "ok", "timestamp": iso_now(), "startedAt": started,
            "resources": system_resources().model_dump(),
            "platform": platform.system().lower(),
        })

    async def status(_):
        return web.json_response({
            "workerId": service.worker_id,
            "status": service._status(),
            "currentJobs": service.current_jobs,
            "totalJobsProcessed": service.total_processed,
            "models": list(service.engines),
        })

    async def metrics(_):
        from gridllm_torch.obs import PROMETHEUS_CONTENT_TYPE, default_registry

        return web.Response(text=default_registry().render(),
                            headers={"Content-Type": PROMETHEUS_CONTENT_TYPE})

    async def dump(_):
        from gridllm_torch.obs import build_dump

        artifact = build_dump(reason="on_demand")
        artifact["worker"] = {
            "workerId": service.worker_id,
            "currentJobs": service.current_jobs,
            "models": list(service.engines),
        }
        artifact["activeTraces"] = {
            rid: service.tracer.export(rid) for rid in service.tracer.active_ids()
        }
        return web.json_response(artifact)

    async def memory(_):
        from gridllm_torch.obs import memory_snapshot

        return web.json_response(await asyncio.to_thread(memory_snapshot))

    async def profile(request):
        code, payload = await asyncio.to_thread(
            handle_profile_request, service, request.query.get("seconds"))
        return web.json_response(payload, status=code)

    async def drain(request):
        budget = request.query.get("budget_ms")
        try:
            budget_ms = int(budget) if budget else None
        except ValueError:
            return web.json_response(
                {"error": f"budget_ms must be an integer, got {budget!r}"}, status=400)
        return web.json_response(await service.drain(budget_ms))

    async def kvx(request):
        # direct worker-to-worker KV migration: the whole wire payload in
        # one POST. The header arrived in the bus prepare message; an
        # unknown request id means no prepare was seen, and the sender
        # falls back to bus chunks (or to serving the request itself)
        rid = request.match_info["request_id"]
        body = await request.read()
        result = await service.kvx.feed_http(rid, body)
        return web.json_response(result, status=200 if result.get("ok") else 409)

    app.add_routes([
        web.get("/health", health), web.get("/health/live", live),
        web.get("/health/ready", ready), web.get("/health/system", system),
        web.get("/worker/status", status), web.get("/metrics", metrics),
        web.get("/admin/dump", dump), web.get("/admin/memory", memory),
        web.post("/admin/profile", profile), web.post("/admin/drain", drain),
        web.post("/kvx/{request_id}", kvx),
    ])
    runner = web.AppRunner(app)
    await runner.setup()
    await web.TCPSite(runner, host, port).start()
    return runner


async def run(config: Config | None = None, backend: str = "nccl",
              device: str | None = None) -> None:
    """One torch worker process: bus, engines, WorkerService and health
    port, until SIGTERM, which drains first. In a worker group
    (GRIDLLM_NUM_PROCS > 1) the process first joins the group on `backend`
    (parallel.distributed.initialize_group; `device` is gloo's), then runs
    as the liaison or as a follower (see the module docstring). `device`
    is the engines' device outside a group (default "cuda")."""
    import hashlib

    from gridllm_torch.parallel.distributed import (
        initialize_group,
        rank_device,
        shutdown_group,
    )

    config = config or load_config()
    check_single_device(config)
    from gridllm_torch.obs import TimelinePublisher, default_flight_recorder

    default_flight_recorder().set_capacity(config.obs.flightrec_capacity)
    group = initialize_group(backend=backend, device=device)
    if group.is_group:
        dev = str(rank_device(backend, group.process_id, device))
        if not os.environ.get("WORKER_ID"):
            # every process must agree on the logical worker id, or the
            # member keys never match: derive it from the coordinator
            wid = "worker-slice-" + hashlib.sha1(
                (group.coordinator or "").encode()).hexdigest()[:12]
            config.worker = dataclasses.replace(config.worker, worker_id=wid)
    else:
        dev = device or "cuda"
    engines = build_engines(config, device=dev)
    if not engines:
        raise SystemExit("no models configured: set GRIDLLM_MODELS")
    bus = create_bus(config.bus.url, key_prefix=config.bus.key_prefix,
                     password=config.bus.password, db=config.bus.db,
                     endpoints=config.bus.endpoints)
    await bus.connect()
    timeline_pub = None
    tl = config.obs.timeline
    if tl.enabled:
        timeline_pub = TimelinePublisher(
            config.worker.worker_id, queue_capacity=tl.queue_capacity,
            flush_ms=tl.flush_ms, batch_max=tl.batch_max)
        timeline_pub.install()
        await timeline_pub.start(bus)
    stop = asyncio.Event()
    slice_broken: list[str] = []
    try:
        if group.is_liaison:
            await _run_liaison(config, group, engines, bus, stop, slice_broken)
        else:
            await _run_follower(config, group, engines, bus, stop, slice_broken)
    finally:
        if timeline_pub is not None:
            await timeline_pub.stop()
        await bus.disconnect()
        if slice_broken:
            # a collective with a dead peer never returns: exit now, so the
            # supervisor restarts the group together
            default_flight_recorder().record("worker", "fatal_exit",
                                             worker=config.worker.worker_id,
                                             reason=slice_broken[0])
            log.error("worker group broken; exiting", reason=slice_broken[0])
            os._exit(1)
        shutdown_group(group)


async def _run_liaison(config: Config, group, engines: dict[str, InferenceEngine], bus,
                       stop: asyncio.Event, slice_broken: list[str]) -> None:
    """Process 0 (or the only process): the WorkerService and health port;
    in a group also the membership beacon, the plan publisher and the
    barrier on every follower's plan subscription."""
    import signal
    import threading

    from gridllm_torch.worker.group import GroupMembership, fail_logical_worker
    from gridllm_torch.worker.plan import PlanPublisher, plan_channel, ready_key

    service = WorkerService(
        bus, engines, config.worker, stream_flush_ms=config.engine.stream_flush_ms,
        # a group's engines must be built and torn down on every rank in
        # lockstep: the plan has no engine-construction op
        engine_factory=None if group.is_group else pull_engine_factory(config))
    if group.is_group:
        service.admin_ops_enabled = False

    async def on_slice_failure(reason: str) -> None:
        await fail_logical_worker(bus, service.worker_id, reason)
        await service.stop(announce=False)
        slice_broken.append(reason)
        stop.set()

    membership = GroupMembership(
        bus, service.worker_id, group,
        heartbeat_interval_s=config.worker.heartbeat_interval_ms / 1000.0,
        on_slice_failure=on_slice_failure)
    await membership.start()
    pub = None
    if group.is_group:
        pub = PlanPublisher(bus, plan_channel(service.worker_id), asyncio.get_running_loop())
        pub.start()
        # ONE dispatch lock across every engine: the liaison's cross-engine
        # dispatch order is the plan order the followers replay
        shared_lock = threading.RLock()
        for model, eng in engines.items():
            eng.dispatch_lock = shared_lock
            eng.plan_sink = lambda rec, m=model: pub.sink({**rec, "model": m})
        for pid in range(1, group.num_processes):
            for _ in range(1200):
                if await bus.get(ready_key(service.worker_id, pid)):
                    break
                await asyncio.sleep(0.1)
            else:
                raise SystemExit(f"worker group follower {pid} never became plan-ready")
            membership.saw(pid)
    await service.start()
    runner = await start_health_port(service, config.worker.host, config.worker.port)
    log.info("worker http listening", port=config.worker.port)
    drain_tasks: list[asyncio.Task] = []

    def on_sigterm() -> None:
        async def graceful() -> None:
            try:
                await service.drain()
            finally:
                stop.set()

        log.info("SIGTERM received; draining before exit")
        drain_tasks.append(asyncio.ensure_future(graceful()))

    try:
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, on_sigterm)
    except (NotImplementedError, RuntimeError):  # non-unix platforms
        pass
    try:
        await stop.wait()
    finally:
        await membership.stop()
        await service.stop()
        if pub is not None:
            await pub.stop()
        await runner.cleanup()


async def _run_follower(config: Config, group, engines: dict[str, InferenceEngine], bus,
                        stop: asyncio.Event, slice_broken: list[str]) -> None:
    """A follower: replay the liaison's plan on the same engines until the
    group breaks or SIGTERM."""
    import signal

    from gridllm_torch.worker.group import GroupMembership
    from gridllm_torch.worker.plan import PlanFollower, plan_channel, ready_key

    wid = config.worker.worker_id

    async def on_slice_failure(reason: str) -> None:
        slice_broken.append(reason)
        stop.set()

    membership = GroupMembership(
        bus, wid, group, heartbeat_interval_s=config.worker.heartbeat_interval_ms / 1000.0,
        on_slice_failure=on_slice_failure)
    await membership.start()
    follower = PlanFollower(bus, plan_channel(wid), engines, on_divergence=on_slice_failure)
    await follower.start()
    rk = ready_key(wid, group.process_id)

    async def refresh_ready() -> None:
        # a TTL key, refreshed: a key left by an earlier incarnation of the
        # group must not pass a restarted liaison's barrier
        while True:
            try:
                await bus.set_with_expiry(rk, "1", ttl_s=10.0)
            except Exception as e:  # noqa: BLE001 — keep refreshing
                log.warning("ready-key refresh failed; retrying", key=rk, error=str(e))
            await asyncio.sleep(3.0)

    ready_task = asyncio.create_task(refresh_ready())
    try:
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
    except (NotImplementedError, RuntimeError):  # non-unix platforms
        pass
    log.info("follower replaying step plan", models=list(engines))
    try:
        await stop.wait()
    finally:
        ready_task.cancel()
        await follower.stop()
        await membership.stop()


def main() -> None:  # pragma: no cover
    asyncio.run(run())


if __name__ == "__main__":  # pragma: no cover
    main()
