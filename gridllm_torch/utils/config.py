"""Env-driven configuration of the port's worker.

The JAX package's utils/config.py, cut to what the worker reads: the
registry of ``GRIDLLM_*`` names with the typed accessors, `WorkerConfig`,
and `load_config` for the worker process. The names, defaults and parsing
are the JAX package's, so one deployment file sets up a JAX worker and a
torch worker alike. Knobs of the port alone would be ``GRIDTORCH_*``; the
worker needs none.
"""

from __future__ import annotations

import dataclasses
import os
import uuid
from typing import Any


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One registered environment knob: its default and documentation."""

    name: str
    default: str          # raw string form; "" means unset/empty default
    description: str


ENV_VARS: dict[str, EnvVar] = {}


def register_env(name: str, default: str, description: str) -> None:
    if name in ENV_VARS:
        raise ValueError(f"duplicate register_env({name!r})")
    ENV_VARS[name] = EnvVar(name, default, description)


def _registered(name: str) -> EnvVar:
    var = ENV_VARS.get(name)
    if var is None:
        raise KeyError(
            f"unregistered env var {name!r}: declare it in "
            "gridllm_torch/utils/config.py ENV_VARS (register_env)")
    return var


def env_str(name: str) -> str:
    var = _registered(name)
    raw = os.environ.get(name)
    return raw if raw is not None else var.default


def env_int(name: str) -> int:
    """A set-but-malformed value raises rather than serving the default."""
    var = _registered(name)
    raw = os.environ.get(name)
    if not raw:
        return int(var.default or 0)
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a valid integer "
            f"(default: {var.default or 0})") from None


def env_float(name: str) -> float:
    var = _registered(name)
    raw = os.environ.get(name)
    if not raw:
        return float(var.default or 0.0)
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a valid number "
            f"(default: {var.default or 0.0})") from None


def env_int_lenient(name: str) -> int:
    """Like env_int, but a malformed value degrades to the registry default:
    for reads on serving paths, where a typo must never fail a request."""
    try:
        return env_int(name)
    except ValueError:
        return int(_registered(name).default or 0)


_FALSY = ("0", "off", "false", "no")
_TRUTHY = ("1", "on", "true", "yes")


def env_bool(name: str) -> bool:
    """The truthy/falsy sets below; anything else raises."""
    var = _registered(name)
    raw = os.environ.get(name)
    if not raw:
        return var.default.lower() in _TRUTHY
    low = raw.lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    raise ValueError(f"{name}={raw!r} is not a boolean "
                     f"(use one of {_TRUTHY + _FALSY})")


# The names the worker reads, with the JAX package's defaults.
register_env("GRIDLLM_LOG_LEVEL", "info",
             "Log level for the structured logger (debug/info/warning/error).")
register_env("GRIDLLM_BUS_URL", "",
             "Message-bus endpoint; empty = in-memory bus, resp://host:port = "
             "wire broker/Redis.")
register_env("GRIDLLM_BUS_ENDPOINTS", "",
             "Ordered comma list of resp://host:port broker endpoints (primary "
             "FIRST, warm standbys after); empty = GRIDLLM_BUS_URL only.")
register_env("GRIDLLM_MODELS", "",
             "Comma-separated model registry names this worker serves.")
register_env("GRIDLLM_CHECKPOINT_DIR", "",
             "Directory holding model checkpoints (safetensors layouts).")
register_env("GRIDLLM_ALLOW_SYNTHETIC_WEIGHTS", "0",
             "Serve randomly initialized weights when no checkpoint is found "
             "(test/bench only).")
register_env("GRIDLLM_WEIGHT_SNAPSHOT_BYTES", "0",
             "Host-RAM weight snapshot tier capacity (bytes). Unloading "
             "a model parks its device params as host arrays keyed by "
             "checkpoint identity; a later load restores via host-to-"
             "device transfer instead of re-reading the checkpoint. "
             "LRU-evicted past capacity; 0 disables the tier.")
register_env("GRIDLLM_PREWARM_COMPILES", "0",
             "When 1, a freshly loaded engine runs a one-token greedy "
             "prewarm request before serving, compiling the smallest "
             "prefill bucket and the decode step so the first real "
             "request skips warmup compiles (with the compile cache "
             "this is a disk hit, not an XLA compile).")
register_env("GRIDLLM_DTYPE", "bfloat16", "Model compute/weight dtype.")
register_env("GRIDLLM_MAX_BATCH_SLOTS", "8",
             "Continuous-batching slot count per engine.")
register_env("GRIDLLM_KV_PAGE_SIZE", "128", "Tokens per KV-cache page.")
register_env("GRIDLLM_STREAM_FLUSH_MS", "20",
             "Token-frame batching window for streamed responses (ms).")
register_env("GRIDLLM_PREFILL_BUCKETS", "512,1024,2048,4096,8192",
             "Comma-separated prefill padding buckets (tokens).")
register_env("GRIDLLM_MESH_SHAPE", "",
             'Device-mesh axes, e.g. "tp:8"; empty = single device.')
register_env("GRIDLLM_NUM_PROCS", "1", "Total processes in the worker slice.")
register_env("GRIDLLM_WORKER_ROLE", "unified",
             "Fleet role of this worker: unified, prefill, or decode.")
register_env("GRIDLLM_WORKER_ADVERTISE_ADDR", "",
             "host:port other workers reach this worker's health server at; "
             "empty = 127.0.0.1:port.")
register_env("GRIDLLM_DRAIN_BUDGET_MS", "5000",
             "Graceful-drain budget: how long a draining worker lets in-flight "
             "jobs finish before handing the rest off (ms).")
register_env("GRIDLLM_RESUME_SNAPSHOT_TOKENS", "8",
             "Publish a decode-state resume snapshot every N generated tokens "
             "(crash-resume watermark); 0 disables snapshots.")
register_env("GRIDLLM_FAULT_SPEC", "",
             "Deterministic fault-injection spec: comma list of site=probability, "
             "site=@N (Nth call), or site=@N+ (from the Nth call); empty disables.")
register_env("GRIDLLM_FAULT_SEED", "0",
             "Seed for the per-site fault-injection RNGs; the decision sequence "
             "is a pure function of (seed, site, call #).")
register_env("GRIDLLM_FLIGHTREC_CAPACITY", "256",
             "Flight-recorder ring capacity per subsystem.")
# KV migration (disaggregated serving, drain by migration)
register_env("GRIDLLM_KVX_CHUNK_BYTES", "262144",
             "KV-migration chunk size on the bus path (bytes).")
register_env("GRIDLLM_KVX_WINDOW", "8",
             "KV-migration chunks in flight before awaiting receiver "
             "progress.")
register_env("GRIDLLM_KVX_TIMEOUT_MS", "15000",
             "End-to-end KV-transfer deadline (ms).")
register_env("GRIDLLM_KVX_HTTP_BYTES", "8388608",
             "Payload size beyond which migration uses one direct "
             "worker-to-worker HTTP POST instead of bus chunks.")
# the host KV tier
register_env("GRIDLLM_KV_HOST_BYTES", "0",
             "Host-RAM KV tier capacity (bytes): prefix-cache pages evicted "
             "from device memory spill here and page back in on prefix "
             "matches; 0 disables the tier.")
register_env("GRIDLLM_KV_SPILL_INT8", "1",
             "Int8-quantize fp KV pages on spill to the host tier (one scale "
             "per layer and page); 0 spills raw bytes (tier-on streams stay "
             "byte-identical to tier-off).")
# the models
register_env("GRIDLLM_MOE_RAGGED", "auto",
             "MoE feed-forward of 16 or more tokens per call in the sorted "
             "per-expert (ragged) form: auto (on CUDA only), 1 (force on), "
             "0 (the dense all-experts form).")
register_env("GRIDLLM_TIMELINE", "1",
             "Fleet-wide causal timeline: arm the HLC-stamped event publisher.")
register_env("GRIDLLM_TIMELINE_QUEUE", "2048",
             "Bounded timeline publisher queue (events); overflow drops the "
             "OLDEST events.")
register_env("GRIDLLM_TIMELINE_FLUSH_MS", "200",
             "Timeline publisher flush interval (ms).")
register_env("GRIDLLM_TIMELINE_BATCH", "256",
             "Max events per obs:event batch message.")


def _env(name: str, default: Any) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    return raw


_ROLES = ("unified", "prefill", "decode")


@dataclasses.dataclass
class WorkerConfig:
    """The JAX package's WorkerConfig (same fields and defaults)."""

    worker_id: str = dataclasses.field(
        default_factory=lambda: f"worker-{uuid.uuid4().hex[:12]}")
    host: str = "0.0.0.0"
    port: int = 3000
    heartbeat_interval_ms: int = 5_000
    resource_monitor_interval_ms: int = 10_000
    max_reconnect_attempts: int = 10
    max_concurrent_tasks: int = 1
    performance_tier: str = "medium"
    role: str = "unified"
    advertise_addr: str = ""
    drain_budget_ms: int = 5_000

    def __post_init__(self) -> None:
        if self.heartbeat_interval_ms <= 0 or self.resource_monitor_interval_ms <= 0:
            raise ValueError("worker intervals must be > 0")
        if self.drain_budget_ms < 0:
            raise ValueError("drain_budget_ms must be >= 0")
        if self.role not in _ROLES:
            raise ValueError(f"role {self.role!r} (have {_ROLES})")


@dataclasses.dataclass
class BusConfig:
    url: str = ""
    key_prefix: str = "GridLLM:"
    password: str | None = None
    db: int = 0
    endpoints: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeConfig:
    """The engine settings a worker process builds its engines from (the
    JAX package's `EngineConfig` of utils/config.py)."""

    models: str = ""
    checkpoint_dir: str = ""
    dtype: str = "bfloat16"
    max_batch_slots: int = 8
    kv_page_size: int = 128
    stream_flush_ms: int = 20
    prefill_buckets: str = "512,1024,2048,4096,8192"
    mesh_shape: str = ""
    num_procs: int = 1


@dataclasses.dataclass
class TimelineConfig:
    enabled: bool = True
    queue_capacity: int = 2048
    flush_ms: float = 200.0
    batch_max: int = 256


@dataclasses.dataclass
class Config:
    bus: BusConfig
    worker: WorkerConfig
    engine: ServeConfig
    timeline: TimelineConfig
    flightrec_capacity: int = 256


def load_config() -> Config:
    """The worker process's Config from the environment; invalid values raise."""
    try:
        return Config(
            bus=BusConfig(
                url=env_str("GRIDLLM_BUS_URL"),
                key_prefix=_env("REDIS_KEY_PREFIX", "GridLLM:"),
                password=os.environ.get("REDIS_PASSWORD") or None,
                db=_env("REDIS_DB", 0),
                endpoints=[e.strip() for e in env_str("GRIDLLM_BUS_ENDPOINTS").split(",")
                           if e.strip()],
            ),
            worker=WorkerConfig(
                worker_id=_env("WORKER_ID", f"worker-{uuid.uuid4().hex[:12]}"),
                host=_env("WORKER_HOST", "0.0.0.0"),
                port=_env("WORKER_PORT", 3000),
                heartbeat_interval_ms=_env("HEARTBEAT_INTERVAL", 5_000),
                max_reconnect_attempts=_env("MAX_RECONNECT_ATTEMPTS", 10),
                max_concurrent_tasks=_env("MAX_CONCURRENT_TASKS", 1),
                performance_tier=_env("PERFORMANCE_TIER", "medium"),
                role=env_str("GRIDLLM_WORKER_ROLE"),
                advertise_addr=env_str("GRIDLLM_WORKER_ADVERTISE_ADDR"),
                drain_budget_ms=env_int("GRIDLLM_DRAIN_BUDGET_MS"),
            ),
            engine=ServeConfig(
                models=env_str("GRIDLLM_MODELS"),
                checkpoint_dir=env_str("GRIDLLM_CHECKPOINT_DIR"),
                dtype=env_str("GRIDLLM_DTYPE"),
                max_batch_slots=env_int("GRIDLLM_MAX_BATCH_SLOTS"),
                kv_page_size=env_int("GRIDLLM_KV_PAGE_SIZE"),
                stream_flush_ms=env_int("GRIDLLM_STREAM_FLUSH_MS"),
                prefill_buckets=env_str("GRIDLLM_PREFILL_BUCKETS"),
                mesh_shape=env_str("GRIDLLM_MESH_SHAPE"),
                num_procs=env_int("GRIDLLM_NUM_PROCS"),
            ),
            timeline=TimelineConfig(
                enabled=env_bool("GRIDLLM_TIMELINE"),
                queue_capacity=env_int("GRIDLLM_TIMELINE_QUEUE"),
                flush_ms=env_float("GRIDLLM_TIMELINE_FLUSH_MS"),
                batch_max=env_int("GRIDLLM_TIMELINE_BATCH"),
            ),
            flightrec_capacity=env_int("GRIDLLM_FLIGHTREC_CAPACITY"),
        )
    except ValueError as e:
        raise SystemExit(f"Invalid configuration: {e}") from e
