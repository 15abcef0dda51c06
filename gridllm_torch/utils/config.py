"""Env-driven configuration of the port's worker, scheduler and gateway.

The JAX package's utils/config.py, cut to what the worker, the scheduler
and the gateway read: the registry of ``GRIDLLM_*`` names with the typed
accessors, the `WorkerConfig`, `SchedulerConfig`, `GatewayConfig`,
`SLOConfig`, `WatchdogConfig` and `TimelineConfig` sections, and
`load_config`. The names, defaults, parsing
and validation are the JAX package's (its pydantic models are dataclasses
here; a value the JAX package refuses raises ValueError), so one
deployment file sets up JAX and torch members alike. Knobs of the port
alone would be ``GRIDTORCH_*``; none exists. The gateway's section is
here; of the scaled control plane's only its mode, which the gateway reads
to refuse ``gateway`` (not ported).
"""

from __future__ import annotations

import dataclasses
import json
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


def env_raw(name: str) -> str | None:
    """The raw environment value, or None when unset (a registered name)."""
    _registered(name)
    return os.environ.get(name)


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
register_env("GRIDLLM_ENV", "development",
             "Deployment environment name (NODE_ENV also honored).")
register_env("GRIDLLM_BUS_URL", "",
             "Message-bus endpoint; empty = in-memory bus, resp://host:port = "
             "wire broker/Redis.")
register_env("GRIDLLM_BUS_ENDPOINTS", "",
             "Ordered comma list of resp://host:port broker endpoints (primary "
             "FIRST, warm standbys after); empty = GRIDLLM_BUS_URL only.")
register_env("GRIDLLM_BUS_REJOIN_GRACE_MS", "10000",
             "After this process's bus session reconnects, hold worker-"
             "death verdicts and orphan sweeps this long (ms) so a "
             "broker bounce is not misread as a fleet-wide worker loss.")
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
# the engine's serving knobs (EngineConfig fields left None)
register_env("GRIDLLM_RAGGED_ATTN", "1",
             "Unified ragged paged-attention kernel for prefill/decode/"
             "verify; 0 restores the per-phase dispatchers.")
register_env("GRIDLLM_KV_INT8", "0",
             "Resident int8 KV pool (per-row scales, dequantized in the "
             "attention read path): about half the KV bytes; 1 enables.")
register_env("GRIDLLM_PREFIX_CACHE", "1",
             "Automatic prefix caching of completed requests' KV pages; "
             "0 disables.")
register_env("GRIDLLM_PREFIX_CACHE_PAGES", "-1",
             "Reuse-LRU capacity in pages; -1 = unbounded (whole pool), "
             "0 = off.")
register_env("GRIDLLM_SPEC_DECODE", "1",
             "Speculative decoding (n-gram drafting + batched "
             "verification); 0 disables.")
register_env("GRIDLLM_SPEC_K", "4",
             "Speculation depth: drafted tokens per slot per verify step; "
             "0 disables.")
register_env("GRIDLLM_SPEC_DRAFTER", "ngram",
             "Drafter implementation (\"ngram\").")
register_env("GRIDLLM_SPEC_NGRAM_MAX", "4",
             "Longest n-gram the prompt-lookup drafter matches on.")
register_env("GRIDLLM_SPEC_NGRAM_MIN", "1",
             "Shortest n-gram the prompt-lookup drafter falls back to.")
register_env("GRIDLLM_SPEC_LOOKBACK", "0",
             "Drafter match window over the slot history in tokens; "
             "0 = unbounded.")
register_env("GRIDLLM_SPEC_DRAFT_MODEL", "",
             "Registered config name of a small same-tokenizer draft model "
             "for model-based tree drafting; empty keeps n-gram drafting.")
register_env("GRIDLLM_SPEC_DRAFT_CHECKPOINT", "",
             "Checkpoint dir for the draft model; empty = random weights "
             "(test/bench path).")
register_env("GRIDLLM_SPEC_TREE_WIDTH", "2",
             "Draft-tree sibling fan-out at depth 1 (tree node budget is "
             "1 + K + width - 1); 1 = pure chain.")
register_env("GRIDLLM_SPEC_DRAFT_INGEST", "64",
             "Fixed catch-up chunk width (tokens) of the draft model's "
             "context-ingest forward.")
# the models
register_env("GRIDLLM_MOE_RAGGED", "auto",
             "MoE feed-forward of 16 or more tokens per call in the sorted "
             "per-expert (ragged) form: auto (on CUDA only), 1 (force on), "
             "0 (the dense all-experts form).")
# the scheduler: roles, affinity, preemption, retries and deadlines
register_env("GRIDLLM_DISAGG", "1",
             "Two-phase prefill/decode placement on split fleets; "
             "0 forces whole-request placement.")
register_env("GRIDLLM_PREFIX_AFFINITY_WEIGHT", "0.25",
             "Load-score bonus for workers whose heartbeat digest holds "
             "the request's prefix key; 0 disables affinity routing.")
register_env("GRIDLLM_PREEMPT_AFTER_MS", "0",
             "Scheduler preemption: a queued higher-priority generation "
             "unplaceable for this long triggers suspend-to-host of one "
             "lower-priority running job; 0 disables preemption.")
register_env("GRIDLLM_RETRY_BACKOFF_MAX_MS", "60000",
             "Cap for the retry ladder's exponential backoff (full "
             "jitter; base is the retry delay).")
register_env("GRIDLLM_RETRY_BUDGET_PER_MIN", "120",
             "Fleet-wide retry budget (token bucket, retries/min): when "
             "burning, further retries shed to immediate failure with "
             "retry_budget_exhausted; 0 = unlimited.")
register_env("GRIDLLM_REQUEST_DEADLINE_MS", "0",
             "Queued-job deadline from submission (ms): jobs still "
             "queued past it are shed with deadline_exceeded;"
             " 0 disables.")
register_env("GRIDLLM_REQUEST_DEADLINE_CLASSES", "",
             "JSON object of per-SLO-class deadline overrides (ms), e.g."
             " {\"interactive\": 30000, \"batch\": 600000}.")
# the scheduler's observability: SLO and hang watchdog
register_env("GRIDLLM_SLO_ENABLED", "1",
             "SLO engine (attainment, burn rate, goodput); 0 disables.")
register_env("GRIDLLM_SLO_CLASSES", "",
             "JSON object replacing the default per-class objective table "
             "({class: {ttft_ms, itl_ms, e2e_ms, target}}).")
register_env("GRIDLLM_SLO_WINDOWS", "",
             "Comma list of burn-rate window seconds (default 300,3600).")
register_env("GRIDLLM_WATCHDOG_ENABLED", "1",
             "Per-phase hang watchdog; 0 disables.")
register_env("GRIDLLM_WATCHDOG_INTERVAL", "1000",
             "Watchdog sweep interval (ms).")
register_env("GRIDLLM_WATCHDOG_QUEUE_DEADLINE", "120000",
             "Queue-phase hang deadline (ms).")
register_env("GRIDLLM_WATCHDOG_DISPATCH_DEADLINE", "60000",
             "Dispatch-phase hang deadline (ms).")
register_env("GRIDLLM_WATCHDOG_PREFILL_DEADLINE", "240000",
             "Prefill-phase hang deadline (ms).")
register_env("GRIDLLM_WATCHDOG_DECODE_STALL", "60000",
             "Decode-step stall deadline after the first token (ms).")
register_env("GRIDLLM_WATCHDOG_REQUEUE", "1",
             "Cancel + front-requeue jobs the watchdog catches hung; "
             "0 = diagnose only.")
register_env("GRIDLLM_WATCHDOG_PROFILE_S", "0",
             "Profiler capture length on decode-step hangs (seconds), "
             "taken through an engine in the same process; 0 disables.")
# the scheduler's observability: usage attribution and capacity signals
register_env("GRIDLLM_TENANT_HEADER", "X-GridLLM-Tenant",
             "HTTP header the gateway reads the tenant id from; falls "
             "back to a hash of the Authorization bearer, else "
             "'anonymous'.")
register_env("GRIDLLM_TENANT_LRU", "64",
             "Max distinct tenant label values per registry; overflow "
             "tenants are folded into the 'other' bucket.")
register_env("GRIDLLM_CAPACITY_EWMA_HALFLIFE_S", "60",
             "Half-life (seconds) of the per-model arrival/service rate "
             "and wait-time EWMAs behind /admin/capacity.")
# the scheduler's observability: canary prober and health detector
register_env("GRIDLLM_PROBE_INTERVAL_MS", "0",
             "Canary probe cadence per scheduler shard (ms between "
             "rounds); each round probes one (worker, model) pair "
             "round-robin. 0 disables the prober.")
register_env("GRIDLLM_PROBE_CONCURRENCY", "1",
             "Max canary probes in flight at once per shard.")
register_env("GRIDLLM_PROBE_TIMEOUT_MS", "15000",
             "Per-probe timeout (ms); a timed-out canary counts as a "
             "failed round for the worker's health verdict.")
register_env("GRIDLLM_PROBE_TOKENS", "8",
             "Tokens each canary generates (greedy, fixed seed) — the "
             "byte-determinism surface the golden hash covers.")
register_env("GRIDLLM_HEALTH_EWMA_HALFLIFE_S", "60",
             "Half-life (seconds) of the per-worker baseline EWMAs "
             "(canary e2e latency, decode ITL, heartbeat gap).")
register_env("GRIDLLM_HEALTH_Z_THRESHOLD", "3.0",
             "z-score above which a baseline observation counts as a "
             "regression strike against its worker.")
register_env("GRIDLLM_HEALTH_MIN_SAMPLES", "5",
             "Baseline observations required before z-score judgments "
             "begin.")
register_env("GRIDLLM_HEALTH_DEGRADE_STRIKES", "2",
             "Consecutive regression strikes that move an online worker "
             "to degraded (placement penalty applied).")
register_env("GRIDLLM_HEALTH_QUARANTINE_STRIKES", "3",
             "Consecutive strikes while degraded that quarantine the "
             "worker (drained via the graceful-drain path).")
register_env("GRIDLLM_HEALTH_PROBATION_PASSES", "2",
             "Clean canary rounds a probation (or degraded) worker needs "
             "to rejoin the online pool.")
register_env("GRIDLLM_HEALTH_DEGRADED_PENALTY", "0.5",
             "Load-score penalty the scheduler adds to degraded/"
             "probation workers (same scale as the proportional load "
             "term).")
# the scheduler's model placement controller
register_env("GRIDLLM_PLACEMENT_INTERVAL_MS", "0",
             "Model-placement controller cadence per scheduler shard "
             "(ms between ticks); 0 disables the controller (static "
             "placement).")
register_env("GRIDLLM_MODEL_IDLE_TTL_MS", "0",
             "Idle time (ms) after which the placement controller unloads "
             "a model's replicas above its min-replica floor; 0 disables "
             "idle unload.")
register_env("GRIDLLM_SWAP_COOLDOWN_MS", "10000",
             "Minimum gap (ms) between placement actions for the same "
             "model.")
register_env("GRIDLLM_MODEL_FLOORS", "",
             "Comma-separated model=N min-replica floors the placement "
             "controller keeps.")
register_env("GRIDLLM_TIMELINE", "1",
             "Fleet-wide causal timeline: arm the HLC-stamped event publisher.")
register_env("GRIDLLM_TIMELINE_QUEUE", "2048",
             "Bounded timeline publisher queue (events); overflow drops the "
             "OLDEST events.")
register_env("GRIDLLM_TIMELINE_FLUSH_MS", "200",
             "Timeline publisher flush interval (ms).")
register_env("GRIDLLM_TIMELINE_BATCH", "256",
             "Max events per obs:event batch message.")
register_env("GRIDLLM_TIMELINE_STORE", "4096",
             "TimelineStore global event ring capacity (per member "
             "running a store).")
register_env("GRIDLLM_TIMELINE_REQUESTS", "512",
             "TimelineStore per-request index: max distinct request ids "
             "(LRU).")
register_env("GRIDLLM_TIMELINE_INCIDENT_WINDOW_MS", "5000",
             "Causal window (± ms around the trigger event) an incident "
             "report snapshots from the fleet timeline.")
register_env("GRIDLLM_TIMELINE_INCIDENTS", "32",
             "Max retained incident reports (oldest evicted).")
# the gateway
register_env("GRIDLLM_ENFORCE_KEEP_ALIVE", "0",
             "Unload models whose keep_alive window lapses (Ollama "
             "semantics); off by default — reloads cost minutes.")
register_env("GRIDLLM_RATELIMIT_SCOPE", "replica",
             "Gateway rate-limit bucket scope: replica (per-process "
             "buckets — N replicas multiply every limit by N) or fleet "
             "(bucket state shared through the bus so the limit is "
             "fleet-wide).")
register_env("GRIDLLM_CONTROLPLANE", "local",
             "Control-plane mode: local (scheduler in-process, the "
             "default single-box layout) or gateway (a stateless replica "
             "in front of scheduler shards; not ported, see ROADMAP A 10 3).")


def _env(name: str, default: Any) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


_BOUND_OPS = {"gt": lambda v, b: v > b, "ge": lambda v, b: v >= b,
              "le": lambda v, b: v <= b}


def _check_bounds(obj: Any, bounds: tuple[tuple[str, str, float], ...]) -> None:
    """The JAX package's pydantic ``Field`` bounds as (field, op, limit)
    with op one of gt, ge, le; a value out of bounds raises ValueError."""
    for name, op, limit in bounds:
        value = getattr(obj, name)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{type(obj).__name__}.{name}: expected a number, "
                             f"got {value!r}")
        if not _BOUND_OPS[op](value, limit):
            raise ValueError(f"{type(obj).__name__}.{name}={value!r}: must be "
                             f"{op} {limit}")


def _as_int(obj: Any, name: str) -> None:
    """pydantic's lax int: an integral number is taken, anything else refused."""
    value = getattr(obj, name)
    if isinstance(value, bool) or not isinstance(value, (int, float)) or (
            isinstance(value, float) and not value.is_integer()):
        raise ValueError(f"{type(obj).__name__}.{name}: expected an integer, got {value!r}")
    setattr(obj, name, int(value))


def _as_float(obj: Any, name: str, optional: bool = False) -> None:
    value = getattr(obj, name)
    if value is None and optional:
        return
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"{type(obj).__name__}.{name}: expected a number, got {value!r}")
    setattr(obj, name, float(value))


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
class SchedulerConfig:
    """The JAX package's SchedulerConfig (same fields, defaults and bounds)."""

    worker_heartbeat_timeout_ms: int = 15_000
    worker_cleanup_interval_ms: int = 5_000
    connection_monitor_interval_ms: int = 5_000
    quick_disconnect_window_ms: int = 15_000
    orphan_assign_threshold_ms: int = 10_000
    job_timeout_ms: int = 600_000
    retry_attempts: int = 3
    # the base of a capped exponential backoff with full jitter, and the
    # fleet-wide retry budget (a token bucket, retries per minute)
    retry_delay_ms: int = 5_000
    retry_backoff_max_ms: int = 60_000
    retry_budget_per_min: float = 120
    # a job still queued past its deadline (from first submission) is shed
    # with deadline_exceeded; 0 disables, the dict overrides per SLO class
    request_deadline_ms: int = 0
    request_deadline_classes: dict[str, int] = dataclasses.field(default_factory=dict)
    # worker-death verdicts and orphan sweeps held this long after this
    # process's own bus session rejoins
    bus_rejoin_grace_ms: int = 10_000
    # a queued higher-priority generation unplaceable this long suspends
    # one lower-priority running job; 0 disables preemption
    preempt_after_ms: int = 0
    # capacity NACKs requeue without using up the retry ladder this often
    max_nacks: int = 25
    max_concurrent_jobs_per_worker: int = 1
    # dispatch is event-driven; this sweep is the fallback
    sweep_interval_ms: int = 1_000
    prefix_affinity_weight: float = 0.25
    # two-phase prefill/decode placement on a split fleet
    disagg_enabled: bool = True

    _BOUNDS = (
        ("worker_heartbeat_timeout_ms", "gt", 0), ("worker_cleanup_interval_ms", "gt", 0),
        ("connection_monitor_interval_ms", "gt", 0), ("quick_disconnect_window_ms", "gt", 0),
        ("orphan_assign_threshold_ms", "gt", 0), ("job_timeout_ms", "gt", 0),
        ("retry_attempts", "ge", 0), ("retry_delay_ms", "ge", 0),
        ("retry_backoff_max_ms", "ge", 0), ("retry_budget_per_min", "ge", 0),
        ("request_deadline_ms", "ge", 0), ("bus_rejoin_grace_ms", "ge", 0),
        ("preempt_after_ms", "ge", 0), ("max_nacks", "ge", 0),
        ("max_concurrent_jobs_per_worker", "ge", 1), ("sweep_interval_ms", "gt", 0),
        ("prefix_affinity_weight", "ge", 0),
    )

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            if f.type == "int":
                _as_int(self, f.name)
            elif f.type == "float":
                _as_float(self, f.name)
        self.request_deadline_classes = {
            str(k): int(v) for k, v in dict(self.request_deadline_classes).items()}
        _check_bounds(self, self._BOUNDS)


@dataclasses.dataclass
class SLOClassConfig:
    """Latency objectives for one request class; None means the objective
    does not apply to the class (embeddings have no ITL)."""

    ttft_ms: float | None = None       # submit → first streamed token
    itl_ms: float | None = None        # mean inter-token latency
    e2e_ms: float | None = None        # submit → final result
    target: float = 0.99               # attainment objective

    def __post_init__(self) -> None:
        for name in ("ttft_ms", "itl_ms", "e2e_ms"):
            _as_float(self, name, optional=True)
        _as_float(self, "target")
        _check_bounds(self, (("target", "gt", 0), ("target", "le", 1)))

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> SLOClassConfig:
        """From a JSON object; keys that are no field are ignored, as
        pydantic ignores them."""
        if not isinstance(spec, dict):
            raise ValueError(f"SLOClassConfig: expected an object, got {spec!r}")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in spec.items() if k in names})

    def model_dump(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def default_slo_classes() -> dict[str, SLOClassConfig]:
    """Request classes and their default objectives. Classification
    (obs/slo.py classify_request): streaming generation is interactive,
    non-streaming generation is batch, embeddings are their own class."""
    return {
        "interactive": SLOClassConfig(ttft_ms=2_000, itl_ms=200,
                                      e2e_ms=120_000, target=0.99),
        "batch": SLOClassConfig(e2e_ms=300_000, target=0.95),
        "embedding": SLOClassConfig(e2e_ms=10_000, target=0.99),
    }


@dataclasses.dataclass
class SLOConfig:
    """SLO engine knobs (obs/slo.py). ``GRIDLLM_SLO_CLASSES`` may carry a
    JSON object {class: {ttft_ms, itl_ms, e2e_ms, target}} that replaces
    the defaults wholesale."""

    enabled: bool = True
    classes: dict[str, SLOClassConfig] = dataclasses.field(
        default_factory=default_slo_classes)
    # burn-rate windows (seconds): a fast window for paging, a slow one
    # for tickets
    windows_s: list[int] = dataclasses.field(default_factory=lambda: [300, 3600])


@dataclasses.dataclass
class WatchdogConfig:
    """Hang watchdog (obs/watchdog.py): per-phase deadlines after which a
    request is flagged as wedged."""

    enabled: bool = True
    interval_ms: int = 1_000
    queue_deadline_ms: int = 120_000
    dispatch_deadline_ms: int = 60_000
    prefill_deadline_ms: int = 240_000
    decode_stall_ms: int = 60_000
    # abort and requeue hung active jobs (reason "hang")
    requeue: bool = True
    # on a decode-step hang, a profiler capture of this many seconds
    # through an engine that shares the process; 0 disables
    profile_on_hang_s: float = 0.0

    _BOUNDS = (
        ("interval_ms", "gt", 0), ("queue_deadline_ms", "gt", 0),
        ("dispatch_deadline_ms", "gt", 0), ("prefill_deadline_ms", "gt", 0),
        ("decode_stall_ms", "gt", 0), ("profile_on_hang_s", "ge", 0),
    )

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            if f.type == "int":
                _as_int(self, f.name)
            elif f.type == "float":
                _as_float(self, f.name)
        _check_bounds(self, self._BOUNDS)


@dataclasses.dataclass
class TimelineConfig:
    """The HLC-stamped event publisher every member arms, plus the
    store/collector sizes on members that serve /admin/timeline and
    /admin/incidents."""

    enabled: bool = True
    queue_capacity: int = 2048
    flush_ms: float = 200.0
    batch_max: int = 256
    store_capacity: int = 4096
    store_requests: int = 512
    incident_window_ms: float = 5000.0
    max_incidents: int = 32

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            if f.type == "int":
                _as_int(self, f.name)
            elif f.type == "float":
                _as_float(self, f.name)
        _check_bounds(self, tuple((f.name, "gt", 0) for f in dataclasses.fields(self)
                                  if f.type in ("int", "float")))


@dataclasses.dataclass
class ObsConfig:
    """The JAX package's ObsConfig."""

    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    watchdog: WatchdogConfig = dataclasses.field(default_factory=WatchdogConfig)
    flightrec_capacity: int = 256
    timeline: TimelineConfig = dataclasses.field(default_factory=TimelineConfig)


_RATELIMIT_SCOPES = ("replica", "fleet")


@dataclasses.dataclass
class GatewayConfig:
    """The JAX package's GatewayConfig (same fields and defaults)."""

    host: str = "0.0.0.0"
    port: int = 4000
    max_body_bytes: int = 10 * 1024 * 1024
    rate_limit_window_ms: int = 900_000
    rate_limit_max_requests: int = 100
    rate_limit_enabled: bool = True
    # "replica": per-process fixed-window buckets, so N gateway replicas
    # multiply every limit by N; "fleet": bucket state shared through the
    # bus, so the limit holds fleet-wide
    rate_limit_scope: str = "replica"
    default_request_timeout_ms: int = 300_000
    # Ollama-exact idle residency: unload a model when its keep_alive
    # window passes with no requests; off by default (a reload of a large
    # checkpoint costs minutes), keep_alive is then only the /api/ps expiry
    enforce_keep_alive: bool = False

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            if f.type == "int":
                _as_int(self, f.name)
        if self.rate_limit_scope not in _RATELIMIT_SCOPES:
            raise ValueError(f"GatewayConfig.rate_limit_scope={self.rate_limit_scope!r}: "
                             f"must be one of {_RATELIMIT_SCOPES}")


_CONTROLPLANE_MODES = ("local", "gateway")


@dataclasses.dataclass
class ControlPlaneConfig:
    """The mode of the JAX package's ControlPlaneConfig. Only ``local`` is
    served: the gateway refuses ``gateway`` (the scaled control plane is
    not ported)."""

    mode: str = "local"

    def __post_init__(self) -> None:
        if self.mode not in _CONTROLPLANE_MODES:
            raise ValueError(f"ControlPlaneConfig.mode={self.mode!r}: "
                             f"must be one of {_CONTROLPLANE_MODES}")


@dataclasses.dataclass
class Config:
    env: str = "development"
    bus: BusConfig = dataclasses.field(default_factory=BusConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    gateway: GatewayConfig = dataclasses.field(default_factory=GatewayConfig)
    controlplane: ControlPlaneConfig = dataclasses.field(default_factory=ControlPlaneConfig)
    worker: WorkerConfig = dataclasses.field(default_factory=WorkerConfig)
    engine: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)


def _slo_config_from_env() -> SLOConfig:
    """``GRIDLLM_SLO_CLASSES`` is a JSON object replacing the default class
    table; ``GRIDLLM_SLO_WINDOWS`` is a comma list of window seconds."""
    kw: dict[str, Any] = {"enabled": env_bool("GRIDLLM_SLO_ENABLED")}
    raw = env_raw("GRIDLLM_SLO_CLASSES")
    if raw:
        kw["classes"] = {name: SLOClassConfig.from_dict(spec)
                         for name, spec in json.loads(raw).items()}
    windows = env_raw("GRIDLLM_SLO_WINDOWS")
    if windows:
        kw["windows_s"] = [int(w) for w in windows.split(",") if w]
    return SLOConfig(**kw)


def _deadline_classes_from_env() -> dict[str, int]:
    """GRIDLLM_REQUEST_DEADLINE_CLASSES: JSON {class: deadline_ms}."""
    raw = env_raw("GRIDLLM_REQUEST_DEADLINE_CLASSES")
    if not raw:
        return {}
    return {str(k): int(v) for k, v in json.loads(raw).items()}


def load_config() -> Config:
    """The Config of a worker, scheduler or gateway process from the
    environment; invalid values raise SystemExit."""
    try:
        return Config(
            env=_env("NODE_ENV", env_str("GRIDLLM_ENV")),
            bus=BusConfig(
                url=env_str("GRIDLLM_BUS_URL"),
                key_prefix=_env("REDIS_KEY_PREFIX", "GridLLM:"),
                password=os.environ.get("REDIS_PASSWORD") or None,
                db=_env("REDIS_DB", 0),
                endpoints=[e.strip() for e in env_str("GRIDLLM_BUS_ENDPOINTS").split(",")
                           if e.strip()],
            ),
            scheduler=SchedulerConfig(
                worker_heartbeat_timeout_ms=_env("WORKER_HEARTBEAT_TIMEOUT", 15_000),
                worker_cleanup_interval_ms=_env("WORKER_CLEANUP_INTERVAL", 5_000),
                job_timeout_ms=_env("JOB_TIMEOUT", 600_000),
                retry_attempts=_env("JOB_RETRY_ATTEMPTS", 3),
                retry_delay_ms=_env("JOB_RETRY_DELAY", 5_000),
                max_concurrent_jobs_per_worker=_env("MAX_CONCURRENT_JOBS_PER_WORKER", 1),
                sweep_interval_ms=_env("SCHEDULER_SWEEP_INTERVAL", 1_000),
                prefix_affinity_weight=env_float("GRIDLLM_PREFIX_AFFINITY_WEIGHT"),
                disagg_enabled=env_bool("GRIDLLM_DISAGG"),
                retry_backoff_max_ms=env_int("GRIDLLM_RETRY_BACKOFF_MAX_MS"),
                retry_budget_per_min=env_float("GRIDLLM_RETRY_BUDGET_PER_MIN"),
                request_deadline_ms=env_int("GRIDLLM_REQUEST_DEADLINE_MS"),
                request_deadline_classes=_deadline_classes_from_env(),
                bus_rejoin_grace_ms=env_int("GRIDLLM_BUS_REJOIN_GRACE_MS"),
                preempt_after_ms=env_int("GRIDLLM_PREEMPT_AFTER_MS"),
            ),
            gateway=GatewayConfig(
                host=_env("HOST", "0.0.0.0"),
                port=_env("PORT", 4000),
                rate_limit_window_ms=_env("RATE_LIMIT_WINDOW_MS", 900_000),
                rate_limit_max_requests=_env("RATE_LIMIT_MAX_REQUESTS", 100),
                rate_limit_enabled=_env("RATE_LIMIT_ENABLED", True),
                rate_limit_scope=env_str("GRIDLLM_RATELIMIT_SCOPE"),
                enforce_keep_alive=env_bool("GRIDLLM_ENFORCE_KEEP_ALIVE"),
            ),
            controlplane=ControlPlaneConfig(mode=env_str("GRIDLLM_CONTROLPLANE")),
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
            obs=ObsConfig(
                slo=_slo_config_from_env(),
                watchdog=WatchdogConfig(
                    enabled=env_bool("GRIDLLM_WATCHDOG_ENABLED"),
                    interval_ms=env_int("GRIDLLM_WATCHDOG_INTERVAL"),
                    queue_deadline_ms=env_int("GRIDLLM_WATCHDOG_QUEUE_DEADLINE"),
                    dispatch_deadline_ms=env_int("GRIDLLM_WATCHDOG_DISPATCH_DEADLINE"),
                    prefill_deadline_ms=env_int("GRIDLLM_WATCHDOG_PREFILL_DEADLINE"),
                    decode_stall_ms=env_int("GRIDLLM_WATCHDOG_DECODE_STALL"),
                    requeue=env_bool("GRIDLLM_WATCHDOG_REQUEUE"),
                    profile_on_hang_s=env_float("GRIDLLM_WATCHDOG_PROFILE_S"),
                ),
                flightrec_capacity=env_int("GRIDLLM_FLIGHTREC_CAPACITY"),
                timeline=TimelineConfig(
                    enabled=env_bool("GRIDLLM_TIMELINE"),
                    queue_capacity=env_int("GRIDLLM_TIMELINE_QUEUE"),
                    flush_ms=env_float("GRIDLLM_TIMELINE_FLUSH_MS"),
                    batch_max=env_int("GRIDLLM_TIMELINE_BATCH"),
                    store_capacity=env_int("GRIDLLM_TIMELINE_STORE"),
                    store_requests=env_int("GRIDLLM_TIMELINE_REQUESTS"),
                    incident_window_ms=env_float("GRIDLLM_TIMELINE_INCIDENT_WINDOW_MS"),
                    max_incidents=env_int("GRIDLLM_TIMELINE_INCIDENTS"),
                ),
            ),
        )
    except ValueError as e:
        raise SystemExit(f"Invalid configuration: {e}") from e
