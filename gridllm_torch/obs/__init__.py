"""The observability subsystem (the JAX package's obs/).

Raw telemetry: metrics.py (instruments and the Prometheus text
encoding), tracer.py (per-request span timelines), flightrec.py (event
rings and post-mortem dumps), timeline.py (the HLC-stamped event
publisher and the critical-path decomposition) and perf.py (device-memory
probes and the in-process profiler capture).
What the scheduler builds on them: slo.py (per-class objectives,
attainment, burn rates, goodput), watchdog.py (per-phase hang detection),
usage.py (both halves of the per-tenant usage ledger), capacity.py
(per-model demand rates, headroom and scale hints), probe.py (the
golden-hash canary prober) and health.py (per-worker regression baselines
and the degraded/quarantined/probation state machine).
The gateway's forensics and the timeline store arrive with the gateway.
Pure stdlib apart from perf.py's function-level torch import.
"""

from gridllm_torch.obs.capacity import (
    DemandTracker,
    aggregate_worker_capacity,
    dedup_capacity_totals,
    merge_capacity,
)
from gridllm_torch.obs.flightrec import (
    FlightRecorder,
    build_dump,
    default_flight_recorder,
    register_engine_probe,
    unregister_engine_probe,
)
from gridllm_torch.obs.health import HEALTH_STATES, STATE_CODES, HealthMonitor
from gridllm_torch.obs.metrics import (
    LATENCY_BUCKETS,
    PROMETHEUS_CONTENT_TYPE,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    render_registries,
)
from gridllm_torch.obs.perf import (
    memory_snapshot,
    register_memory_probe,
    unregister_memory_probe,
)
from gridllm_torch.obs.probe import CanaryProber
from gridllm_torch.obs.slo import SLOEngine, classify_request
from gridllm_torch.obs.timeline import (
    CRITICAL_PATH_SEGMENTS,
    EDGE_FAMILIES,
    EVENTS,
    HLC,
    EventSpec,
    HLCStamp,
    TimelinePublisher,
    default_clock,
    emit_event,
    encode_hlc,
    register_event,
    set_emitter,
    split_hlc,
    stamp_key,
    timeline_armed,
    timeline_emitter,
    critical_path,
)
from gridllm_torch.obs.tracer import (
    TRACE_CHANNEL_PREFIX,
    Span,
    Tracer,
    trace_channel,
    trace_pattern,
)
from gridllm_torch.obs.usage import (
    CANARY_TENANT,
    TenantLRU,
    UsageAccountant,
    account_engine_usage,
    build_usage,
    engine_usage_totals,
    resolve_tenant,
)
from gridllm_torch.obs.watchdog import HangWatchdog

__all__ = [
    "CANARY_TENANT",
    "CRITICAL_PATH_SEGMENTS",
    "CanaryProber",
    "Counter",
    "DemandTracker",
    "EDGE_FAMILIES",
    "EVENTS",
    "EventSpec",
    "FlightRecorder",
    "Gauge",
    "HEALTH_STATES",
    "HLC",
    "HLCStamp",
    "HangWatchdog",
    "HealthMonitor",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "PROMETHEUS_CONTENT_TYPE",
    "SIZE_BUCKETS",
    "SLOEngine",
    "STATE_CODES",
    "Span",
    "TRACE_CHANNEL_PREFIX",
    "TenantLRU",
    "TimelinePublisher",
    "Tracer",
    "UsageAccountant",
    "account_engine_usage",
    "aggregate_worker_capacity",
    "build_dump",
    "build_usage",
    "classify_request",
    "critical_path",
    "dedup_capacity_totals",
    "default_clock",
    "default_flight_recorder",
    "default_registry",
    "emit_event",
    "encode_hlc",
    "engine_usage_totals",
    "memory_snapshot",
    "merge_capacity",
    "register_engine_probe",
    "register_event",
    "register_memory_probe",
    "render_registries",
    "resolve_tenant",
    "set_emitter",
    "split_hlc",
    "stamp_key",
    "timeline_armed",
    "timeline_emitter",
    "trace_channel",
    "trace_pattern",
    "unregister_engine_probe",
    "unregister_memory_probe",
]
