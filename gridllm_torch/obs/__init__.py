"""The worker's share of the observability subsystem (the JAX package's
obs/): metrics.py (instruments and the Prometheus text encoding),
tracer.py (per-request span timelines), flightrec.py (event rings and
post-mortem dumps), usage.py (per-request cost attribution), timeline.py
(the HLC-stamped event publisher) and perf.py (device-memory probes).
SLO, watchdog, health, probe, capacity and forensics belong to the control
plane, which is not ported yet. Pure stdlib apart from perf.py's
function-level torch import.
"""

from gridllm_torch.obs.flightrec import (
    FlightRecorder,
    build_dump,
    default_flight_recorder,
    register_engine_probe,
    unregister_engine_probe,
)
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
from gridllm_torch.obs.timeline import (
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
)
from gridllm_torch.obs.tracer import (
    TRACE_CHANNEL_PREFIX,
    Span,
    Tracer,
    trace_channel,
)
from gridllm_torch.obs.usage import (
    CANARY_TENANT,
    account_engine_usage,
    build_usage,
)

__all__ = [
    "CANARY_TENANT",
    "EDGE_FAMILIES",
    "EVENTS",
    "HLC",
    "LATENCY_BUCKETS",
    "PROMETHEUS_CONTENT_TYPE",
    "SIZE_BUCKETS",
    "Counter",
    "EventSpec",
    "FlightRecorder",
    "Gauge",
    "HLCStamp",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "TRACE_CHANNEL_PREFIX",
    "TimelinePublisher",
    "Tracer",
    "account_engine_usage",
    "build_dump",
    "build_usage",
    "default_clock",
    "default_flight_recorder",
    "default_registry",
    "emit_event",
    "encode_hlc",
    "memory_snapshot",
    "register_engine_probe",
    "register_event",
    "register_memory_probe",
    "render_registries",
    "set_emitter",
    "split_hlc",
    "stamp_key",
    "timeline_armed",
    "timeline_emitter",
    "trace_channel",
    "unregister_engine_probe",
    "unregister_memory_probe",
]
