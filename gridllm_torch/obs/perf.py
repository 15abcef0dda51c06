"""Device-memory accounting and the step-time series of a torch worker (the
JAX package's obs/perf.py, less its jit recompile tripwire).

Worker services register a memory probe (one per service) returning, per
model, the weight and KV tensors plus the page allocator's numbers
(`InferenceEngine.memory_arrays`). `memory_snapshot` adds them up per
model and reads each CUDA device's allocator through
`torch.cuda.memory_stats` and `torch.cuda.mem_get_info`, where the JAX
package walks `jax.live_arrays()`. A registry collector turns it into the
`gridllm_device_memory_*` gauges at scrape time: bytes by kind (weights,
kv_pool, workspace) on every device, the headroom and limit only on CUDA
devices (on the CPU they are left out, as the JAX package leaves them out
on backends without allocator statistics).

The step-time histograms (host scheduling, dispatch, on-device step) are
registered here and driven by the engine's runner loop. The JAX package's
`gridllm_recompiles_total` and `gridllm_recompile_storms_total` are not
defined: they count XLA compiles of jitted programs, and this package runs
eager PyTorch with kernels built once, so there is nothing to count.
The profiler half is `InferenceEngine.profile()`: `capture_profile`
takes a capture through it, for the worker's POST /admin/profile and for a
scheduler's hang watchdog in a process that hosts an engine (its
`capture` callable). The gateway's POST /admin/profile
(`handle_profile_request`) refuses and points to the worker's.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from gridllm_torch.obs.metrics import default_registry
from gridllm_torch.utils.types import iso_now

_OBS = default_registry()

# -- step-time decomposition (the engine's runner drives these) -------------
STEP_PHASE_BUCKETS = (
    0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0,
)
HOST_SCHED_SECONDS = _OBS.histogram(
    "gridllm_engine_host_sched_seconds",
    "Host-side gap between finishing one decode block's ingest and "
    "dispatching the next (admission, tokenize, stream callbacks, control "
    "drain), AMORTIZED PER FUSED STEP so it compares 1:1 with "
    "gridllm_engine_device_step_seconds, by model. Growth here is a host "
    "stall, not a device problem.",
    ("model",), buckets=STEP_PHASE_BUCKETS,
)
DISPATCH_SECONDS = _OBS.histogram(
    "gridllm_engine_dispatch_seconds",
    "Wall time for a fused decode block's jitted call to RETURN (trace + "
    "lower + enqueue; the device keeps computing after). A spike here "
    "usually means a recompile — pair with gridllm_recompiles_total.",
    ("model",), buckets=STEP_PHASE_BUCKETS,
)
DEVICE_STEP_SECONDS = _OBS.histogram(
    "gridllm_engine_device_step_seconds",
    "Estimated on-device time per fused decode step, by model. With the "
    "dispatch pipeline saturated this is the delta between consecutive "
    "block fetch completions (device-bound pace); otherwise dispatch-to-"
    "fetch wall time (upper bound including queue wait).",
    ("model",), buckets=STEP_PHASE_BUCKETS,
)

# -- device-memory gauges ----------------------------------------------------
DEVICE_MEMORY_BYTES = _OBS.gauge(
    "gridllm_device_memory_bytes",
    "Live device memory by kind: weights (model params), kv_pool (paged "
    "KV cache + tables), workspace (all other live arrays — activations, "
    "sampler state, staging buffers). Classified per jax.live_arrays() "
    "against engine memory probes at scrape time.",
    ("device", "kind"),
)
DEVICE_MEMORY_HEADROOM = _OBS.gauge(
    "gridllm_device_memory_headroom_bytes",
    "Allocator-reported free device memory (bytes_limit - bytes_in_use); "
    "only present on backends exposing memory_stats (TPU/GPU).",
    ("device",),
)
DEVICE_MEMORY_LIMIT = _OBS.gauge(
    "gridllm_device_memory_limit_bytes",
    "Allocator-reported device memory limit; only present on backends "
    "exposing memory_stats (TPU/GPU).",
    ("device",),
)

_memory_probes: dict[str, Callable[[], dict[str, Any]]] = {}
_memory_probes_lock = threading.Lock()


def register_memory_probe(name: str, fn: Callable[[], dict[str, Any]]) -> None:
    with _memory_probes_lock:
        _memory_probes[name] = fn


def unregister_memory_probe(name: str) -> None:
    with _memory_probes_lock:
        _memory_probes.pop(name, None)


def _nbytes(t: Any) -> int:
    return int(t.numel() * t.element_size()) if hasattr(t, "element_size") else 0


def memory_snapshot() -> dict[str, Any]:
    """Point-in-time memory breakdown: per model, the weight and KV-pool
    bytes and the allocator's page accounting; per CUDA device, the bytes
    the caching allocator holds (weights, KV pool, and the rest as
    workspace), its peak and the device's free memory.

    Only a process that already initialized CUDA reads the devices; one
    that never imported torch (a gateway replica or a scheduler shard)
    gets an empty snapshot with a note, as the JAX package's does without
    jax. Importing torch and creating a CUDA context there would stall the
    scrape's event loop for seconds, past a shard's lease TTL."""
    import sys

    if "torch" not in sys.modules:
        return {"generatedAt": time.time(), "devices": {}, "models": {},
                "note": "torch not initialized in this process — query the "
                        "worker health port for the engine-side view"}
    with _memory_probes_lock:
        probes = dict(_memory_probes)
    models: dict[str, Any] = {}
    by_device: dict[str, dict[str, int]] = {}
    for probe_name, fn in probes.items():
        try:
            for model, info in fn().items():
                entry = dict(info.get("alloc") or {})
                for key, kind in (("weights", "weightsBytes"), ("kv", "kvPoolBytes")):
                    tensors = info.get(key) or []
                    entry[kind] = sum(_nbytes(t) for t in tensors)
                    for t in tensors:
                        dev = str(getattr(t, "device", "cpu"))
                        d = by_device.setdefault(dev, {"weightsBytes": 0, "kvPoolBytes": 0})
                        d[kind] += _nbytes(t)
                entry["probe"] = probe_name
                models[model] = entry
        except Exception as e:  # noqa: BLE001 — snapshots must assemble
            models[f"{probe_name}:error"] = {"error": str(e)}

    import torch

    devices: dict[str, dict[str, Any]] = {}
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            label = f"cuda:{i}"
            stats = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
            owned = by_device.get(label, {"weightsBytes": 0, "kvPoolBytes": 0})
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            devices[label] = {
                **owned,
                "workspaceBytes": max(in_use - sum(owned.values()), 0),
                "bytesInUse": in_use,
                "bytesReserved": int(stats.get("reserved_bytes.all.current", 0)),
                "peakBytesInUse": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytesLimit": int(total),
                "headroomBytes": int(free),
            }
    for label, owned in by_device.items():
        devices.setdefault(label, {**owned, "bytesInUse": None, "bytesLimit": None,
                                   "headroomBytes": None})
    return {"generatedAt": time.time(), "devices": devices, "models": models}


def _memory_collector() -> None:
    """Registry collector: refresh the device-memory gauges from a fresh
    snapshot at scrape time. Headroom and limit come from
    torch.cuda.mem_get_info, so only CUDA devices carry them."""
    snap = memory_snapshot()
    for label, entry in snap["devices"].items():
        for kind, key in (("weights", "weightsBytes"), ("kv_pool", "kvPoolBytes"),
                          ("workspace", "workspaceBytes")):
            DEVICE_MEMORY_BYTES.set(entry.get(key) or 0, device=label, kind=kind)
        if entry.get("headroomBytes") is not None:
            DEVICE_MEMORY_HEADROOM.set(entry["headroomBytes"], device=label)
        if entry.get("bytesLimit"):
            DEVICE_MEMORY_LIMIT.set(entry["bytesLimit"], device=label)


_OBS.add_collector("perf.device_memory", _memory_collector)


def capture_profile(engine: Any, seconds: float, reason: str,
                    start_timeout_s: float | None = None) -> dict[str, Any]:
    """A torch.profiler capture of `seconds` while `engine` serves, taken
    through `InferenceEngine.profile()` (started and stopped between the
    runner's steps): the kernels with the most device time. Raises
    RuntimeError while another capture is active, and TimeoutError when it
    cannot start within `start_timeout_s` (None: no limit)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    started = iso_now()
    with engine.profile(start_timeout_s=start_timeout_s, activities=activities) as prof:
        time.sleep(seconds)
    rows = sorted(prof.key_averages(),
                  key=lambda e: getattr(e, "device_time_total", 0.0), reverse=True)
    return {
        "seconds": seconds, "reason": reason, "startedAt": started,
        "model": engine.cfg.name,
        "top": [{"name": e.key, "count": e.count,
                 "deviceUs": getattr(e, "device_time_total", 0.0),
                 "cpuUs": e.cpu_time_total} for e in rows[:20]],
    }


def handle_profile_request() -> tuple[int, dict[str, Any]]:
    """The gateway's ``POST /admin/profile?seconds=N``: (http_status,
    json_payload). A capture runs through an engine (`capture_profile`), and
    a gateway process holds none, so it refuses with 501 and names the
    worker health port, whose route (worker/main.py) takes the capture: the
    JAX gateway's answer in a process without a device runtime."""
    return 501, {"error": "no engine in this process — POST the worker health "
                          "port's /admin/profile for an engine-side capture",
                 "code": "NO_ENGINE"}
