"""Device-memory accounting of a torch worker (the memory-probe half of the
JAX package's obs/perf.py).

Worker services register a memory probe (one per service) returning, per
model, the weight and KV tensors plus the page allocator's numbers
(`InferenceEngine.memory_arrays`). `memory_snapshot` adds them up per
model and reads each CUDA device's allocator through
`torch.cuda.memory_stats`, where the JAX package walks `jax.live_arrays()`.
The profiler half is `InferenceEngine.profile()` (see worker/main.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

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
    workspace), its peak and the device's free memory."""
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
    if torch.cuda.is_available():
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
