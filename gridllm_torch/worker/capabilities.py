"""Worker capability gathering (the JAX package's worker/capabilities.py).

The record a worker registers with: system resources, the models it
serves with their shard layouts, and the accelerator topology, found
through `torch.cuda` (the record keeps the JAX package's `TpuTopology`
name, which the scheduler reads; a GPU worker reports platform "gpu").
"""

from __future__ import annotations

import hashlib
import json
import os
import platform

from gridllm_torch.utils.types import (
    ModelInfo,
    ModelShardLayout,
    NodeCapabilities,
    SystemResources,
    TpuTopology,
    iso_now,
)


def _meminfo_mb() -> tuple[float, float]:
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                fields[k] = float(v.strip().split()[0]) / 1024.0
        return fields.get("MemTotal", 0.0), fields.get("MemAvailable", 0.0)
    except OSError:  # non-linux
        return 0.0, 0.0


def system_resources() -> SystemResources:
    total, avail = _meminfo_mb()
    try:
        load1 = os.getloadavg()[0]
        cores = os.cpu_count() or 1
        cpu_pct = min(100.0, 100.0 * load1 / cores)
    except OSError:
        cpu_pct = 0.0
    return SystemResources(
        cpuCores=os.cpu_count() or 1,
        totalMemoryMB=total,
        availableMemoryMB=avail,
        cpuUsagePercent=round(cpu_pct, 1),
        memoryUsagePercent=round(100.0 * (1 - avail / total), 1) if total else 0.0,
        platform=platform.system().lower(),
        architecture=platform.machine(),
    )


def device_topology() -> TpuTopology:
    """The CUDA devices of this process, or the CPU when it has none."""
    import torch

    if not torch.cuda.is_available():
        return TpuTopology(platform="cpu", numDevices=1, numHosts=1, deviceKind="cpu")
    n = torch.cuda.device_count()
    kinds = {torch.cuda.get_device_name(i) for i in range(n)}
    return TpuTopology(platform="gpu", numDevices=n, numHosts=1,
                       deviceKind=", ".join(sorted(kinds)))


def _param_count_estimate(mc) -> int:
    """Decoder param count from the config dims (embed + L×(attn+ffn))."""
    try:
        e, f, v = mc.hidden_size, mc.intermediate_size, mc.vocab_size
        h, kvh, d, L = mc.num_heads, mc.num_kv_heads, mc.head_dim_, mc.num_layers
        attn = e * h * d + 2 * e * kvh * d + h * d * e
        ffn = 3 * e * f
        if getattr(mc, "num_experts", 0):
            ffn *= mc.num_experts
        head = 0 if mc.tie_embeddings else e * v
        return v * e + L * (attn + ffn) + head
    except AttributeError:
        return 0


def _human_params(n: int) -> str:
    if n <= 0:
        return "Unknown"
    if n >= 1e9:
        return f"{n / 1e9:.1f}B"
    return f"{n / 1e6:.0f}M"


def total_slots(engines: dict) -> int:
    """Total concurrent slots across UNIQUE engines — /api/copy aliases
    the same engine under a second name, and counting it per name would
    over-advertise capacity (the scheduler would over-assign; jobs queue
    inside the engine instead of being NACKed to other workers). Single
    source of truth for both the worker's admission gate
    (worker/service.py) and the advertised maxConcurrentTasks here."""
    uniq = {id(e): e for e in engines.values()}
    return max(
        sum(getattr(getattr(e, "config", None), "max_slots", 1)
            for e in uniq.values()),
        1,
    )


def gather_capabilities(
    worker_id: str,
    engines: dict[str, object],
    performance_tier: str | None = None,
) -> NodeCapabilities:
    topo = device_topology()
    if performance_tier is None:
        performance_tier = "high" if topo.platform == "gpu" else "medium"
    models, layouts = [], []
    max_slots = total_slots(engines)
    for name, eng in engines.items():
        c = getattr(eng, "config", None)
        mc = getattr(eng, "cfg", None)
        details = None
        if mc is not None:
            family = getattr(mc, "family", "unknown")
            families = [family]
            if getattr(mc, "vision", False):
                families.append("clip")  # Ollama marks vision via families
            n_params = _param_count_estimate(mc)
            details = {
                "parent_model": "", "format": "safetensors",
                "family": family, "families": families,
                "parameter_size": _human_params(n_params),
                "quantization_level": (
                    "Q8_0" if getattr(c, "quantize", None) == "int8"
                    else str(getattr(c, "dtype", "bfloat16")).upper()
                ),
                "vision": bool(getattr(mc, "vision", False)),
                # the canary prober keys its golden output hash on (model,
                # engineConfigHash): two workers share a golden only when
                # every knob that can change sampled bytes matches. The
                # platform and the runtime are among them — the port's
                # sampler noise is not the JAX package's — so torch
                # workers seal goldens of their own.
                "engineConfigHash": hashlib.sha256(json.dumps({
                    "model": name,
                    "family": family,
                    "dtype": str(getattr(c, "dtype", "bfloat16")),
                    "quantize": getattr(c, "quantize", None),
                    "platform": topo.platform,
                    "runtime": "torch",
                }, sort_keys=True).encode()).hexdigest()[:16],
            }
        models.append(ModelInfo(name=name, model=name, details=details))
        # the JAX worker's layout of a meshed engine (tp only is ported)
        mesh = getattr(eng, "mesh", None)
        tp = mesh is not None and mesh.shape.get("tp", 1) > 1
        layouts.append(ModelShardLayout(
            name=name,
            strategy="tensor" if tp else "replicated",
            meshAxes=dict(mesh.shape) if mesh is not None else {},
            dtype=str(getattr(c, "dtype", "bfloat16")),
            maxSeqLen=getattr(eng, "max_context", 8192),
            maxBatchSlots=getattr(c, "max_slots", 1),
        ))
    return NodeCapabilities(
        workerId=worker_id,
        availableModels=models,
        systemResources=system_resources(),
        performanceTier=performance_tier,  # type: ignore[arg-type]
        maxConcurrentTasks=max(max_slots, 1),
        supportedFormats=["json"],
        lastUpdated=iso_now(),
        topology=topo,
        shardLayouts=layouts,
    )
