"""Where the time goes in the engine's main path on one CUDA card.

Serves llama3:8b (bf16, random weights from seed 0, default engine config)
and measures, with the runner thread serving 8 greedy streams:
- decode: tokens/s and wall time per decode step over a steady window,
  then one profiled window (torch.profiler, CUDA activity): device busy
  time per step by kernel family, launches per step, and the device's
  idle share (1 - busy / wall);
- prefill: one 1024-token bucket prefill and one 1024-token mixed step
  (chunk after 1024 cached tokens, 8 decode rows), each profiled the same
  way.
Prints one JSON line per measurement (the profiler's overhead slows the
profiled decode window; the steady window is measured without it).
Usage: python3 -m gridllm_torch.tools.profile_step
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine

FAMILIES = (  # (family, substrings of CUDA kernel names), first match wins
    ("ragged_attention", ("ragged_attention_kernel",)),
    ("flash_prefill", ("flash_prefill_kernel",)),
    ("kv_writes", ("write_decode_kernel", "write_chunk_kernel")),
    ("matmul", ("gemm", "Gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def _family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def _device_breakdown(prof, steps: int, wall_s: float) -> dict:
    """Device time per step by kernel family from a profiler run."""
    fam_us: dict[str, float] = defaultdict(float)
    launches = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.device_time_total > 0:
            fam_us[_family(evt.name)] += evt.device_time_total
            launches += 1
    busy_ms = sum(fam_us.values()) / 1e3
    return {
        "steps": steps,
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall_s * 1e3)),
        "kernel_launches_per_step": launches / steps,
        "device_ms_per_step_by_family": {k: v / 1e3 / steps for k, v in sorted(fam_us.items())},
    }


def _generated(engine: InferenceEngine) -> int:
    return sum(s["generated"] for s in engine.batch_state()["slots"].values())


def profile_decode(engine: InferenceEngine, n_slots: int) -> list[dict]:
    prompt = "the quick brown fox jumps over the lazy dog " * 11   # ~500 tokens
    for i in range(n_slots):
        engine.submit(GenerationRequest(
            id=f"d{i}", prompt=prompt + str(i),
            options={"temperature": 0.0, "num_predict": 4000}))
    engine.start()
    deadline = time.time() + 300
    while _generated(engine) < 16 * n_slots and time.time() < deadline:
        time.sleep(0.05)
    t0, g0 = time.perf_counter(), _generated(engine)
    time.sleep(3.0)
    t1, g1 = time.perf_counter(), _generated(engine)
    steps = (g1 - g0) / n_slots
    steady = {"measure": "decode_steady", "slots": n_slots, "tokens": g1 - g0,
              "wall_s": t1 - t0, "tokens_per_s": (g1 - g0) / (t1 - t0),
              "wall_ms_per_step": (t1 - t0) * 1e3 / steps}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g0, t0 = _generated(engine), time.perf_counter()
        time.sleep(1.5)
        g1, t1 = _generated(engine), time.perf_counter()
    engine.stop()
    engine.abort_all("profile done")
    traced = {"measure": "decode_profiled", "slots": n_slots,
              **_device_breakdown(prof, max((g1 - g0) / n_slots, 1), t1 - t0)}
    return [steady, traced]


def profile_prefill(engine: InferenceEngine) -> list[dict]:
    model, cache, c = engine.model, engine.cache, 1024
    dev = engine.device
    tokens = torch.randint(0, 32_000, (c,), device=dev, dtype=torch.int32)
    row = torch.arange(128, device=dev, dtype=torch.int32)   # pages 0..127 for slot 0
    active = torch.zeros(cache.max_slots, dtype=torch.bool, device=dev)
    active[1:] = True
    cache.page_table[1:] = torch.arange(128, 128 * cache.max_slots, device=dev,
                                        dtype=torch.int32).reshape(-1, 128)
    cache.lengths[1:] = 1024
    step_tokens = torch.zeros(cache.max_slots, dtype=torch.int32, device=dev)
    out = []
    for name, fn in (
        ("prefill_bucket_1024", lambda: model.prefill(tokens, c, cache, 0, row)),
        ("mixed_step_1024_after_1024",
         lambda: model.mixed_step(tokens, 1024, c, 0, row, step_tokens, cache, active)),
    ):
        fn()                      # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out.append({"measure": name, **_device_breakdown(prof, 1, wall)})
    return out


def main() -> None:
    engine = InferenceEngine(EngineConfig(model="llama3:8b"), device="cuda")
    dev = {"device": torch.cuda.get_device_name(0), "model": "llama3:8b", "dtype": "bfloat16"}
    for rec in profile_decode(engine, engine.config.max_slots) + profile_prefill(engine):
        print(json.dumps({**dev, **rec}), flush=True)


if __name__ == "__main__":
    main()
