"""Where the time goes in the engine's main path on one CUDA card.

Serves llama3:8b (bf16, random weights from seed 0) and measures:
- decode, speculative decoding off: with the runner thread serving 8
  greedy streams, tokens/s and wall time per decode step over a steady
  window, then one profiled window of the same serving
  (`InferenceEngine.profile`, CPU and CUDA activity; steps counted as KV
  write kernels, wall as the span of the traced kernels): device busy
  time per step by kernel family, launches per step, and the device's
  idle share (1 - busy / wall);
- single model calls, each profiled the same way: one 1024-token bucket
  prefill, one 1024-token mixed step (chunk after 1024 cached tokens, 8
  decode rows), a decode step of 8 slots at 1024 cached tokens through
  ragged_attention and through paged_decode (a second model over the
  same weights, built with ragged attention off), a verify step
  of K+1 = 5 candidates for 8 slots at 1024 cached tokens in each
  attention mode, and the per-phase model's 1024-token prefill_chunk
  after 1024 cached tokens (prefix_chunk's tensor-core route);
- decode with speculative decoding on (the engine's default), on a fresh
  engine serving the same 8 streams: the same steady and profiled
  windows, per verify step, with the acceptance rate;
- the int8 KV pool (`kv_int8=True`, spec decode off): one decode step of
  8 slots at 1024 cached tokens and one mixed step as above, each one
  profiled call (the int8 leg of ragged_attention; the int8 writes are
  indexed assignments, counted under "other");
- draft-model tree speculation (`draft_model="llama3.2:1b"`, the default
  tree of K = 4 and width 2, N = 6 nodes): one tree verify step of 8 slots
  at 1024 cached tokens, the draft pass (a catch-up chunk and K - 1 draft
  decode steps) and the target's tree verify each profiled as a span, by
  kernel family; the target's ragged launches are the tree leg
  ("ragged_attention.tree");
- long-context admission on llama3.1:8b (512 pages of 64 per slot, the
  32768 bucket): one whole 32768-token bucket prefill (the
  flash_prefill_streamed wrapper; both prefill wrappers launch the kernel
  of csrc/flash_prefill.cu, reported as the "flash_prefill" family), and
  the same prompt admitted in 1024-token chunks (32 mixed steps, the
  default prefill_chunk), each profiled as one window.
`profile_weights` (called by chip_smoke.py's quant and mixtral phases,
not by this module's main) profiles a decode and a verify step of an
int8-weight or mixtral engine.
Prints one JSON line per measurement (the profiler's overhead slows the
profiled decode window; the steady window is measured without it).
Usage: python3 -m gridllm_torch.tools.profile_step
"""

from __future__ import annotations

import gc
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine
from gridllm_torch.models.llama import Llama

FAMILIES = (  # (family, substrings of CUDA kernel names), first match wins
    # csrc/ragged_attention.cu: the chunk region on the tensor cores apart
    # from the groups (and the CUDA-core chunk route)
    ("ragged_attention.chunk", ("ragged_chunk_kernel",)),
    ("ragged_attention", ("ragged_attention_kernel",)),
    # csrc/per_phase_attention.cu: the per-phase entry points of the same
    # bodies (prefix_chunk_kernel: the verify over slots and the CUDA-core
    # chunk; prefix_chunk_wgmma_kernel: the tensor-core chunk)
    ("paged_decode", ("paged_decode_kernel",)),
    ("prefix_chunk", ("prefix_chunk_kernel", "prefix_chunk_wgmma_kernel")),
    # csrc/flash_prefill.cu, launched by both prefill wrappers
    ("flash_prefill", ("prefill_wgmma_kernel", "prefill_split_kernel")),
    ("kv_writes", ("write_decode_kernel", "write_chunk_kernel")),
    ("matmul", ("gemm", "Gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def _family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def _device_breakdown(prof, steps: float | None = None, wall_s: float | None = None,
                      span: str | None = None) -> dict:
    """Device time per step by kernel family from a profiler run; with
    `span`, only the kernels that started inside that record_function
    range (the measured window, not what ran after it). Without `steps`
    and `wall_s` both come from the trace itself: one KV write kernel per
    decode or verify step, and the span from the first kernel's start to
    the last one's end (a capture of a serving runner, whose edges hold
    in-flight blocks that no host count of tokens matches)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    lo, hi = float("-inf"), float("inf")
    if span is not None:   # the range's host event (it also has a device-side copy)
        (rng,) = [e.time_range for e in events if e.name == span and e.device_type == cpu]
        lo, hi = rng.start, rng.end
    fam_us: dict[str, float] = defaultdict(float)
    launches, writes, first, last = 0, 0, float("inf"), float("-inf")
    for evt in events:
        if (evt.device_type == cuda and evt.device_time_total > 0 and evt.name != span
                and lo <= evt.time_range.start <= hi):
            fam_us[_family(evt.name)] += evt.device_time_total
            launches += 1
            writes += "write_decode_kernel" in evt.name
            first, last = min(first, evt.time_range.start), max(last, evt.time_range.end)
    if steps is None:
        steps, wall_s = max(writes, 1), max(last - first, 0.0) / 1e6
    busy_ms = sum(fam_us.values()) / 1e3
    return {
        "steps": steps,
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall_s * 1e3)) if wall_s else None,
        "kernel_launches_per_step": launches / steps,
        "device_ms_per_step_by_family": {k: v / 1e3 / steps for k, v in sorted(fam_us.items())},
    }


def _generated(engine: InferenceEngine) -> int:
    return sum(s["generated"] for s in engine.batch_state()["slots"].values())


def profile_decode(engine: InferenceEngine, n_slots: int) -> list[dict]:
    spec = engine.batch_state()["specDecode"] is not None
    label = "decode_spec" if spec else "decode"
    prompt = "the quick brown fox jumps over the lazy dog " * 11   # ~500 tokens
    for i in range(n_slots):
        engine.submit(GenerationRequest(
            id=f"d{i}", prompt=prompt + str(i),
            options={"temperature": 0.0, "num_predict": 4000}))
    engine.start()
    deadline = time.time() + 300
    while _generated(engine) < 16 * n_slots and time.time() < deadline:
        time.sleep(0.05)

    def window(seconds: float) -> tuple[int, float, float, dict]:
        """(tokens, steps, wall s, spec totals) over `seconds` of serving
        by the runner thread."""
        s0, t0 = dict(engine.spec_stats), time.perf_counter()
        g0 = _generated(engine)
        time.sleep(seconds)
        g1, t1, s1 = _generated(engine), time.perf_counter(), dict(engine.spec_stats)
        delta = {k: s1[k] - s0[k] for k in s1}
        steps = delta["steps"] if spec else (g1 - g0) / n_slots
        return g1 - g0, max(steps, 1), t1 - t0, delta

    tokens, steps, wall, delta = window(3.0)
    steady = {"measure": f"{label}_steady", "slots": n_slots, "tokens": tokens,
              "wall_s": wall, "tokens_per_s": tokens / wall,
              "wall_ms_per_step": wall * 1e3 / steps}
    if spec:
        steady.update(verify_steps=delta["steps"],
                      acceptance=delta["accepted"] / max(delta["proposed"], 1),
                      tokens_per_verify_step=delta["emitted"] / max(delta["steps"], 1))
    # the runner keeps serving: the engine starts and stops the capture on
    # the runner thread between two steps; steps and wall come from the
    # capture's own kernels
    with engine.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(1.5)
    engine.stop()
    engine.abort_all("profile done")
    traced = {"measure": f"{label}_profiled", "slots": n_slots, **_device_breakdown(prof)}
    return [steady, traced]


class _Steps:
    """Single model calls of an engine at the main path's shapes: slot 0
    admits a 1024-token chunk (pages 0..127), slots 1.. hold 1024 cached
    tokens each. With `pages` < 128 each slot's table maps that many pages
    (the rest -1), for a pool too small for 128 a slot: enough for decode
    and verify steps at 1024 cached tokens, not for the chunk."""

    def __init__(self, engine: InferenceEngine, pages: int = 128):
        self.model, self.cache, self.c = engine.model, engine.cache, 1024
        dev, s = engine.device, self.cache.max_slots
        self.tokens = torch.randint(0, 32_000, (self.c,), device=dev, dtype=torch.int32)
        self.row = torch.arange(128, device=dev, dtype=torch.int32)
        self.active = torch.zeros(s, dtype=torch.bool, device=dev)
        self.active[1:] = True
        self.cache.page_table.fill_(-1)
        self.cache.page_table[:, :pages] = torch.arange(
            pages * s, device=dev, dtype=torch.int32).reshape(s, pages)
        self.cache.lengths[1:] = 1024
        self.step_tokens = torch.zeros(s, dtype=torch.int32, device=dev)
        self.cand = torch.randint(0, 32_000, (s, engine.config.spec_k + 1), device=dev,
                                  dtype=torch.int32)
        self.all_active = torch.ones(s, dtype=torch.bool, device=dev)

    def at_1024(self, fn):
        """fn with every slot at 1024 cached tokens (lengths reset first)."""
        def run():
            self.cache.lengths.fill_(1024)
            fn()
        return run

    def prefill(self):
        self.model.prefill(self.tokens, self.c, self.cache, 0, self.row)

    def mixed(self):
        self.model.mixed_step(self.tokens, 1024, self.c, 0, self.row, self.step_tokens,
                              self.cache, self.active)


def _profile_calls(calls) -> list[dict]:
    """Each (name, fn): one warm-up call, then one profiled call."""
    out = []
    for name, fn in calls:
        fn()                      # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out.append({"measure": name, **_device_breakdown(prof, 1, wall)})
    return out


def profile_steps(engine: InferenceEngine) -> list[dict]:
    st = _Steps(engine)
    model, cache = st.model, st.cache
    per_phase = Llama(engine.cfg, dtype=engine.dtype, device=engine.device,
                      ragged_attention=False)
    per_phase.load_state_dict(model.state_dict())
    return _profile_calls((
        ("prefill_bucket_1024", st.prefill),
        ("mixed_step_1024_after_1024", st.mixed),
        ("decode_step_ragged_8x1024", st.at_1024(lambda: model.decode_step(
            st.step_tokens, cache, st.all_active))),
        ("decode_step_per_phase_8x1024", st.at_1024(lambda: per_phase.decode_step(
            st.step_tokens, cache, st.all_active))),
        ("verify_step_ragged_8x5_after_1024", st.at_1024(lambda: model.verify_step(
            st.cand, cache, st.all_active))),
        ("verify_step_per_phase_8x5_after_1024", st.at_1024(lambda: per_phase.verify_step(
            st.cand, cache, st.all_active))),
        ("prefill_chunk_per_phase_1024_after_1024", st.at_1024(lambda: per_phase.prefill_chunk(
            st.tokens, 1024, st.c, cache, 0, st.row))),
    ))


def profile_int8(engine: InferenceEngine) -> list[dict]:
    """An int8-pool engine's decode step (8 slots at 1024 cached tokens)
    and mixed step (1024-row chunk after 1024 cached, 8 decode rows)."""
    st = _Steps(engine)
    return [{**rec, "kv_int8": True} for rec in _profile_calls((
        ("decode_step_int8_8x1024", st.at_1024(lambda: st.model.decode_step(
            st.step_tokens, st.cache, st.all_active))),
        ("mixed_step_int8_1024_after_1024", st.mixed),
    ))]


def profile_weights(engine: InferenceEngine) -> list[dict]:
    """A decode step (8 slots at 1024 cached tokens) and a verify step
    (8 x K+1 = 5 after 1024) of an engine whose weights are the cost: an
    int8-weight engine (the plain qdot) or a mixtral engine (the decode
    step's MoE in the dense form, the verify step's 40 rows in the ragged
    form on CUDA). Each slot's table maps 17 pages, so the pool needs
    17 x max_slots."""
    st = _Steps(engine, pages=17)
    return [{**rec, "model": engine.cfg.name, "quantize": engine.config.quantize}
            for rec in _profile_calls((
                ("decode_step_8x1024", st.at_1024(lambda: st.model.decode_step(
                    st.step_tokens, st.cache, st.all_active))),
                ("verify_step_8x5_after_1024", st.at_1024(lambda: st.model.verify_step(
                    st.cand, st.cache, st.all_active))),
            ))]


def profile_tree(engine: InferenceEngine) -> list[dict]:
    """One tree verify step of a draft-model engine: every slot at 1024
    cached tokens in the target's pool and in the draft's, one new token
    per slot to catch up (an accepted draft and its correction), then the
    draft pass and the target's tree verify, each its own profiled span
    (the draft pass ends in its host fetch; the verify span synchronizes)."""
    st = _Steps(engine)
    drafter, dev = engine._drafter, engine.device
    k, width = engine.config.spec_k, engine.config.spec_tree_width
    n, s = len(engine._tree[0]), engine.config.max_slots
    engine.active.fill_(True)
    engine.sampling.temperature.zero_()
    ids = {slot: torch.randint(0, 32_000, (1024,)).tolist() for slot in range(s)}
    drafter.draft_batch(ids, k, width)   # the draft pool catches up on 1024 tokens

    def step():
        props = drafter.draft_batch(ids, k, width)
        drafts = torch.zeros((s, n - 1), dtype=torch.int32)
        for slot, (chain, alts) in props.items():
            drafts[slot] = torch.tensor(chain + alts, dtype=torch.int32)
            ids[slot] += [chain[0], (chain[1] + 1) % 32_000]   # one accepted, one correction
        return drafts.to(dev), torch.ones((s, n), dtype=torch.bool, device=dev)

    def verify(drafts, valid):
        st.cache.lengths.fill_(1024)
        engine._verify_tree_block(drafts, valid)
        torch.cuda.synchronize()

    verify(*step())   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("draft"):
            drafts, valid = step()
        t1 = time.perf_counter()
        with record_function("target"):
            verify(drafts, valid)
        t2 = time.perf_counter()
    draft = _device_breakdown(prof, 1, t1 - t0, span="draft")
    target = _device_breakdown(prof, 1, t2 - t1, span="target")
    fams = target["device_ms_per_step_by_family"]
    fams["ragged_attention.tree"] = fams.pop("ragged_attention", 0.0)
    return [{"measure": f"tree_verify_step_{s}x{n}_after_1024", "draft_model": "llama3.2:1b",
             "tree": f"k={k} width={width}", "wall_ms": (t2 - t0) * 1e3,
             "device_busy_ms": draft["device_busy_ms_per_step"]
             + target["device_busy_ms_per_step"],
             "draft": draft, "target": target}]


def profile_long() -> list[dict]:
    """A 32768-token prompt admitted whole (the 32768 bucket) and in
    1024-token chunks (mixed steps beside 8 idle decode rows, as the engine
    admits a prompt longer than the default prefill_chunk)."""
    engine = InferenceEngine(EngineConfig(
        model="llama3.1:8b", page_size=64, max_pages_per_slot=512, num_pages=1280,
        prefill_buckets=(64, 256, 1024, 4096, 32768), prefill_chunk=32768,
        spec_decode=False), device="cuda")
    model, cache, dev = engine.model, engine.cache, engine.device
    t, c, s = 32768, 1024, cache.max_slots
    tokens = torch.randint(0, 32_000, (t,), device=dev, dtype=torch.int32)
    row = torch.arange(t // 64, device=dev, dtype=torch.int32)   # pages 0..511 for slot 0
    idle = torch.zeros(s, dtype=torch.int32, device=dev)
    inactive = torch.zeros(s, dtype=torch.bool, device=dev)

    def chunks(n: int):
        for start in range(0, n * c, c):
            model.mixed_step(tokens[start:start + c], start, c, 0, row, idle, cache, inactive)

    out = []
    for name, fn, warm in (
        ("prefill_bucket_32768_llama3.1", lambda: model.prefill(tokens, t, cache, 0, row),
         lambda: model.prefill(tokens, t, cache, 0, row)),
        ("prefill_32768_in_1024_chunks_llama3.1", lambda: chunks(t // c), lambda: chunks(1)),
    ):
        warm()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out.append({"measure": name, "model": "llama3.1:8b", **_device_breakdown(prof, 1, wall)})
    return out


def main() -> None:
    dev = {"device": torch.cuda.get_device_name(0), "model": "llama3:8b", "dtype": "bfloat16"}

    def emit(recs: list[dict]) -> None:
        for rec in recs:
            print(json.dumps({**dev, **rec}), flush=True)

    engine = InferenceEngine(EngineConfig(model="llama3:8b", spec_decode=False), device="cuda")
    emit(profile_decode(engine, engine.config.max_slots))
    emit(profile_steps(engine))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(model="llama3:8b"), device="cuda")
    emit(profile_decode(engine, engine.config.max_slots))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(model="llama3:8b", draft_model="llama3.2:1b"),
                             device="cuda")
    emit(profile_tree(engine))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = InferenceEngine(EngineConfig(model="llama3:8b", spec_decode=False, kv_int8=True),
                             device="cuda")
    emit(profile_int8(engine))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    emit(profile_long())


if __name__ == "__main__":
    main()
