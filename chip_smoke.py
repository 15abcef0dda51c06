#!/usr/bin/env python3
"""Smoke run of gridllm_torch on one NVIDIA GPU (H100).

Phases, each printing one JSON line; any failure exits non-zero:
1. build   — compile the CUDA kernels of gridllm_torch/csrc/ with nvcc.
2. kernels — hold each kernel against its plain PyTorch version on the
             card at llama3:8b widths, bf16 (tolerance 3e-2) and float32
             (1e-3); the KV writes must match exactly on the valid region.
3. timing  — each kernel at the main path's shapes (CUDA events, warm-up):
             kernel, plain version, one PyTorch library call where one
             exists, and the bound max(bytes / 3.35 TB/s, flops / 989
             TFLOP/s) computed from this run's inputs.
4. model   — llama3:8b cut to 2 layers, full width, float32: the paged
             path through all four kernels (bucket prefill, decode steps,
             a mixed step admitting a second slot in two chunks) against
             the cache-free forward, to 1e-3.
5. serve   — llama3:8b (bf16, random weights from seed 0, default engine
             config with speculative decoding off) behind the engine's
             runner thread: eight concurrent requests from threads (bucket
             prefill, a prompt longer than one chunk), then a prefix-cache
             repeat beside a new prompt; greedy determinism, finite logits
             of the expected shape from every served model call, and every
             kernel's launch counter > 0 over the run.
6. replay  — the warm prefix-cache replay held to the cold run: llama3:8b
             in float32 serves a prompt cold, then again from the prefix
             cache, and the greedy streams must be identical; then, in
             bf16, each operation of a replayed prompt row and of a decode
             row computed both ways (ragged chunk region vs flash_prefill,
             group region alone vs beside a chunk, norms and projections
             in 8-, 1024- and 1032-row products), to show where bf16
             rounding departs between batch contexts.
Then the kernels line, the card's name and power limit, and the result.

Usage: python3 chip_smoke.py [--phases build,kernels,timing,model,serve,replay]
Needs one CUDA device; exits non-zero without one. Writes the compiler's
register report to chiprun_out/ptxas.txt.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
SEED = 0
# llama3:8b attention widths and the engine's default pool geometry
H, KVH, D, PS, S, MAXP = 32, 8, 128, 64, 8, 128
ALL_PHASES = ("build", "kernels", "timing", "model", "serve", "replay")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


class Inputs:
    """Seeded random tensors on the card."""

    def __init__(self, torch, seed: int):
        self.torch = torch
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(seed)

    def randn(self, *shape, dtype):
        t = self.torch.randn(shape, generator=self.gen, device="cuda", dtype=self.torch.float32)
        return t.to(dtype)

    def pools(self, n_layers, dtype):
        shape = (n_layers, S * MAXP, PS, KVH, D)
        return self.randn(*shape, dtype=dtype), self.randn(*shape, dtype=dtype)

    def page_table(self, lengths, extra: int = 0):
        """A random page permutation, one row per slot; entries past the
        pages a slot needs (lengths + extra tokens) are unmapped (-1)."""
        torch = self.torch
        perm = torch.randperm(S * MAXP, generator=self.gen, device="cuda").to(torch.int32)
        table = perm.reshape(S, MAXP).clone()
        for s, ln in enumerate(lengths):
            table[s, -(-(ln + extra) // PS):] = -1
        return table


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from gridllm_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ptxas.txt").write_text(
        "\n".join(f"== {src}\n{r['ptxas']}" for src, r in report.items()))
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "sources": {src: round(r["seconds"], 2) for src, r in report.items()}}


def _ragged_cases(inp: Inputs, dtype):
    """(name, kwargs, chunk_valid_rows) cases of ragged_attention."""
    torch = inp.torch
    lengths = [0, 1, 63, 64, 65, 700, 1500, 4000]   # straddles + an empty slot
    kp, vp = inp.pools(2, dtype)
    table = inp.page_table(lengths, extra=5)
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def group(td):
        return dict(q_group=inp.randn(S, td, H, D, dtype=dtype), page_table=table,
                    group_lengths=glens, k_group=inp.randn(S, td, KVH, D, dtype=dtype),
                    v_group=inp.randn(S, td, KVH, D, dtype=dtype))

    def chunk(c, start, valid):
        row = table[6]  # slot 6 owns 1500 + 5 tokens of pages
        return dict(q_chunk=inp.randn(1, c, H, D, dtype=dtype), chunk_row=row,
                    chunk_start=start, chunk_total=start + valid,
                    k_chunk=inp.randn(c, KVH, D, dtype=dtype),
                    v_chunk=inp.randn(c, KVH, D, dtype=dtype))

    base = dict(k_pages=kp, v_pages=vp, page_size=PS, layer=1)
    return [
        ("chunk_only", {**base, **chunk(256, 128, 200)}, 200),
        ("group_td1", {**base, **group(1)}, None),
        ("chunk_and_group", {**base, **chunk(1024, 448, 1000), **group(1)}, 1000),
        ("group_td5", {**base, **group(5)}, None),
        ("group_window", {**base, **group(1), "window": 100}, None),
        ("chunk_window_softcap", {**base, **chunk(256, 1216, 256), "window": 300,
                                  "softcap": 30.0}, 256),
        ("group_softcap", {**base, **group(5), "softcap": 30.0}, None),
    ]


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def phase_kernels(torch) -> dict:
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_ref, ragged_paged_attention_ref
    from gridllm_torch.ops.kernels import F32_TOL, by_name
    from gridllm_torch.ops.kvcache import write_decode, write_prefill

    inp = Inputs(torch, SEED)
    errs = {k: 0.0 for k in ck.LAUNCHES}
    cases = []
    bf16_tol = by_name("ragged_attention").atol
    check(bf16_tol == by_name("flash_prefill").atol, "attention tolerances differ")
    for dtype, tol in ((torch.bfloat16, bf16_tol), (torch.float32, F32_TOL)):
        dname = str(dtype).split(".")[-1]
        # flash_prefill: the engine's buckets, a batch of two with one
        # ragged seq_len, one window + softcap case
        for t, lens, window, cap in ((64, [64], 0, 0.0), (256, [200, 256], 0, 0.0),
                                     (1024, [1024], 0, 0.0), (256, [256], 96, 30.0)):
            b = len(lens)
            q = inp.randn(b, t, H, D, dtype=dtype)
            k = inp.randn(b, t, KVH, D, dtype=dtype)
            v = inp.randn(b, t, KVH, D, dtype=dtype)
            sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ck.flash_prefill(q, k, v, sl, softcap=cap, window=window)
            want = attention_prefill_ref(q, k, v, sl, logit_softcap=cap, window=window)
            torch.cuda.synchronize()
            err = max(_max_err(got[i, :ln], want[i, :ln]) for i, ln in enumerate(lens))
            cases.append({"kernel": "flash_prefill", "dtype": dname, "T": t, "seq_lens": lens,
                          "window": window, "softcap": cap, "max_abs_err": err})
            check(err <= tol, f"flash_prefill {dname} T={t}: err {err} > {tol}")
            if dtype == torch.bfloat16:
                errs["flash_prefill"] = max(errs["flash_prefill"], err)
        for name, kw, valid in _ragged_cases(inp, dtype):
            kw = dict(kw)
            cap, window = kw.pop("softcap", 0.0), kw.pop("window", 0)
            oc, og = ck.ragged_attention(**kw, softcap=cap, window=window)
            wc, wg = ragged_paged_attention_ref(**kw, logit_softcap=cap, window=window)
            torch.cuda.synchronize()
            err = 0.0
            if oc is not None:
                err = max(err, _max_err(oc[:, :valid], wc[:, :valid]))
            if og is not None:
                err = max(err, _max_err(og, wg))
            cases.append({"kernel": "ragged_attention", "dtype": dname, "case": name,
                          "max_abs_err": err})
            check(err <= tol, f"ragged_attention {dname} {name}: err {err} > {tol}")
            if dtype == torch.bfloat16:
                errs["ragged_attention"] = max(errs["ragged_attention"], err)
        del kw

        # paged_write_decode: inactive slot, capacity edge, unmapped page
        kp, vp = inp.pools(2, dtype)
        positions = torch.tensor([0, 63, 64, 700, 8191, 8192, 100, 5000],
                                 dtype=torch.int32, device="cuda")
        table = inp.page_table([int(p) for p in positions.tolist()], extra=1)
        table[7, :] = -1  # slot 7 unmapped
        active = torch.tensor([True] * 6 + [False, True], device="cuda")
        kn, vn = inp.randn(2, S, KVH, D, dtype=dtype), inp.randn(2, S, KVH, D, dtype=dtype)
        want_k, want_v = write_decode(kp.clone(), vp.clone(), kn, vn, table, positions,
                                      active, PS)
        got_k, got_v = ck.paged_write_decode(kp, vp, kn, vn, table, positions, active, PS)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got_k, want_k) and torch.equal(got_v, want_v))
        cases.append({"kernel": "paged_write_decode", "dtype": dname, "exact": exact})
        check(exact, f"paged_write_decode {dname}: pools differ")
        del kp, vp, want_k, want_v, got_k, got_v

        # paged_write_chunk: page-aligned start, ragged length; compare all
        # rows except the padded tail of the last written page
        kp, vp = inp.pools(2, dtype)
        t, start, length = 1024, 128, 700
        table = inp.page_table([start + t] * S)
        row = table[3]
        kn, vn = inp.randn(2, t, KVH, D, dtype=dtype), inp.randn(2, t, KVH, D, dtype=dtype)
        want_k, want_v = write_prefill(kp.clone(), vp.clone(), kn, vn, row, start, length, PS)
        got_k, got_v = ck.paged_write_chunk(kp, vp, kn, vn, row, start, length, PS)
        torch.cuda.synchronize()
        last = start + length - 1
        tail_page, tail_off = int(row[last // PS]), last % PS
        keep = torch.ones(kp.shape[1:3], dtype=torch.bool, device="cuda")
        keep[tail_page, tail_off + 1:] = False
        exact = bool(torch.equal(got_k[:, keep], want_k[:, keep])
                     and torch.equal(got_v[:, keep], want_v[:, keep]))
        cases.append({"kernel": "paged_write_chunk", "dtype": dname, "exact": exact})
        check(exact, f"paged_write_chunk {dname}: valid region differs")
        del kp, vp, want_k, want_v, got_k, got_v
    torch.cuda.empty_cache()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_cases.json").write_text(json.dumps(cases, indent=1))
    return {"phase": "kernels", "cases": len(cases), "max_abs_err_bf16": errs}


def phase_timing(torch) -> dict:
    import torch.nn.functional as F

    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.attention import attention_prefill_ref, ragged_paged_attention_ref
    from gridllm_torch.ops.kvcache import write_decode, write_prefill

    inp = Inputs(torch, SEED + 1)
    bf16 = torch.bfloat16
    res = {}

    # flash_prefill: the 1024-token bucket, full length
    t = 1024
    q = inp.randn(1, t, H, D, dtype=bf16)
    k, v = inp.randn(1, t, KVH, D, dtype=bf16), inp.randn(1, t, KVH, D, dtype=bf16)
    sl = torch.tensor([t], dtype=torch.int32, device="cuda")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    b, op = bound_ms((2 * q.numel() + k.numel() + v.numel()) * 2,
                     4 * H * D * t * (t + 1) / 2)
    res["flash_prefill"] = {
        "shape": f"q[1,{t},{H},{D}] bf16",
        "ms": time_ms(torch, lambda: ck.flash_prefill(q, k, v, sl)),
        "plain_ms": time_ms(torch, lambda: attention_prefill_ref(q, k, v, sl), iters=5),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bound_ms": b, "bound_by": op,
    }
    del q, k, v, qt, kt, vt

    # ragged_attention: a decode step's group region, 8 slots at 1024
    # cached tokens each (Td = 1)
    kp, vp = inp.pools(1, bf16)
    lengths = [1024] * S
    table = inp.page_table(lengths, extra=1)
    glens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(k_pages=kp, v_pages=vp, page_size=PS, q_group=inp.randn(S, 1, H, D, dtype=bf16),
              page_table=table, group_lengths=glens, k_group=inp.randn(S, 1, KVH, D, dtype=bf16),
              v_group=inp.randn(S, 1, KVH, D, dtype=bf16), layer=0)
    keys = sum(lengths) + S
    b, op = bound_ms(keys * KVH * D * 2 * 2 + 2 * S * H * D * 2, 4 * H * D * keys)
    res["ragged_attention"] = {
        "shape": f"decode group S={S} Td=1 context=1024 bf16",
        "ms": time_ms(torch, lambda: ck.ragged_attention(**kw)),
        "plain_ms": time_ms(torch, lambda: ragged_paged_attention_ref(**kw), iters=3),
        "library_ms": None,
        "bound_ms": b, "bound_by": op,
    }
    # the mixed step's chunk region (C = 1024 after 1024 cached tokens),
    # reported beside the decode figure
    ckw = dict(k_pages=kp, v_pages=vp, page_size=PS, q_chunk=inp.randn(1, 1024, H, D, dtype=bf16),
               chunk_row=table[0], chunk_start=1024, chunk_total=2048,
               k_chunk=inp.randn(1024, KVH, D, dtype=bf16),
               v_chunk=inp.randn(1024, KVH, D, dtype=bf16), layer=0)
    res["ragged_attention"]["chunk_region_ms"] = time_ms(torch, lambda: ck.ragged_attention(**ckw))
    del kp, vp, kw, ckw
    torch.cuda.empty_cache()

    # KV writes on the engine's full pool: 32 layers x 1024 pages x 64 rows
    n_layers = 32
    kp = torch.zeros((n_layers, S * MAXP, PS, KVH, D), dtype=bf16, device="cuda")
    vp = torch.zeros_like(kp)
    row_bytes = KVH * D * 2
    positions = torch.tensor([1024 + 7 * s for s in range(S)], dtype=torch.int32, device="cuda")
    table = inp.page_table([int(p) for p in positions.tolist()], extra=1)
    active = torch.ones(S, dtype=torch.bool, device="cuda")
    kn, vn = inp.randn(n_layers, S, KVH, D, dtype=bf16), inp.randn(n_layers, S, KVH, D, dtype=bf16)
    srange = torch.arange(S, device="cuda")
    pidx = table[srange, (positions // PS).long()].long()
    off = (positions % PS).long()

    def lib_decode():
        kp[:, pidx, off] = kn
        vp[:, pidx, off] = vn

    b, op = bound_ms(2 * 2 * n_layers * S * row_bytes, 0)
    res["paged_write_decode"] = {
        "shape": f"pool[{n_layers},{S * MAXP},{PS},{KVH},{D}] S={S} bf16",
        "ms": time_ms(torch, lambda: ck.paged_write_decode(kp, vp, kn, vn, table, positions,
                                                           active, PS)),
        "plain_ms": time_ms(torch, lambda: write_decode(kp, vp, kn, vn, table, positions,
                                                        active, PS)),
        "library_ms": time_ms(torch, lib_decode),
        "bound_ms": b, "bound_by": op,
    }
    t = 1024
    row = table[0]
    kn, vn = inp.randn(n_layers, t, KVH, D, dtype=bf16), inp.randn(n_layers, t, KVH, D, dtype=bf16)
    cpos = torch.arange(t, device="cuda")
    cpage, coff = row[(cpos // PS).long()].long(), (cpos % PS).long()

    def lib_chunk():
        kp[:, cpage, coff] = kn
        vp[:, cpage, coff] = vn

    b, op = bound_ms(2 * 2 * n_layers * t * row_bytes, 0)
    res["paged_write_chunk"] = {
        "shape": f"chunk[{n_layers},{t},{KVH},{D}] start=0 bf16",
        "ms": time_ms(torch, lambda: ck.paged_write_chunk(kp, vp, kn, vn, row, 0, t, PS)),
        "plain_ms": time_ms(torch, lambda: write_prefill(kp, vp, kn, vn, row, 0, t, PS)),
        "library_ms": time_ms(torch, lib_chunk),
        "bound_ms": b, "bound_by": op,
    }
    del kp, vp, kn, vn
    torch.cuda.empty_cache()
    return {"phase": "timing", "card": card_line(), "kernels": res}


def phase_model(torch) -> dict:
    """The model's paged entry points against its cache-free forward."""
    import dataclasses

    from gridllm_torch.models.configs import get_config
    from gridllm_torch.models.llama import Llama
    from gridllm_torch.ops.kernels import F32_TOL
    from gridllm_torch.ops.kvcache import PagedKVCache

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    cfg = dataclasses.replace(get_config("llama3:8b"), num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = Llama(cfg, dtype=torch.float32, device="cuda").init_params(gen)
    n = 320
    toks = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    want = model(toks[None])[0]                  # [n, V], flash_prefill
    cache = PagedKVCache.create(cfg.num_layers, 16, PS, KVH, D, 2, 8, dtype=torch.float32,
                                device="cuda")
    rows = torch.arange(16, device="cuda", dtype=torch.int32).reshape(2, 8)
    errs = []

    def err(got, pos):
        errs.append(float((got - want[pos]).abs().max()))

    # slot 0: 192-token prompt in the 256 bucket, then decode 192..255
    p0 = 192
    logits, _ = model.prefill(torch.cat([toks[:p0], toks[:64] * 0]), p0, cache, 0, rows[0])
    err(logits, p0 - 1)
    active = torch.tensor([True, False], device="cuda")
    cur = torch.zeros(2, dtype=torch.int32, device="cuda")
    for pos in range(p0, 256):
        cur[0] = toks[pos]
        logits, _ = model.decode_step(cur, cache, active)
        err(logits[0], pos)
    # slot 1 admits the same sequence in two 64-token chunks while slot 0
    # keeps decoding (positions 256 and 257) in the same ragged launches
    for start, pos in ((0, 256), (64, 257)):
        cur[0] = toks[pos]
        chunk_logits, dec_logits, _ = model.mixed_step(
            toks[start:start + 64], start, 64, 1, rows[1], cur, cache, active)
        err(chunk_logits, start + 63)
        err(dec_logits[0], pos)
    torch.cuda.synchronize()
    worst = max(errs)
    check(worst <= F32_TOL, f"model: paged path differs from forward by {worst}")
    del model, cache, want
    torch.cuda.empty_cache()
    return {"phase": "model", "config": "llama3:8b, 2 layers, float32",
            "logit_rows_compared": len(errs), "max_abs_err": worst}


def _prompt(rng, n_bytes: int) -> str:
    words = []
    while sum(len(w) + 1 for w in words) < n_bytes:
        words.append("".join(chr(97 + rng.randrange(26)) for _ in range(rng.randrange(2, 9))))
    return " ".join(words)[:n_bytes]


def phase_serve(torch) -> dict:
    import random

    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine
    from gridllm_torch.ops import cuda_kernels as ck

    rng = random.Random(SEED)
    t0 = time.perf_counter()
    engine = InferenceEngine(EngineConfig(model="llama3:8b", spec_decode=False), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    vocab = engine.cfg.vocab_size

    # every logits tensor the runner computes is checked on the device
    # (one flag, no sync per step) and its shape recorded
    finite = torch.ones((), dtype=torch.bool, device=engine.device)
    logit_shapes: set[tuple[int, ...]] = set()

    def watch(name: str, n_logits: int) -> None:
        fn = getattr(engine.model, name)

        def watched(*args, **kwargs):
            out = fn(*args, **kwargs)
            for logits in out[:n_logits]:
                logit_shapes.add(tuple(logits.shape))
                finite.logical_and_(torch.isfinite(logits).all())
            return out

        setattr(engine.model, name, watched)

    for name, n_logits in (("prefill", 1), ("decode_step", 1), ("mixed_step", 2)):
        watch(name, n_logits)

    def run_batch(prompts: list[tuple[str, int]]) -> tuple[list, float]:
        results: list = [None] * len(prompts)

        def one(i: int, text: str, n: int) -> None:
            opts = {"temperature": 0.0, "num_predict": n}
            results[i] = engine.generate(GenerationRequest(id=f"r{i}", prompt=text,
                                                           options=opts))

        threads = [threading.Thread(target=one, args=(i, p, n))
                   for i, (p, n) in enumerate(prompts)]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(not any(th.is_alive() for th in threads), "serve: a request hung")
        return results, time.perf_counter() - t_start

    def finished(res, n, what):
        # num_predict tokens, or fewer when the model sampled EOS (no stop
        # sequences are set, so "stop" can only mean EOS)
        ok = res is not None and (
            (res.done_reason == "length" and res.eval_count == n)
            or (res.done_reason == "stop" and res.eval_count < n))
        check(ok, f"serve: {what} finished {getattr(res, 'done_reason', None)!r} "
                  f"with {getattr(res, 'eval_count', None)} of {n} tokens "
                  f"({getattr(res, 'error', '')})")
        check(all(0 <= t < vocab for t in res.token_ids), f"serve: {what} token out of range")

    engine.start()
    try:
        ck.reset_launch_counts()
        short = [_prompt(rng, n) for n in (40, 150, 300, 700, 90, 220, 500)]
        long_prompt = _prompt(rng, 1500)   # > prefill_chunk: chunked mixed steps
        # eight at once: every slot of the engine (max_slots = 8) fills
        batch_a = [(short[0], 32), (short[1], 48), (short[2], 64), (short[3], 40),
                   (short[4], 56), (short[5], 32), (short[6], 48), (long_prompt, 64)]
        res_a, wall_a = run_batch(batch_a)
        for (text, n), res in zip(batch_a, res_a):
            finished(res, n, f"prompt of {len(text)} bytes")
        # a repeat of the 300-byte prompt hits the prefix cache and replays
        # through the ragged chunk region, next to a new short prompt
        batch_b = [(short[2], 64), (_prompt(rng, 120), 32)]
        res_b, wall_b = run_batch(batch_b)
        for (text, n), res in zip(batch_b, res_b):
            finished(res, n, f"second-batch prompt of {len(text)} bytes")
        check(res_b[0].cached_tokens > 0, "serve: the repeat did not hit the prefix cache")
        warm_matching = 0
        for a, b in zip(res_a[2].token_ids, res_b[0].token_ids):
            if a != b:
                break
            warm_matching += 1
        # greedy determinism: the same short prompt twice, each alone on
        # the engine, takes the same kernels at the same shapes
        solo = [run_batch([(short[0], 32)])[0][0] for _ in range(2)]
        for res in solo:
            finished(res, 32, "solo repeat")
        check(solo[0].token_ids == solo[1].token_ids, "serve: greedy repeat differs")
        # and a new prompt alone, cold then warm from the prefix cache: the
        # same stream, since no other request shares its steps' products
        fresh = _prompt(rng, 300)
        solo_warm = [run_batch([(fresh, 64)])[0][0] for _ in range(2)]
        for res in solo_warm:
            finished(res, 64, "solo cold/warm repeat")
        check(solo_warm[0].cached_tokens == 0 and solo_warm[1].cached_tokens > 0,
              "serve: the solo repeat did not hit the prefix cache")
        check(solo_warm[0].token_ids == solo_warm[1].token_ids,
              "serve: solo warm repeat differs from its cold run")
        solo += solo_warm
        counts = ck.launch_counts()
    finally:
        engine.stop()
    check(not engine.running, "serve: runner did not stop")
    check(all(n > 0 for n in counts.values()), f"serve: a kernel never launched: {counts}")
    want_shapes = {(vocab,), (engine.config.max_slots, vocab)}
    check(logit_shapes == want_shapes, f"serve: logits of shapes {logit_shapes}")
    check(bool(finite), "serve: non-finite logits on the served path")

    all_res = res_a + res_b
    eos_finishes = sum(r.done_reason == "stop" for r in all_res + solo)
    ttft_ms = [r.prompt_eval_duration_ns / 1e6 for r in all_res]
    tokens_a = sum(r.eval_count for r in res_a)
    return {
        "phase": "serve", "model": "llama3:8b", "dtype": "bfloat16",
        "device": torch.cuda.get_device_name(0), "card": card_line(), "load_s": load_s,
        "requests": len(all_res) + len(solo),
        "batch_a": {"requests": len(res_a), "tokens": tokens_a, "wall_s": wall_a,
                    "tokens_per_s": tokens_a / wall_a},
        "batch_b": {"requests": len(res_b), "wall_s": wall_b,
                    "cached_tokens": res_b[0].cached_tokens},
        "ttft_ms_median": statistics.median(ttft_ms),
        "ttft_ms": ttft_ms,
        "batched_warm_repeat_tokens_matching_cold":
            f"{warm_matching}/{len(res_b[0].token_ids)}",
        "solo_warm_repeat_equals_cold": True,
        "eos_finishes": eos_finishes,
        "logit_shapes": sorted(logit_shapes),
        "launches": counts,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def _replay_rounding(torch) -> dict:
    """bf16, one operation at a time: (a) a prompt's uncached rows as the
    warm replay computes them (ragged chunk region, 1032-row mixed-step
    product) and as the cold run does (flash_prefill, 1024-row bucket);
    prompt of 301 tokens, 256 of them cached (4 pages). (b) a decoding
    slot's rows in an 8-row decode-step product and at the tail of a
    mixed step's 1032-row product, as when another request's chunk is
    admitted beside it."""
    from gridllm_torch.ops import cuda_kernels as ck
    from gridllm_torch.ops.layers import rms_norm

    inp = Inputs(torch, SEED + 2)
    bf16, t, n, cached = torch.bfloat16, 1024, 301, 256
    fresh = n - cached
    q = inp.randn(1, t, H, D, dtype=bf16)
    k, v = inp.randn(1, t, KVH, D, dtype=bf16), inp.randn(1, t, KVH, D, dtype=bf16)
    sl = torch.tensor([n], dtype=torch.int32, device="cuda")
    cold = ck.flash_prefill(q, k, v, sl)[0, cached:n]
    pages = cached // PS
    kp = k[:, :cached].reshape(1, pages, PS, KVH, D).contiguous()
    vp = v[:, :cached].reshape(1, pages, PS, KVH, D).contiguous()

    def chunk(x):  # the prompt's uncached rows at the head of a 1024-row chunk
        out = torch.zeros((t,) + tuple(x.shape[2:]), dtype=bf16, device="cuda")
        out[:fresh] = x[0, cached:n]
        return out

    table = torch.arange(pages, dtype=torch.int32, device="cuda")
    chunk_kw = dict(q_chunk=chunk(q)[None], chunk_row=table, chunk_start=cached,
                    chunk_total=n, k_chunk=chunk(k), v_chunk=chunk(v))
    warm, _ = ck.ragged_attention(kp, vp, PS, **chunk_kw, layer=0)
    prompt_rows = {"attention": _max_err(warm[0, :fresh], cold)}
    # a decode step's group region alone, and beside a chunk in one launch
    group_kw = dict(q_group=inp.randn(S, 1, H, D, dtype=bf16),
                    page_table=table.repeat(S, 1),
                    group_lengths=torch.randint(1, cached + 1, (S,), generator=inp.gen,
                                                device="cuda", dtype=torch.int32),
                    k_group=inp.randn(S, 1, KVH, D, dtype=bf16),
                    v_group=inp.randn(S, 1, KVH, D, dtype=bf16))
    _, alone = ck.ragged_attention(kp, vp, PS, **group_kw, layer=0)
    _, beside = ck.ragged_attention(kp, vp, PS, **chunk_kw, **group_kw, layer=0)
    decode_rows = {"attention": _max_err(alone, beside)}
    for name, e, f in (("wq", 4096, H * D), ("w_gate", 4096, 14336), ("w_down", 14336, 4096)):
        x = inp.randn(t, e, dtype=bf16)
        xd = inp.randn(S, e, dtype=bf16)
        xm = torch.zeros((t + S, e), dtype=bf16, device="cuda")
        xm[:fresh] = x[cached:n]
        xm[t:] = xd
        w = (inp.randn(e, f, dtype=torch.float32) * e ** -0.5).to(bf16)
        mixed = xm @ w
        prompt_rows[f"projection_{name}"] = _max_err(mixed[:fresh], (x @ w)[cached:n])
        decode_rows[f"projection_{name}"] = _max_err(mixed[t:], xd @ w)
        if name == "wq":  # the norm before it: decode_step's [S, 1, E] rows
            ones = torch.ones(e, dtype=bf16, device="cuda")
            prompt_rows["rms_norm"] = _max_err(rms_norm(xm[None], ones)[0, :fresh],
                                               rms_norm(x[None], ones)[0, cached:n])
            decode_rows["rms_norm"] = _max_err(rms_norm(xm[None], ones)[0, t:],
                                               rms_norm(xd[:, None], ones)[:, 0])
    torch.cuda.synchronize()
    return {"prompt_rows": fresh, "prompt_max_abs_diff": prompt_rows,
            "decode_rows": S, "decode_max_abs_diff": decode_rows}


def phase_replay(torch) -> dict:
    """Warm prefix-cache replay against the cold run, in float32."""
    import random

    from gridllm_torch.engine import EngineConfig, GenerationRequest, InferenceEngine

    gc.collect()   # the serve phase's bf16 engine
    torch.cuda.empty_cache()
    prompt = _prompt(random.Random(SEED), 300)
    engine = InferenceEngine(EngineConfig(model="llama3:8b", dtype="float32",
                                          spec_decode=False), device="cuda")
    engine.start()
    try:
        runs = [engine.generate(GenerationRequest(
            id=f"f32-{i}", prompt=prompt, options={"temperature": 0.0, "num_predict": 64}))
            for i in range(2)]
    finally:
        engine.stop()
    cold, warm = runs
    for res in runs:
        check(res.done_reason in ("length", "stop") and res.token_ids,
              f"replay: {res.id} finished {res.done_reason!r} ({res.error})")
    check(cold.cached_tokens == 0 and warm.cached_tokens > 0,
          f"replay: cached tokens {cold.cached_tokens}, {warm.cached_tokens}")
    check(warm.token_ids == cold.token_ids, "replay: float32 warm stream differs from cold")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "replay", "model": "llama3:8b", "dtype": "float32",
            "cached_tokens": warm.cached_tokens, "tokens": len(warm.token_ids),
            "warm_equals_cold": True, "bf16_cold_vs_warm": _replay_rounding(torch)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    phases = ap.parse_args().phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gridllm_torch.ops.kernels import KERNELS

    t_run = time.perf_counter()
    results: dict[str, dict] = {}
    for phase in ALL_PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        if phase == "build":
            out = phase_build()
        else:
            out = {"kernels": phase_kernels, "timing": phase_timing, "model": phase_model,
                   "serve": phase_serve, "replay": phase_replay}[phase](torch)
        out["phase_seconds"] = time.perf_counter() - t0
        emit(out)
        results[phase] = out

    if set(phases) != set(ALL_PHASES):
        print(f"chip_smoke: ran {phases} only; no result line", file=sys.stderr)
        return 0
    timing = results["timing"]["kernels"]
    errs = results["kernels"]["max_abs_err_bf16"]
    launches = results["serve"]["launches"]
    emit({"kernels": [
        {"name": spec.name, "route": "cuda", "source": spec.source,
         "replaces": spec.replaces.split(" ")[0], "launches": launches[spec.name],
         "max_abs_err": errs[spec.name], "ms": timing[spec.name]["ms"],
         "plain_ms": timing[spec.name]["plain_ms"], "bound_ms": timing[spec.name]["bound_ms"],
         "bound_by": timing[spec.name]["bound_by"],
         "library_ms": timing[spec.name]["library_ms"]}
        for spec in KERNELS
    ], "total_seconds": time.perf_counter() - t_run})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
