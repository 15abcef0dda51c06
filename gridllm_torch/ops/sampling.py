"""Batched token sampling with per-slot options.

The Ollama sampler option surface (temperature, top_k, top_p, min_p, seed,
repeat_penalty over the last repeat_last_n tokens) held as per-slot device
tensors, so one sampler call serves every slot of the continuous batch.
Same chain and order as the JAX package's ops/sampling.py.

Determinism: token i of a request with seed s depends only on (s, i). The
Gumbel noise comes from a counter-based hash of (seed, step, index) computed
with integer tensor ops, so CPU and CUDA draw the same noise. It is not the
JAX package's threefry stream: seeded sampled streams match in
distribution, greedy streams match token for token.
"""

from __future__ import annotations

import dataclasses

import torch

# sampling works on the static top-K logits; mass past the top 128 is
# negligible for every supported sampler setting (top_k clamps at TOPK)
TOPK = 128


@dataclasses.dataclass
class SamplingParams:
    """Per-slot sampler state, all tensors of shape [S]."""

    temperature: torch.Tensor     # f32; <= 0 → greedy
    top_k: torch.Tensor           # i32; <= 0 → disabled
    top_p: torch.Tensor           # f32; >= 1 → disabled
    min_p: torch.Tensor           # f32; <= 0 → disabled
    repeat_penalty: torch.Tensor  # f32; 1.0 → disabled
    repeat_last_n: torch.Tensor   # i32 window the penalty applies over
    seed: torch.Tensor            # i32 per-request seed
    step: torch.Tensor            # i32 tokens generated so far (noise counter)

    @staticmethod
    def defaults(max_slots: int, device: torch.device | str) -> "SamplingParams":
        def full(v, dtype):
            return torch.full((max_slots,), v, dtype=dtype, device=device)

        return SamplingParams(
            temperature=full(0.8, torch.float32),
            top_k=full(40, torch.int32),
            top_p=full(0.9, torch.float32),
            min_p=full(0.0, torch.float32),
            repeat_penalty=full(1.1, torch.float32),
            repeat_last_n=full(64, torch.int32),
            seed=full(0, torch.int32),
            step=full(0, torch.int32),
        )

    def set_slot(self, slot: int, values: dict) -> None:
        """Write one slot's options in place."""
        for f in dataclasses.fields(self):
            getattr(self, f.name)[slot] = values[f.name]

    def gather(self, slot: int) -> "SamplingParams":
        """One slot's options as a batch of one."""
        return SamplingParams(**{
            f.name: getattr(self, f.name)[slot:slot + 1]
            for f in dataclasses.fields(self)
        })


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) on int64 tensors
    holding values in [0, 2^32). Multipliers stay below 2^31, so no
    product leaves the int64 range on any device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _MASK32
    return x ^ (x >> 16)


def slot_gumbel(seed: torch.Tensor, step: torch.Tensor, k: int) -> torch.Tensor:
    """Per-slot Gumbel noise [S, k] keyed by (seed, step) — the port's
    counterpart of the JAX package's `_slot_gumbel` (a counter-based
    stream, not threefry)."""
    idx = torch.arange(k, device=seed.device, dtype=torch.int64)
    s = seed.to(torch.int64)[:, None] & _MASK32
    t = step.to(torch.int64)[:, None] & _MASK32
    h = _mix32(s ^ 0x3C6EF372)
    h = _mix32(h ^ t)
    h = _mix32(h ^ idx[None, :])
    u = (h.double() + 0.5) / 4294967296.0
    return (-torch.log(-torch.log(u))).float()


def _sampler_dists(
    logits: torch.Tensor,
    params: SamplingParams,
    token_counts: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shared sampler chain: repeat penalty → top-K extraction →
    truncation masks → temperature. Returns (greedy [S], idx [S, topk],
    keep [S, topk], scaled [S, topk]); the sampling distribution is
    softmax(scaled) restricted to `keep` over the token ids in `idx`."""
    logits = logits.float()
    if token_counts is not None:
        pen = params.repeat_penalty[:, None]
        seen = token_counts > 0
        logits = torch.where(
            seen, torch.where(logits > 0, logits / pen, logits * pen), logits)

    # ties go to the first index, as jnp.argmax
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)

    topk = min(TOPK, logits.shape[-1])
    vals, idx = torch.topk(logits, topk, dim=-1)  # sorted descending

    j = torch.arange(topk, device=logits.device)[None, :]
    k_eff = torch.where(params.top_k <= 0, torch.full_like(params.top_k, topk),
                        params.top_k.clamp(max=topk))
    keep = j < k_eff[:, None]

    # Ollama/llama.cpp order: truncation (top_k → top_p → min_p) on the
    # UNSCALED probabilities; temperature rescales only the final draw
    masked = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
    probs = torch.softmax(masked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep & ((cum - probs) < params.top_p[:, None])
    keep = keep & (probs >= params.min_p[:, None] * probs[:, :1])
    keep[:, 0] = True  # never mask the argmax

    temp = params.temperature.clamp(min=1e-6)[:, None]
    scaled = vals / temp
    return greedy, idx, keep, scaled


def sample_tokens(
    logits: torch.Tensor,
    params: SamplingParams,
    token_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample one token per slot. logits: [S, V] → [S] int32.
    token_counts ([S, V], optional): occurrences of each token in the
    slot's penalty window, for repeat_penalty."""
    greedy, idx, keep, scaled = _sampler_dists(logits, params, token_counts)
    gumbel = slot_gumbel(params.seed, params.step, idx.shape[-1])
    noisy = torch.where(keep, scaled + gumbel,
                        torch.full_like(scaled, float("-inf")))
    choice = torch.argmax(noisy, dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(params.temperature <= 0.0, greedy, sampled)


# ---------------------------------------------------------------------------
# repeat-penalty window (llama.cpp penalty_last_n semantics)
# ---------------------------------------------------------------------------
# Per slot: the last <= repeat_last_n context tokens in a fixed [S, W]
# buffer (right-aligned, oldest first) plus the [S, V] occurrence counts
# the penalty reads. Both helpers update the tensors in place.


def window_set_slot(
    window: torch.Tensor,   # [S, W] i32
    wlen: torch.Tensor,     # [S] i32
    counts: torch.Tensor,   # [S, V] i32
    slot: int,
    chunk: torch.Tensor,    # [T] i32 padded token chunk
    start: int,             # 0 resets the slot's window first
    clen: int,              # valid tokens in `chunk`
    rl: torch.Tensor,       # scalar i32: the slot's repeat_last_n (>= 0)
    vocab: int,
) -> None:
    """Append `chunk[:clen]` to one slot's window (reset when start == 0)
    and rebuild that slot's counts row, in place."""
    w = window.shape[1]
    dev = window.device
    rl = torch.clamp(rl, max=w)
    old = window[slot].clone()
    ol = torch.zeros_like(wlen[slot]) if start == 0 else wlen[slot]
    total = ol + clen
    m = torch.minimum(total, rl)
    j = torch.arange(w, device=dev)
    # virtual ordered sequence [0, total): the old window (oldest first),
    # then the chunk; keep its last m entries
    src = total - m + j
    from_old = src < ol
    old_idx = torch.clamp(w - ol + src, 0, w - 1)
    chunk_idx = torch.clamp(src - ol, 0, chunk.shape[0] - 1)
    tok = torch.where(from_old, old[old_idx], chunk[chunk_idx].to(window.dtype))
    valid = j < m
    dst = j + (w - m)                       # right-aligned
    row = torch.zeros((w + 1,), dtype=window.dtype, device=dev)
    row[torch.where(valid, dst, torch.full_like(dst, w))] = torch.where(
        valid, tok, torch.zeros_like(tok))
    window[slot] = row[:w]
    wlen[slot] = m
    counts[slot] = 0
    ids = torch.where(valid, tok.to(torch.int64), torch.full_like(j, vocab))
    ids = torch.clamp(ids, 0, vocab)        # out-of-vocab ids drop too
    row_counts = torch.zeros((vocab + 1,), dtype=counts.dtype, device=dev)
    row_counts.index_add_(0, ids, torch.ones_like(ids, dtype=counts.dtype))
    counts[slot] = row_counts[:vocab]


def window_push(
    window: torch.Tensor,   # [S, W] i32
    wlen: torch.Tensor,     # [S] i32
    counts: torch.Tensor,   # [S, V] i32
    tok: torch.Tensor,      # [S] i32 — one new token per slot
    active: torch.Tensor,   # [S] bool — inactive slots untouched
    rl: torch.Tensor,       # [S] i32 — per-slot repeat_last_n
    vocab: int,
) -> None:
    """Push one token per active slot into its window, evicting (and
    un-counting) the oldest token once the window is at repeat_last_n.
    Updates window, wlen and counts in place."""
    s = torch.arange(window.shape[0], device=window.device)
    w = window.shape[1]
    cap = torch.clamp(torch.clamp(rl, min=0), max=w)
    full = wlen >= cap
    evict_pos = torch.clamp(w - wlen, 0, w - 1).long()
    evicted = torch.gather(window, 1, evict_pos[:, None])[:, 0]
    do_evict = active & full & (cap > 0)
    _add_counts(counts, s, torch.where(do_evict, evicted, vocab), -1, vocab)
    pushed = torch.roll(window, -1, dims=1)
    pushed[:, -1] = tok
    window.copy_(torch.where(active[:, None], pushed, window))
    wlen.copy_(torch.where(active, torch.minimum(wlen + 1, cap), wlen))
    _add_counts(counts, s, torch.where(active & (cap > 0), tok, vocab), 1,
                vocab)


def _add_counts(counts: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
                delta: int, vocab: int) -> None:
    """counts[rows, ids] += delta, dropping ids outside [0, vocab) (the
    `vocab` sentinel marks rows to leave alone)."""
    ok = (ids >= 0) & (ids < vocab)
    flat = rows.long() * vocab + torch.clamp(ids.long(), 0, vocab - 1)
    add = torch.where(ok, torch.full_like(ids, delta),
                      torch.zeros_like(ids)).to(counts.dtype)
    counts.view(-1).index_add_(0, flat, add)
