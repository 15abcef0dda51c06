"""Batched token sampling with per-slot options, and the speculative
accept/reject over a verify step's candidate block (`spec_accept`) or a
draft model's token tree (`spec_accept_tree`).

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


def _counter_uniform(seed: torch.Tensor, step: torch.Tensor, k: int,
                     stream: int | None = None) -> torch.Tensor:
    """Per-slot uniforms in (0, 1), float64 [S, k], from a counter hash of
    (seed, step, index); `stream` derives an independent sub-stream of the
    same (seed, step), as the JAX package's fold_in does."""
    idx = torch.arange(k, device=seed.device, dtype=torch.int64)
    s = seed.to(torch.int64)[:, None] & _MASK32
    t = step.to(torch.int64)[:, None] & _MASK32
    h = _mix32(s ^ 0x3C6EF372)
    h = _mix32(h ^ t)
    if stream is not None:
        h = _mix32(h ^ (0x2545F491 * stream & _MASK32))
    h = _mix32(h ^ idx[None, :])
    return (h.double() + 0.5) / 4294967296.0


def slot_gumbel(seed: torch.Tensor, step: torch.Tensor, k: int) -> torch.Tensor:
    """Per-slot Gumbel noise [S, k] keyed by (seed, step) — the port's
    counterpart of the JAX package's `_slot_gumbel` (a counter-based
    stream, not threefry)."""
    u = _counter_uniform(seed, step, k)
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
# speculative decoding: batched accept/reject over a candidate block
# ---------------------------------------------------------------------------


def _spec_keys(seed: torch.Tensor, step: torch.Tensor,
               topk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot (uniform [S], gumbel [S, topk]) for one emitted-token index:
    two sub-streams of the (seed, step) counter that sample_tokens uses,
    since the spec path draws twice per emitted token (accept test and
    fallback sample). Sampled spec-on streams are deterministic per
    (seed, step) but not equal to spec-off ones; greedy streams are."""
    u = _counter_uniform(seed, step, 1, stream=1)[:, 0].float()
    g = -torch.log(-torch.log(_counter_uniform(seed, step, topk, stream=2)))
    return u, g.float()


def spec_accept(
    logits: torch.Tensor,      # [S, K1, V] f32 verify-forward logits
    candidates: torch.Tensor,  # [S, K1]: col 0 the committed last token
    dlen: torch.Tensor,        # [S] i32 valid drafts per slot (0..K1-1)
    params: SamplingParams,
    counts: torch.Tensor,      # [S, V] i32 repeat-penalty counts
    window: torch.Tensor,      # [S, W] i32 repeat-penalty window
    wlen: torch.Tensor,        # [S] i32
    active: torch.Tensor,      # [S] bool
    vocab: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the longest accepted candidate prefix plus one corrected token.

    logits[s, j] is the next-token distribution after candidates[s, :j+1];
    step j emits one token for every slot still alive:
    - greedy (temperature <= 0): the argmax of the penalized logits, as the
      sequential decode path; the slot stays alive iff the next draft
      equals it, so greedy spec-on streams equal spec-off ones;
    - sampled: rejection sampling against the n-gram drafter's point-mass
      proposal: accept the draft with probability p(draft) under the full
      truncated, penalized, temperature-scaled target; on rejection sample
      from the target with the draft masked out.
    The repeat-penalty window and counts advance per emitted token (in
    place), so position j sees every token emitted before it, and
    params.step advances by the emitted count.

    Returns (out [K1, S]: row j valid iff j < n_emit[s]; n_emit [S] in
    [1, K1] for active slots, 0 for inactive; last [S]: the last emitted
    token, the next step's input)."""
    s, k1, _ = logits.shape
    logits = logits.float()
    greedy_mode = params.temperature <= 0.0
    # the draft checked at step j is candidates[:, j+1]; the last step
    # never has one (the bonus token)
    drafts_next = torch.cat([candidates[:, 1:], torch.zeros_like(candidates[:, :1])], 1)
    emitted = torch.zeros((s,), dtype=torch.int32, device=logits.device)
    alive = torch.ones((s,), dtype=torch.bool, device=logits.device)
    outs = []
    for j in range(k1):
        greedy, idx, keep, scaled = _sampler_dists(logits[:, j], params, counts)
        d = drafts_next[:, j].to(torch.int32)
        has_draft = j < dlen
        # sampled path: rejection sampling against the point-mass proposal
        u, gum = _spec_keys(params.seed, params.step + emitted, idx.shape[-1])
        neg = torch.full_like(scaled, float("-inf"))
        probs = torch.softmax(torch.where(keep, scaled, neg), dim=-1)
        is_d = keep & (idx == d[:, None])
        p_d = torch.where(is_d, probs, torch.zeros_like(probs)).sum(-1)
        fb_keep = keep & ~(has_draft[:, None] & is_d)
        any_fb = fb_keep.any(-1)
        choice = torch.argmax(torch.where(fb_keep, scaled + gum, neg), dim=-1)
        fallback = torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
        # ~any_fb: the draft is the only kept token, so p(draft) = 1 and a
        # rounding reject would have nothing to fall back on
        s_acc = has_draft & ((u < p_d) | ~any_fb)
        s_tok = torch.where(s_acc, d, fallback)
        # greedy path: the emitted token is the argmax either way
        g_acc = has_draft & (d == greedy)
        tok = torch.where(greedy_mode, greedy, s_tok)
        acc = torch.where(greedy_mode, g_acc, s_acc)
        emit = alive & active
        window_push(window, wlen, counts, tok, emit, params.repeat_last_n, vocab)
        emitted = emitted + emit.to(torch.int32)
        alive = alive & acc
        outs.append(torch.where(emit, tok, torch.zeros_like(tok)))
    out = torch.stack(outs)
    last = torch.gather(out.T, 1, (emitted - 1).clamp(min=0)[:, None].long())[:, 0]
    params.step += emitted
    return out, emitted, last


def _spec_tree_keys(seed: torch.Tensor, step: torch.Tensor, topk: int,
                    rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot (uniform [S, rounds], gumbel [S, topk]) for one emitted-token
    index of the tree accept walk: one uniform per candidate child round
    (each sibling needs its own accept test) and the residual fallback's
    Gumbel noise. Sub-streams 3 and 4 of the (seed, step) counter, disjoint
    from spec_accept's streams 1 and 2, as the JAX package folds its tree
    draws apart from its chain draws."""
    u = _counter_uniform(seed, step, rounds, stream=3).float()
    g = -torch.log(-torch.log(_counter_uniform(seed, step, topk, stream=4)))
    return u, g.float()


def spec_accept_tree(
    logits: torch.Tensor,       # [S, N, V] f32 tree-verify logits
    node_tokens: torch.Tensor,  # [S, N]: col 0 the committed root token
    parents,                    # [N] host ints, topological (parents[i] < i)
    node_valid: torch.Tensor,   # [S, N] bool live nodes (root always; ancestor-closed)
    params: SamplingParams,
    counts: torch.Tensor,       # [S, V] i32 repeat-penalty counts
    window: torch.Tensor,       # [S, W] i32 repeat-penalty window
    wlen: torch.Tensor,         # [S] i32
    active: torch.Tensor,       # [S] bool
    vocab: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk the accepted root-to-leaf path of a static-topology draft tree
    (the JAX package's spec_accept_tree).

    logits[s, i] is the next-token distribution after node i's root path
    (the tree-masked verify forward). Each of N steps tests the current
    node's valid children in node order:
    - greedy (temperature <= 0): emit the argmax of the penalized logits
      at the current node, as sequential decode does, and descend into the
      first child carrying it; greedy streams equal spec-off ones;
    - sampled: multi-round rejection. Child c with token x is accepted with
      probability residual(x), where the residual starts as the full
      truncated, penalized, temperature-scaled target and each rejected
      sibling's token is removed and the rest renormalized; if every child
      rejects, sample the final residual.
    A step with no accepted child emits its corrected or bonus token and
    ends the walk. The repeat-penalty window and counts advance per emitted
    token (in place) and params.step by the emitted count. The walk is
    tensor code on the logits' device: no host sync inside it.

    Returns (out [N, S]: row j valid iff j < n_emit[s]; path [S, N]:
    path[s, j] is the tree node whose optimistically written row backs
    committed position lengths[s] + 1 + j, 0 for a corrected or bonus token
    or past n_emit; n_emit [S]; last [S], the last emitted token)."""
    s, n, _ = logits.shape
    parents = [int(p) for p in parents]
    if len(parents) != n:
        raise ValueError(f"spec_accept_tree: {len(parents)} parents for {n} nodes")
    logits = logits.float()
    dev = logits.device
    greedy_mode = params.temperature <= 0.0
    rows = torch.arange(s, device=dev)
    emitted = torch.zeros((s,), dtype=torch.int32, device=dev)
    alive = torch.ones((s,), dtype=torch.bool, device=dev)
    cur = torch.zeros((s,), dtype=torch.int64, device=dev)
    node_tokens = node_tokens.to(torch.int32)
    outs, paths = [], []
    for _ in range(n):
        greedy, idx, keep, scaled = _sampler_dists(logits[rows, cur], params, counts)
        u, gum = _spec_tree_keys(params.seed, params.step + emitted, idx.shape[-1],
                                 max(n - 1, 1))
        neg = torch.full_like(scaled, float("-inf"))
        probs = torch.softmax(torch.where(keep, scaled, neg), dim=-1)
        zero = torch.zeros_like(probs)
        fb_keep = keep
        acc_node = torch.full((s,), -1, dtype=torch.int64, device=dev)
        for c in range(1, n):
            tok_c = node_tokens[:, c]
            considered = node_valid[:, c] & (cur == parents[c]) & (acc_node < 0)
            is_tok = fb_keep & (idx == tok_c[:, None])
            num = torch.where(is_tok, probs, zero).sum(-1)
            den = torch.where(fb_keep, probs, zero).sum(-1)
            p_c = num / den.clamp(min=1e-30)
            # forced: this child's token is the only kept mass left, so a
            # rounding reject would leave an empty residual
            forced = ~(fb_keep & (idx != tok_c[:, None])).any(-1)
            s_acc = considered & ((u[:, c - 1] < p_c) | forced)
            g_acc = considered & (tok_c == greedy)
            acc = torch.where(greedy_mode, g_acc, s_acc)
            acc_node = torch.where(acc, c, acc_node)
            rejected = considered & ~acc & ~greedy_mode
            fb_keep = fb_keep & ~(rejected[:, None] & (idx == tok_c[:, None]))
        has = acc_node >= 0
        acc_tok = torch.gather(node_tokens, 1, acc_node.clamp(min=0)[:, None])[:, 0]
        choice = torch.argmax(torch.where(fb_keep, scaled + gum, neg), dim=-1)
        fallback = torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
        tok = torch.where(greedy_mode, greedy, torch.where(has, acc_tok, fallback))
        emit = alive & active
        window_push(window, wlen, counts, tok, emit, params.repeat_last_n, vocab)
        emitted = emitted + emit.to(torch.int32)
        cur = torch.where(has & emit, acc_node, cur)
        alive = alive & has
        outs.append(torch.where(emit, tok, torch.zeros_like(tok)))
        paths.append(torch.where(emit & has, acc_node, 0).to(torch.int32))
    out = torch.stack(outs)
    last = torch.gather(out.T, 1, (emitted - 1).clamp(min=0)[:, None].long())[:, 0]
    params.step += emitted
    return out, torch.stack(paths, dim=1), emitted, last


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
