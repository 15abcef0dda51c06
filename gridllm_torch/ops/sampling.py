"""Batched token sampling with per-slot options, and the speculative
accept/reject over a verify step's candidate block (`spec_accept`) or a
draft model's token tree (`spec_accept_tree`).

The Ollama sampler option surface (temperature, top_k, top_p, min_p, seed,
repeat_penalty over the last repeat_last_n tokens) held as per-slot device
tensors, so one sampler call serves every slot of the continuous batch.
Same chain and order as the JAX package's ops/sampling.py.

Determinism: token i of a request with seed s depends only on (s, i). The
noise is the JAX package's: threefry-2x32 keyed by
`fold_in(PRNGKey(seed), step)`, its `random_bits`, the bits-to-float
uniform and `gumbel`, written here in integer torch ops (uint32 held in
int64), so the CPU, CUDA and the JAX package draw the same bits. The
counter layout of `random_bits` is that of JAX 0.9.0 with
`jax_threefry_partitionable=True` (its default): element i of a draw of
shape (k,) is the XOR of the two output words of threefry(key, (0, i)).
Gumbel noise is -log(-log(u)) in float32, so it can differ from the JAX
package's by the last ulp of `log`; seeded sampled streams are equal
across the two packages except at a near-tie of two perturbed logits.
With no slot sampling (every temperature <= 0), callers pass
`noise=False` and no noise is drawn: the host-bound step skips ~300
launches, and the greedy result is the same.
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


# ---------------------------------------------------------------------------
# threefry-2x32 and the JAX package's key/bits/uniform/gumbel derivations
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)

# a key: the two uint32 words of a raw threefry key, int64 tensors of one shape
Key = tuple[torch.Tensor, torch.Tensor]


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as
    `jax._src.prng.threefry2x32_p` computes it) on int64 tensors holding
    uint32 values; the four operands broadcast. Every sum stays below
    2^34 and every shift below 2^61, inside int64 on any device."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) & _MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def prng_key(seed: torch.Tensor) -> Key:
    """`jax.random.PRNGKey` of int32 seeds: the words (seed >> 32, seed &
    0xFFFFFFFF), which for a 32-bit seed are (0, its two's-complement
    bits), negative seeds included."""
    s = seed.to(torch.int64) & _MASK32
    return torch.zeros_like(s), s


def fold_in(key: Key, data) -> Key:
    """`jax.random.fold_in`: threefry(key, (0, uint32(data)))."""
    k0, k1 = key
    d = torch.as_tensor(data, device=k0.device).to(torch.int64) & _MASK32
    return threefry2x32(k0, k1, torch.zeros_like(d), d)


def random_bits(key: Key, k: int | None) -> torch.Tensor:
    """`jax.random.bits` of 32-bit words, shape (k,) per key ([..., k]),
    or shape () with k None ([...]): word i is y0 ^ y1 of
    threefry(key, (0, i)), the partitionable counter layout."""
    k0, k1 = key
    if k is None:
        x = torch.zeros_like(k0)
    else:
        x = torch.arange(k, device=k0.device, dtype=torch.int64)
        k0, k1 = k0[..., None], k1[..., None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(x), x)
    return y0 ^ y1


def bits_to_uniform(bits: torch.Tensor, minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """JAX's float32 uniform of 32 random bits: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval)
    and clamped below at minval, each step in float32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform(key: Key, k: int | None = None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32)` with shape (k,) or ()."""
    return bits_to_uniform(random_bits(key, k))


def gumbel(key: Key, k: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (k,), float32)` (its default "low" mode):
    -log(-log(u)) of a uniform on [tiny, 1)."""
    u = bits_to_uniform(random_bits(key, k), _FLOAT32_TINY, 1.0)
    return -torch.log(-torch.log(u))


def step_key(seed: torch.Tensor, step: torch.Tensor) -> Key:
    """Per-slot key of one emitted-token index:
    fold_in(PRNGKey(seed), step), the JAX package's chain."""
    return fold_in(prng_key(seed), step)


def slot_gumbel(seed: torch.Tensor, step: torch.Tensor, k: int) -> torch.Tensor:
    """Per-slot Gumbel noise [S, k] keyed by (seed, step): the JAX
    package's `_slot_gumbel`."""
    return gumbel(step_key(seed, step), k)


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
    noise: bool = True,
) -> torch.Tensor:
    """Sample one token per slot. logits: [S, V] → [S] int32.
    token_counts ([S, V], optional): occurrences of each token in the
    slot's penalty window, for repeat_penalty. `noise=False`: every slot
    is greedy (the result is the penalized argmax; no noise is drawn)."""
    greedy, idx, keep, scaled = _sampler_dists(logits, params, token_counts)
    if not noise:
        return greedy
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
    """Per-slot (uniform [...], gumbel [..., topk]) for the emitted-token
    indices `step` ([S] or [S, n]), the JAX package's `_spec_keys`: the
    (seed, step) key that sample_tokens
    uses, folded with 1 for the accept test's uniform and with 2 for the
    fallback's Gumbel noise. Sampled spec-on streams are deterministic per
    (seed, step) but not equal to spec-off ones; greedy streams are."""
    key = step_key(seed, step)
    return uniform(fold_in(key, 1)), gumbel(fold_in(key, 2), topk)


def _ahead(params: SamplingParams, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(seed, step + i) for i in 0..n-1, [S, n] each: the emitted-token
    indices one verify step can draw at."""
    ahead = params.step[:, None] + torch.arange(n, device=params.step.device,
                                                dtype=params.step.dtype)
    return params.seed[:, None].expand_as(ahead), ahead


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
    noise: bool = True,
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
    token, the next step's input). `noise=False`: every slot is greedy and
    no noise is drawn."""
    s, k1, _ = logits.shape
    logits = logits.float()
    greedy_mode = params.temperature <= 0.0
    # the draft checked at step j is candidates[:, j+1]; the last step
    # never has one (the bonus token)
    drafts_next = torch.cat([candidates[:, 1:], torch.zeros_like(candidates[:, :1])], 1)
    emitted = torch.zeros((s,), dtype=torch.int32, device=logits.device)
    alive = torch.ones((s,), dtype=torch.bool, device=logits.device)
    rows = torch.arange(s, device=logits.device)
    if noise:
        # the draws of every index a step can emit at (step + 0 .. K1 - 1),
        # in one batch; step j picks its slot's at step + emitted
        u_all, g_all = _spec_keys(*_ahead(params, k1), min(TOPK, logits.shape[-1]))
    outs = []
    for j in range(k1):
        greedy, idx, keep, scaled = _sampler_dists(logits[:, j], params, counts)
        d = drafts_next[:, j].to(torch.int32)
        has_draft = j < dlen
        # sampled path: rejection sampling against the point-mass proposal
        if noise:
            u, gum = u_all[rows, emitted.long()], g_all[rows, emitted.long()]
        else:
            u, gum = torch.ones_like(scaled[:, 0]), torch.zeros_like(scaled)
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
    """Per-slot (uniform [..., rounds], gumbel [..., topk]) for the
    emitted-token indices `step` ([S] or [S, n]) of the tree accept walk,
    the JAX package's `_spec_tree_keys`: one
    uniform per candidate child round (each sibling needs its own accept
    test), the (seed, step) key folded with 3 + round, and the residual
    fallback's Gumbel noise under the key folded with 2."""
    key = step_key(seed, step)
    rnd = torch.arange(3, 3 + rounds, device=seed.device, dtype=torch.int64)
    u = uniform(fold_in((key[0][..., None], key[1][..., None]), rnd))
    return u, gumbel(fold_in(key, 2), topk)


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
    noise: bool = True,
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
    or past n_emit; n_emit [S]; last [S], the last emitted token).
    `noise=False`: every slot is greedy and no noise is drawn."""
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
    if noise:   # every index a step can emit at, in one batch (see spec_accept)
        u_all, g_all = _spec_tree_keys(*_ahead(params, n), min(TOPK, logits.shape[-1]),
                                       max(n - 1, 1))
    outs, paths = [], []
    for _ in range(n):
        greedy, idx, keep, scaled = _sampler_dists(logits[rows, cur], params, counts)
        if noise:
            u, gum = u_all[rows, emitted.long()], g_all[rows, emitted.long()]
        else:
            u = torch.ones((s, max(n - 1, 1)), dtype=torch.float32, device=dev)
            gum = torch.zeros_like(scaled)
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
