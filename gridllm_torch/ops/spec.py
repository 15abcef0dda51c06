"""Speculative-decoding drafters: n-gram (prompt lookup) and a draft model
with a static token tree.

A drafter proposes candidate continuation tokens for a slot from
host-visible state (the slot's full token history, prompt + generated).
The engine verifies them in ONE batched forward (`Llama.verify_step`) and
keeps the longest accepted prefix plus one corrected token, so a drafter
never changes what is generated, only how many forwards it takes: greedy
streams are token-identical with speculation on and off, and sampled
streams keep the target distribution (ops.sampling.spec_accept and
spec_accept_tree).

The port's copy of the JAX package's drafters (ops/spec.py there):
- `NgramDrafter`: longest-suffix match over the slot's own history; its
  settings are constructor arguments with the reference's defaults
  (longest n-gram 4, shortest 1, unbounded lookback), not environment
  variables.
- `DraftModelDrafter`: a small same-vocabulary model with its own paged KV
  pool, batched over all slots, emitting a static-topology token tree: a
  depth-K greedy chain plus (width - 1) first-level siblings whose tokens
  come free from the first draft step (`tree_topology`). Per-slot
  raggedness travels as node validity (data), never as topology.
"""

from __future__ import annotations

import time
from typing import Protocol, Sequence

import numpy as np
import torch

from gridllm_torch.ops.kvcache import PagedKVCache
from gridllm_torch.utils.config import env_int, env_str


class Drafter(Protocol):
    """One method: propose up to k likely next tokens for a slot."""

    def draft(self, ids: Sequence[int], k: int) -> list[int]:
        """ids: the slot's full context so far (prompt + generated, oldest
        first; the last element is the most recent emitted token). Returns
        0..k proposed continuation tokens; an empty list means no proposal,
        which the engine runs as a plain one-token verify step."""
        ...


class NgramDrafter:
    """Prompt-lookup drafting: longest-suffix n-gram match over the slot's
    own history.

    For n from `max_n` down to `min_n`, find the most recent earlier
    occurrence of the history's last n tokens and propose the tokens that
    followed it. The longest match wins, and among equal lengths the most
    recent occurrence. `lookback` bounds how far back the scan walks (0 =
    the whole history)."""

    kind = "ngram"

    def __init__(self, max_n: int = 4, min_n: int = 1, lookback: int = 0):
        if min_n < 1 or max_n < min_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n
        self.lookback = max(lookback, 0)

    def draft(self, ids: Sequence[int], k: int) -> list[int]:
        ids = list(ids)
        n_ids = len(ids)
        if k <= 0 or n_ids < self.min_n + 1:
            return []
        lo = 0 if not self.lookback else max(n_ids - self.lookback, 0)
        for n in range(min(self.max_n, n_ids - 1), self.min_n - 1, -1):
            suffix = ids[n_ids - n:]
            # most recent occurrence strictly before the suffix itself
            for i in range(n_ids - n - 1, lo - 1, -1):
                if ids[i:i + n] == suffix:
                    cont = ids[i + n:i + n + k]
                    if cont:
                        return cont
                    break  # the suffix recurs only at the very end: shorter n
        return []


def make_drafter(kind: str | None = None) -> Drafter:
    """The host-only drafter named by `kind`, else by GRIDLLM_SPEC_DRAFTER
    ("ngram"), its matcher set by GRIDLLM_SPEC_NGRAM_MAX / _MIN and
    GRIDLLM_SPEC_LOOKBACK. The draft-model drafter needs the engine's
    device and pool geometry: the engine builds it itself."""
    kind = kind or env_str("GRIDLLM_SPEC_DRAFTER")
    if kind == "ngram":
        return NgramDrafter(
            max_n=env_int("GRIDLLM_SPEC_NGRAM_MAX"),
            min_n=env_int("GRIDLLM_SPEC_NGRAM_MIN"),
            lookback=env_int("GRIDLLM_SPEC_LOOKBACK"),
        )
    raise ValueError(f"unknown drafter: {kind!r}")


# ---------------------------------------------------------------------------
# token-tree topology
# ---------------------------------------------------------------------------
#
# A draft tree is N nodes in topological order (parents[i] < i). Node 0 is
# the ROOT, the committed last token (column 0 of a chain verify block,
# whose K/V lags the pool like a decode step's input). Node i's K/V is
# written optimistically at storage position base + i, its rope/logical
# position is base + depth[i]. The topology is fixed per engine: a depth-K
# greedy chain at nodes 1..K and first-level siblings at K+1..N-1.


def tree_depths(parents: np.ndarray) -> np.ndarray:
    """Node depths from a topological parent array (parents[0] == -1,
    parents[i] < i). Root depth 0."""
    n = len(parents)
    depth = np.zeros(n, np.int32)
    for i in range(1, n):
        p = int(parents[i])
        if not 0 <= p < i:
            raise ValueError(f"parents must be topological; node {i} -> {p}")
        depth[i] = depth[p] + 1
    return depth


def tree_ancestor_mask(parents: np.ndarray) -> np.ndarray:
    """[N, N] bool: anc[i, j] iff node j is an ancestor of node i or i
    itself, the candidate columns node i's query may attend (its root path
    is the sequential prefix)."""
    n = len(parents)
    anc = np.zeros((n, n), bool)
    for i in range(n):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = int(parents[j])
    return anc


def tree_ancestor_bits(parents: np.ndarray) -> np.ndarray:
    """The ancestor mask packed row-wise into int32 bitmasks (bit j of entry
    i = anc[i, j]; bit 31 is the sign), the form the ragged kernel's tree
    leg reads, so a tree has at most 32 nodes."""
    from gridllm_torch.ops.attention import tree_bits_of

    if len(parents) > 32:
        raise ValueError(f"tree node budget {len(parents)} > 32 (bitmask packing)")
    return tree_bits_of(tree_ancestor_mask(parents))


def tree_topology(k: int, width: int) -> np.ndarray:
    """The engine's static draft topology: a depth-`k` chain (nodes 1..k,
    each the child of the one before) plus `width - 1` more first-level
    alternatives (children of the root). width == 1 is the pure chain;
    k == 0 is the root alone."""
    if k < 0 or width < 1:
        raise ValueError(f"bad tree shape k={k} width={width}")
    parents = [-1] + list(range(k)) + [0] * (width - 1 if k else 0)
    return np.asarray(parents, np.int32)


def stable_topk(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [S, k] of the k largest logits per row, equal values in
    index order (lowest first), as jax.lax.top_k orders them; torch.topk
    does not promise an order among ties."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]


class DraftModelDrafter:
    """Model-based drafting: a small same-vocabulary draft model with its
    own paged KV pool, batched over all slots (the JAX package's
    DraftModelDrafter).

    Per engine verify step the drafter (1) diffs each slot's host context
    against what its draft pool has consumed and rolls the pool back to the
    common prefix (length bookkeeping only: rejected drafts and corrections
    rewind for free), (2) ingests the new tokens in fixed-width catch-up
    chunks through the draft model's `verify_step`, taking the next-token
    logits from the final chunk's last valid row, and (3) runs K - 1
    greedy `decode_step`s after the first token, returning the chain and
    the top-`width` alternatives of the first step. Drafted tokens' K/V
    stay in the pool: an accepted token is the same token at the same
    position, so the next call's diff keeps it and only mispredictions
    are ingested again.

    Every slot owns a fixed stripe of pages (no allocator). A slot whose
    context would outgrow its stripe stops proposing; the engine then
    verifies its root alone, a plain decode step."""

    kind = "model"
    tree = True

    def __init__(self, model, *, max_slots: int, page_size: int, max_pages_per_slot: int,
                 ingest_width: int = 64):
        """`model`: the draft `Llama`, on its device, in the compute dtype
        of its pool; `ingest_width`: tokens per catch-up chunk."""
        self.model = model
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.draft_ns = 0  # cumulative host wall time inside draft_batch
        self._w = max(int(ingest_width), 1)
        self.max_context = min(model.cfg.max_seq_len, max_pages_per_slot * page_size)
        self.cache = self._new_cache()
        # per slot, the token prefix whose K/V the draft pool holds
        # (possibly ahead of the engine: optimistic draft writes)
        self._ctx: list[list[int]] = [[] for _ in range(max_slots)]

    def _new_cache(self) -> PagedKVCache:
        cfg, dev = self.model.cfg, self.model.device
        cache = PagedKVCache.create(
            cfg.num_layers, self.max_slots * self.max_pages_per_slot, self.page_size,
            cfg.num_kv_heads, cfg.head_dim_, self.max_slots, self.max_pages_per_slot,
            dtype=self.model.embed.dtype, device=dev)
        cache.page_table.copy_(torch.arange(
            self.max_slots * self.max_pages_per_slot, dtype=torch.int32,
            device=dev).reshape(self.max_slots, self.max_pages_per_slot))
        return cache

    def reset_slot(self, slot: int) -> None:
        """Forget a slot's draft context (its request finished)."""
        self._ctx[slot] = []

    def reset(self) -> None:
        """Rebuild the draft pool and forget every context (after a failed
        engine step)."""
        self.cache = self._new_cache()
        self._ctx = [[] for _ in range(self.max_slots)]

    def draft(self, ids: Sequence[int], k: int) -> list[int]:
        """The Drafter protocol's chain: slot 0's chain of a one-slot batch."""
        return self.draft_batch({0: list(ids)}, k, 1).get(0, ([], []))[0]

    @torch.no_grad()
    def draft_batch(self, ids_by_slot: dict[int, list[int]], k: int,
                    width: int) -> dict[int, tuple[list[int], list[int]]]:
        """One batched draft pass. Returns per slot (chain tokens, k of
        them; first-level alternatives, width - 1 of them). Slots that
        would overflow the draft pool, or were not asked for, are absent."""
        t0 = time.perf_counter_ns()
        s = self.max_slots
        live: list[int] = []
        for slot, ids in ids_by_slot.items():
            # +k: the decode steps write chain[0..k-2] past the context;
            # +1 headroom for the padded ingest chunk's junk tail
            if len(ids) + k + 1 > self.max_context or not ids:
                self._ctx[slot] = []
                continue
            live.append(slot)
        if not live or k <= 0:
            self.draft_ns += time.perf_counter_ns() - t0
            return {}

        # host diff: the longest common prefix of the pool's view and the
        # engine's context is the rollback point
        base = np.zeros(s, np.int32)
        todo: dict[int, list[int]] = {}
        for slot in live:
            ids = ids_by_slot[slot]
            n = 0
            for a, b in zip(self._ctx[slot], ids):
                if a != b:
                    break
                n += 1
            base[slot] = n
            todo[slot] = ids[n:]
            self._ctx[slot] = list(ids)  # consumed after the catch-up

        dev = self.model.device
        active_np = np.zeros(s, bool)
        active_np[live] = True
        active = torch.from_numpy(active_np).to(dev)
        cache, w = self.cache, self._w
        rounds = max(-(-max(len(v) for v in todo.values()) // w), 1)
        last = None
        for r in range(rounds):
            toks = np.zeros((s, w), np.int32)
            tlen = np.zeros(s, np.int32)
            for slot in live:
                seg = todo[slot][r * w:(r + 1) * w]
                if not seg:
                    # already caught up (the optimistic draft K/V matched, or
                    # a later round of a short slot): feed the final token
                    # again so this chunk still yields its next-token logits
                    seg = [self._ctx[slot][-1]]
                    base[slot] -= 1
                toks[slot, :len(seg)] = seg
                tlen[slot] = len(seg)
            cache.lengths.copy_(torch.from_numpy(base))
            logits, _ = self.model.verify_step(torch.from_numpy(toks).to(dev), cache, active)
            tl = torch.from_numpy(tlen).to(dev)
            cache.lengths.copy_(torch.clamp(cache.lengths + tl, max=self.max_context))
            # the chunk's last valid row is the next-token distribution
            last = logits[torch.arange(s, device=dev), (tl - 1).clamp(min=0).long()]
            base += tlen
        # k greedy steps: the first from the catch-up logits, with its
        # top-`width` alternatives (alts[:, 0] == chain[0])
        alts = stable_topk(last, max(width, 1)).to(torch.int32)
        tok = alts[:, 0]
        chain = [tok]
        for _ in range(k - 1):
            logits, _ = self.model.decode_step(tok, cache, active)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)   # ties: lowest index
            chain.append(tok)
        chain_np = torch.stack(chain, dim=1).cpu().numpy()
        alts_np = alts.cpu().numpy()
        out: dict[int, tuple[list[int], list[int]]] = {}
        for slot in live:
            ch = [int(t) for t in chain_np[slot]]
            # the decode steps consumed chain[:-1] and wrote their K/V
            self._ctx[slot] = self._ctx[slot] + ch[:-1]
            out[slot] = (ch, [int(t) for t in alts_np[slot][1:]])
        self.draft_ns += time.perf_counter_ns() - t0
        return out
