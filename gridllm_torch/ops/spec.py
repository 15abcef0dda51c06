"""Speculative-decoding drafters, n-gram (prompt lookup).

A drafter proposes up to K candidate continuation tokens for one slot from
host-visible state (the slot's full token history, prompt + generated).
The engine verifies all K in ONE batched model forward (`Llama.verify_step`)
and keeps the longest accepted prefix plus one corrected token, so a drafter
never changes what is generated, only how many forwards it takes: greedy
streams are token-identical with speculation on and off, and sampled
streams keep the target distribution (ops.sampling.spec_accept).

The port's copy of the JAX package's n-gram drafter (ops/spec.py there).
Its settings are constructor arguments with the reference's defaults
(longest n-gram 4, shortest 1, unbounded lookback), not environment
variables. The draft-model tree drafter and the token-tree helpers are not
ported.
"""

from __future__ import annotations

from typing import Protocol, Sequence


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


def make_drafter(kind: str = "ngram") -> Drafter:
    """The drafter named by `kind` ("ngram", with the reference's default
    settings, is the only one ported)."""
    if kind == "ngram":
        return NgramDrafter()
    raise ValueError(f"unknown drafter: {kind!r}")
