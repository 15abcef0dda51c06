"""Tokenizers: a self-contained byte tokenizer and a local HF tokenizer.

- `ByteTokenizer`: ids 0..255 are bytes, plus BOS/EOS; used by tests and
  runs with random weights, so the engine needs no external artifact.
- `HFTokenizer`: a *local* transformers tokenizer directory (nothing is
  downloaded); transformers is imported only when one is built.

`DetokState` streams text incrementally without emitting a partial UTF-8
sequence: text is withheld while it ends in the replacement char.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Protocol, Sequence


class Tokenizer(Protocol):
    bos_id: int | None
    eos_ids: frozenset[int]
    vocab_size: int

    def encode(self, text: str, add_bos: bool = True) -> list[int]: ...
    def encode_for_embedding(self, text: str, max_len: int | None = None) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


@dataclasses.dataclass
class DetokState:
    """Incremental detokenization cursor over a growing id list."""

    emitted_chars: int = 0

    def delta(self, tok: Tokenizer, ids: Sequence[int]) -> str:
        """Text newly finalized by the latest ids. Holds back trailing bytes
        that decode to U+FFFD (a possibly split multi-byte char)."""
        text = tok.decode(ids)
        safe_end = len(text)
        while safe_end > 0 and text[safe_end - 1] == "�":
            safe_end -= 1
        if safe_end <= self.emitted_chars:
            return ""
        out = text[self.emitted_chars:safe_end]
        self.emitted_chars = safe_end
        return out


class ByteTokenizer:
    """Bytes → ids 0..255; BOS=256, EOS=257."""

    def __init__(self, vocab_size: int = 258):
        self.vocab_size = max(vocab_size, 258)
        self.bos_id: int | None = 256
        self.eos_ids = frozenset({257})

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos and self.bos_id is not None else ids

    def encode_for_embedding(self, text: str, max_len: int | None = None) -> list[int]:
        ids = self.encode(text, add_bos=True)
        return ids[:max_len] if max_len is not None else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Local-directory transformers tokenizer (no network)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.bos_id = self._tok.bos_token_id
        eos = self._tok.eos_token_id
        ids = set(eos if isinstance(eos, list) else [eos] if eos is not None else [])
        # llama3 chat also stops on <|eot_id|>
        eot = self._tok.convert_tokens_to_ids("<|eot_id|>")
        if isinstance(eot, int) and eot >= 0:
            ids.add(eot)
        self.eos_ids = frozenset(ids)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def encode_for_embedding(self, text: str, max_len: int | None = None) -> list[int]:
        """The full special-token template: BERT-family tokenizers wrap the
        text in [CLS] ... [SEP], and cls pooling (models/bert_embed.pool)
        reads position 0. Truncation happens inside the tokenizer, so the
        trailing [SEP] survives (slicing afterwards would cut it)."""
        if max_len is not None:
            return self._tok.encode(text, add_special_tokens=True, truncation=True,
                                    max_length=max_len)
        return self._tok.encode(text, add_special_tokens=True)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def get_tokenizer(spec: str | None, vocab_size: int = 258) -> Tokenizer:
    """spec: None/"byte" → ByteTokenizer; anything else → local HF dir,
    read through transformers. Where transformers is not installed the
    directory's tokenizer cannot be read: the byte tokenizer serves
    instead, with a warning (the model's ids then stream as bytes)."""
    if spec is None or spec == "byte":
        return ByteTokenizer(vocab_size)
    try:
        import transformers  # noqa: F401 — only whether it is installed
    except ImportError:
        logging.getLogger(__name__).warning(
            "tokenizer %s: transformers is not installed; serving the byte tokenizer", spec)
        return ByteTokenizer(vocab_size)
    return HFTokenizer(spec)
