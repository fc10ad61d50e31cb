"""Tokenization with fixed-shape bucketed padding (copy of
``distllm_tpu.models.tokenizer``).

The engine pads prefill batches, and the embedder its batches, to a small
ladder of bucket lengths (:func:`bucket_ladder` / :func:`pick_bucket`).
:class:`WhitespaceTokenizer` is the deterministic hash-vocab tokenizer that
needs no model files; :class:`HFTokenizer` wraps a local HuggingFace fast
tokenizer (``transformers`` is imported only when one is built).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Sequence

import numpy as np


def bucket_ladder(
    max_length: int, min_bucket: int = 16, scheme: str = 'fine'
) -> list[int]:
    """Ladder of sequence buckets up to ``max_length``.

    ``scheme='fine'``: geometric (x2) up to 64, then linear steps of 32 (to
    384), 64 (to 512), and 128 beyond. ``scheme='pow2'`` (serving
    prefill): pure doubling.
    """
    if max_length < 1:
        raise ValueError(f'max_length must be >= 1, got {max_length}')
    if scheme not in ('fine', 'pow2'):
        raise ValueError(f"scheme must be 'fine' or 'pow2', got {scheme!r}")
    buckets: list[int] = []
    b = min(min_bucket, max_length)
    while b < max_length:
        buckets.append(b)
        if scheme == 'pow2' or b < 64:
            b *= 2
        elif b < 384:
            b += 32
        elif b < 512:
            b += 64
        else:
            b += 128
    buckets.append(max_length)
    return buckets


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (lengths beyond the ladder clamp to max)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclass
class TokenBatch:
    """Fixed-shape tokenized batch: int32 ``[B, S]`` ids and mask."""

    input_ids: np.ndarray
    attention_mask: np.ndarray

    @property
    def shape(self) -> tuple[int, int]:
        return self.input_ids.shape

    def pad_batch_to(self, batch_size: int, pad_id: int = 0) -> 'TokenBatch':
        """Pad the batch dimension with fully-masked rows (for bucketed B)."""
        b, s = self.input_ids.shape
        if b >= batch_size:
            return self
        ids = np.full((batch_size, s), pad_id, dtype=np.int32)
        mask = np.zeros((batch_size, s), dtype=np.int32)
        ids[:b] = self.input_ids
        mask[:b] = self.attention_mask
        return TokenBatch(ids, mask)


class _BucketingMixin:
    buckets: list[int]

    def _pad_to_bucket(
        self, rows: list[list[int]], pad_id: int, max_length: int
    ) -> TokenBatch:
        longest = max((len(r) for r in rows), default=1)
        target = pick_bucket(min(longest, max_length), self.buckets)
        ids = np.full((len(rows), target), pad_id, dtype=np.int32)
        mask = np.zeros((len(rows), target), dtype=np.int32)
        for i, row in enumerate(rows):
            if len(row) > target:
                # Truncate but keep the terminal special token.
                row = row[: target - 1] + [row[-1]]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return TokenBatch(ids, mask)


class WhitespaceTokenizer(_BucketingMixin):
    """Deterministic test tokenizer: whitespace split + stable hash vocab.

    Token ids are stable across processes (sha1-based) and identical to
    the JAX package's ``WhitespaceTokenizer``, so both engines see the same
    ids for the same text.
    """

    def __init__(
        self,
        vocab_size: int = 32000,
        model_max_length: int = 512,
        min_bucket: int = 16,
    ) -> None:
        if vocab_size <= 8:
            raise ValueError('vocab_size must be > 8')
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.pad_id = 0
        self.cls_id = 1
        self.sep_id = 2
        self.unk_id = 3
        self._n_special = 4
        self.buckets = bucket_ladder(model_max_length, min_bucket)
        self._reverse: dict[int, str] = {}
        self._cache: dict[str, int] = {}

    def token_id(self, token: str) -> int:
        tid = self._cache.get(token)
        if tid is not None:
            return tid
        digest = hashlib.sha1(token.encode()).digest()
        tid = self._n_special + int.from_bytes(digest[:4], 'little') % (
            self.vocab_size - self._n_special
        )
        self._reverse.setdefault(tid, token)
        self._cache[token] = tid
        return tid

    def __call__(
        self, texts: Sequence[str], *, max_length: int | None = None
    ) -> TokenBatch:
        max_length = max_length or self.model_max_length
        body_limit = max(0, max_length - 2)
        rows = []
        for text in texts:
            body = [self.token_id(t) for t in text.split()]
            rows.append([self.cls_id] + body[:body_limit] + [self.sep_id])
        return self._pad_to_bucket(rows, self.pad_id, max_length)

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for tid in ids:
            tid = int(tid)
            if tid < self._n_special:
                continue
            out.append(self._reverse.get(tid, f'<{tid}>'))
        return ' '.join(out)


class HFTokenizer(_BucketingMixin):
    """A local HuggingFace fast tokenizer with bucketed padding. The
    tokenizer's own ``model_max_length`` is respected; HF's huge sentinel
    for "unset" becomes 512."""

    def __init__(
        self,
        pretrained_model_name_or_path: str,
        model_max_length: int | None = None,
        min_bucket: int = 16,
        trust_remote_code: bool = False,
    ) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(
            pretrained_model_name_or_path, trust_remote_code=trust_remote_code
        )
        limit = model_max_length or getattr(self._tok, 'model_max_length', 512)
        self.model_max_length = int(min(limit, 1_000_000)) if limit else 512
        if self.model_max_length >= 1_000_000:
            self.model_max_length = 512
        self.vocab_size = int(self._tok.vocab_size)
        self.pad_id = int(self._tok.pad_token_id or 0)
        self.buckets = bucket_ladder(self.model_max_length, min_bucket)

    def __call__(
        self, texts: Sequence[str], *, max_length: int | None = None
    ) -> TokenBatch:
        max_length = max_length or self.model_max_length
        enc = self._tok(
            list(texts), truncation=True, max_length=max_length, padding=False
        )
        return self._pad_to_bucket(enc['input_ids'], self.pad_id, max_length)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=True)
