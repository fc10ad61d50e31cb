"""Prompt-lookup speculative drafting (the port's copy of
``distllm_tpu.generate.engine.spec``).

The drafter behind ``EngineConfig.draft_k``: each request's own
prompt+output history is the draft source. An n-gram ending at an
earlier position predicts that the tokens which followed it will follow
again. The lookup table keys each ``ngram``-token window by the prefix
cache's hasher (:func:`~distllm_tpu_torch.generate.engine.kv_cache.hash_block_tokens`,
byte-equal to the JAX package's) and maps it to the position just past
the window's most recent occurrence.

Drafts are proposals only: the engine verifies them in one dispatch and
keeps the longest accepted prefix (``LLMEngine._process_spec_window``), so
a bad draft costs a span slot, never a wrong token. The drafter proposes
no probabilities: the verifier treats each draft as a point mass
(``ops.sampling.verify_spans``).
"""

from __future__ import annotations

from typing import Sequence

from distllm_tpu_torch.generate.engine.kv_cache import hash_block_tokens


class PromptLookupDrafter:
    """Per-request n-gram -> continuation index over the token history.

    Incremental: ``draft`` indexes only the history positions it has not
    seen (the table survives across windows and recompute preemption,
    which keeps prompt and outputs). The terminal n-gram, the lookup key,
    is not indexed while it is terminal: mapped to itself it would always
    propose the empty continuation.
    """

    def __init__(self, ngram: int = 2) -> None:
        if ngram < 1:
            raise ValueError('ngram must be >= 1')
        self.ngram = ngram
        # digest of the n-gram ending at position p -> p + 1; a later
        # occurrence overwrites an earlier one (the most recent match wins).
        self._table: dict[bytes, int] = {}
        # Every position below this has its ending n-gram in the table.
        self._indexed_end = 0

    def _digest(self, tokens: Sequence[int]) -> bytes:
        return hash_block_tokens(None, tokens)

    def draft(self, history: Sequence[int], k: int) -> list[int]:
        """Up to ``k`` proposed continuation tokens for ``history``: empty
        when ``k <= 0``, the history is shorter than the n-gram, or the
        final n-gram has no earlier occurrence."""
        n = self.ngram
        end = len(history)
        for p in range(max(self._indexed_end, n - 1), end - 1):
            self._table[self._digest(history[p - n + 1:p + 1])] = p + 1
        self._indexed_end = max(self._indexed_end, end - 1)
        if k <= 0 or end < n:
            return []
        pos = self._table.get(self._digest(history[end - n:end]))
        if pos is None:
            return []
        return [int(t) for t in history[pos:pos + k]]
