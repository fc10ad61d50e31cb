"""Embedder strategy factory (the ported part of
``distllm_tpu.embed.embedders``: ``full_sequence``)."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.embed.embedders.base import EmbedderResult
from distllm_tpu_torch.embed.embedders.full_sequence import (
    FullSequenceEmbedder,
    FullSequenceEmbedderConfig,
)

STRATEGIES: dict[str, tuple[type, type]] = {
    'full_sequence': (FullSequenceEmbedderConfig, FullSequenceEmbedder),
}


def get_embedder(kwargs: dict[str, Any]) -> FullSequenceEmbedder:
    return _factory.build('embedder', STRATEGIES, kwargs)


__all__ = ['EmbedderResult', 'get_embedder', 'STRATEGIES']
