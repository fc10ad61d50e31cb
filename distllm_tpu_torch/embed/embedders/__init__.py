"""Embedder strategy factory (counterpart of
``distllm_tpu.embed.embedders``)."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.embed.embedders.base import EmbedderResult
from distllm_tpu_torch.embed.embedders.full_sequence import (
    FullSequenceEmbedder,
    FullSequenceEmbedderConfig,
)
from distllm_tpu_torch.embed.embedders.semantic_chunk import (
    SemanticChunkEmbedder,
    SemanticChunkEmbedderConfig,
)

STRATEGIES: dict[str, tuple[type, type]] = {
    'full_sequence': (FullSequenceEmbedderConfig, FullSequenceEmbedder),
    'semantic_chunk': (SemanticChunkEmbedderConfig, SemanticChunkEmbedder),
}


def get_embedder(kwargs: dict[str, Any]):
    return _factory.build('embedder', STRATEGIES, kwargs)


__all__ = ['EmbedderResult', 'get_embedder', 'STRATEGIES']
