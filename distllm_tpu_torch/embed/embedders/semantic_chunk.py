"""Semantic-chunk embedder (counterpart of
``distllm_tpu.embed.embedders.semantic_chunk``): two passes, chunking at
embedding-distance breakpoints.

1. Embed the dataset's sentence buffers (``jsonl_chunk``).
2. Within each document (a run of consecutive buffers with equal metadata
   ``path``), take the cosine distances between consecutive buffers in
   fp32, split where a distance exceeds the
   ``breakpoint_percentile_threshold`` percentile, join each group's
   ``sentence`` strings into a chunk, and drop chunks of at most
   ``min_chunk_length`` characters.
3. Embed the chunks in batches of ``chunk_batch_size``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.embed.embedders.base import EmbedderResult
from distllm_tpu_torch.embed.embedders.full_sequence import compute_embeddings
from distllm_tpu_torch.embed.encoders.base import Encoder
from distllm_tpu_torch.embed.poolers.base import Pooler
from distllm_tpu_torch.utils import BaseConfig


def calculate_distances_between_buffer(buffer_embeds: np.ndarray) -> np.ndarray:
    """Cosine distances between consecutive rows, computed in fp32."""
    x = buffer_embeds.astype(np.float32)
    if len(x) < 2:
        return np.zeros(0, dtype=np.float32)
    a, b = x[:-1], x[1:]
    sims = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return 1.0 - sims


def build_chunks(
    distances: np.ndarray, breakpoint_percentile_threshold: int
) -> list[tuple[int, int]]:
    """Index groups ``[(start, end)]`` with the reference's semantics:
    ``metadata[start:end]`` is a chunk's buffers, and a document of one
    buffer gives ``(0, 0)``, an empty slice."""
    if len(distances) == 0:
        return [(0, 0)]
    threshold = np.percentile(distances, breakpoint_percentile_threshold)
    groups = []
    start = 0
    for idx in (i for i, d in enumerate(distances) if d > threshold):
        groups.append((start, idx + 1))
        start = idx + 1
    groups.append((start, len(distances) + 1))
    return groups


def _document_spans(metadata: list[dict]) -> list[tuple[int, int]]:
    """Consecutive runs of equal ``path`` as ``[(start, end)]``."""
    spans = []
    start = 0
    current = metadata[0]['path']
    for i, meta in enumerate(metadata):
        if meta['path'] != current:
            spans.append((start, i))
            start = i
            current = meta['path']
    spans.append((start, len(metadata)))
    return spans


def compute_semantic_chunks(
    corpus: TextCorpus,
    encoder: Encoder,
    pooler: Pooler,
    batch_size: int,
    breakpoint_percentile_threshold: int,
    min_chunk_length: int,
) -> TextCorpus:
    """The first pass: buffer embeddings -> chunk texts and metadata."""
    if corpus.metadata is None:
        raise ValueError('Metadata is required for semantic chunking.')
    if corpus.metadata[0].get('path') is None:
        raise ValueError('Metadata path is required for semantic chunking.')

    buffer_embeds = compute_embeddings(
        corpus.texts, encoder, pooler, batch_size, device=encoder.device
    )
    chunks: list[str] = []
    metadata: list[dict] = []
    for doc_start, doc_end in _document_spans(corpus.metadata):
        distances = calculate_distances_between_buffer(buffer_embeds[doc_start:doc_end])
        for start, end in build_chunks(distances, breakpoint_percentile_threshold):
            group = corpus.metadata[doc_start + start:doc_start + end]
            chunk = ''.join(g['sentence'] for g in group)
            if len(chunk) <= min_chunk_length:
                continue
            chunks.append(chunk)
            meta = dict(corpus.metadata[doc_start + start])
            meta.pop('sentence', None)
            metadata.append(meta)
    return TextCorpus(chunks, metadata)


@dataclasses.dataclass
class SemanticChunkEmbedderConfig(BaseConfig):
    name: str = 'semantic_chunk'
    # The cosine-distance percentile a gap between consecutive buffers
    # must exceed to start a new chunk; smaller values give more chunks.
    breakpoint_percentile_threshold: int = 90
    chunk_batch_size: int = 8  # the batch size of the second (chunk) pass
    min_chunk_length: int = 750  # chunks of at most this many characters are dropped
    normalize_embeddings: bool = False


class SemanticChunkEmbedder:
    def __init__(self, config: SemanticChunkEmbedderConfig) -> None:
        self.config = config

    def embed(
        self,
        corpus: TextCorpus,
        encoder: Encoder,
        pooler: Pooler,
        batch_size: int,
    ) -> EmbedderResult:
        chunked = compute_semantic_chunks(
            corpus,
            encoder,
            pooler,
            batch_size,
            self.config.breakpoint_percentile_threshold,
            self.config.min_chunk_length,
        )
        embeddings = compute_embeddings(
            chunked.texts,
            encoder,
            pooler,
            self.config.chunk_batch_size,
            normalize=self.config.normalize_embeddings,
            device=encoder.device,
        )
        return EmbedderResult(
            embeddings=embeddings, text=chunked.texts, metadata=chunked.metadata
        )
