"""Dataset strategy factory (counterpart of
``distllm_tpu.embed.datasets``)."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.embed.datasets.fasta import FastaDataset, FastaDatasetConfig
from distllm_tpu_torch.embed.datasets.huggingface import (
    HuggingFaceDataset,
    HuggingFaceDatasetConfig,
)
from distllm_tpu_torch.embed.datasets.jsonl import JsonlDataset, JsonlDatasetConfig
from distllm_tpu_torch.embed.datasets.jsonl_chunk import (
    JsonlChunkDataset,
    JsonlChunkDatasetConfig,
)
from distllm_tpu_torch.embed.datasets.single_line import (
    SequencePerLineDataset,
    SequencePerLineDatasetConfig,
)

STRATEGIES: dict[str, tuple[type, type]] = {
    'jsonl': (JsonlDatasetConfig, JsonlDataset),
    'jsonl_chunk': (JsonlChunkDatasetConfig, JsonlChunkDataset),
    'fasta': (FastaDatasetConfig, FastaDataset),
    'sequence_per_line': (SequencePerLineDatasetConfig, SequencePerLineDataset),
    'huggingface': (HuggingFaceDatasetConfig, HuggingFaceDataset),
}


def get_dataset(kwargs: dict[str, Any]):
    """Build a dataset strategy from ``{'name': ..., **config}`` kwargs."""
    return _factory.build('dataset', STRATEGIES, kwargs)


__all__ = ['TextCorpus', 'get_dataset', 'STRATEGIES']
