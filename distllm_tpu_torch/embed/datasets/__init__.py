"""Dataset strategy factory (the ported part of
``distllm_tpu.embed.datasets``: ``jsonl``)."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.embed.datasets.jsonl import JsonlDataset, JsonlDatasetConfig

STRATEGIES: dict[str, tuple[type, type]] = {
    'jsonl': (JsonlDatasetConfig, JsonlDataset),
}


def get_dataset(kwargs: dict[str, Any]) -> JsonlDataset:
    """Build a dataset strategy from ``{'name': ..., **config}`` kwargs."""
    return _factory.build('dataset', STRATEGIES, kwargs)


__all__ = ['TextCorpus', 'get_dataset', 'STRATEGIES']
