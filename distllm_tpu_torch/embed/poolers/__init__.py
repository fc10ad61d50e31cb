"""Pooler strategy factory (PyTorch counterpart of
``distllm_tpu.embed.poolers``)."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.embed.poolers.base import Pooler
from distllm_tpu_torch.embed.poolers.last_token import (
    LastTokenPooler,
    LastTokenPoolerConfig,
)
from distllm_tpu_torch.embed.poolers.mean import MeanPooler, MeanPoolerConfig

STRATEGIES: dict[str, tuple[type, type]] = {
    'mean': (MeanPoolerConfig, MeanPooler),
    'last_token': (LastTokenPoolerConfig, LastTokenPooler),
}


def get_pooler(kwargs: dict[str, Any]) -> Pooler:
    return _factory.build('pooler', STRATEGIES, kwargs)


__all__ = ['Pooler', 'get_pooler', 'STRATEGIES']
