"""Generation writer factory (counterpart of ``distllm_tpu.generate.writers``):
``huggingface`` and ``amp_jsonl``."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.generate.writers.amp_json import (
    AMPJsonlWriter,
    AMPJsonlWriterConfig,
)
from distllm_tpu_torch.generate.writers.base import Writer
from distllm_tpu_torch.generate.writers.huggingface import (
    HuggingFaceWriter,
    HuggingFaceWriterConfig,
)

STRATEGIES: dict[str, tuple[type, type]] = {
    'huggingface': (HuggingFaceWriterConfig, HuggingFaceWriter),
    'amp_jsonl': (AMPJsonlWriterConfig, AMPJsonlWriter),
}


def get_writer(kwargs: dict[str, Any]) -> Writer:
    return _factory.build('writer', STRATEGIES, kwargs)


__all__ = ['Writer', 'get_writer', 'STRATEGIES']
