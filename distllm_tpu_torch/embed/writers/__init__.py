"""Writer strategy factory (counterpart of
``distllm_tpu.embed.writers``)."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.embed.writers.huggingface import (
    HuggingFaceWriter,
    HuggingFaceWriterConfig,
)
from distllm_tpu_torch.embed.writers.numpy import NumpyWriter, NumpyWriterConfig

STRATEGIES: dict[str, tuple[type, type]] = {
    'huggingface': (HuggingFaceWriterConfig, HuggingFaceWriter),
    'numpy': (NumpyWriterConfig, NumpyWriter),
}


def get_writer(kwargs: dict[str, Any]):
    return _factory.build('writer', STRATEGIES, kwargs)


__all__ = ['get_writer', 'STRATEGIES']
