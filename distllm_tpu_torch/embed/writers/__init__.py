"""Writer strategy factory (the ported part of
``distllm_tpu.embed.writers``: ``numpy``)."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.embed.writers.numpy import NumpyWriter, NumpyWriterConfig

STRATEGIES: dict[str, tuple[type, type]] = {
    'numpy': (NumpyWriterConfig, NumpyWriter),
}


def get_writer(kwargs: dict[str, Any]) -> NumpyWriter:
    return _factory.build('writer', STRATEGIES, kwargs)


__all__ = ['get_writer', 'STRATEGIES']
