"""Reader strategy factory (counterpart of ``distllm_tpu.generate.readers``):
``jsonl``, ``huggingface`` and ``amp_json``."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.generate.readers.amp_json import AMPJsonReader, AMPJsonReaderConfig
from distllm_tpu_torch.generate.readers.base import Reader
from distllm_tpu_torch.generate.readers.huggingface import (
    HuggingFaceReader,
    HuggingFaceReaderConfig,
)
from distllm_tpu_torch.generate.readers.jsonl import JsonlReader, JsonlReaderConfig

STRATEGIES: dict[str, tuple[type, type]] = {
    'jsonl': (JsonlReaderConfig, JsonlReader),
    'huggingface': (HuggingFaceReaderConfig, HuggingFaceReader),
    'amp_json': (AMPJsonReaderConfig, AMPJsonReader),
}


def get_reader(kwargs: dict[str, Any]) -> Reader:
    return _factory.build('reader', STRATEGIES, kwargs)


__all__ = ['Reader', 'get_reader', 'STRATEGIES']
