"""Generation: the paged-KV serving engine and the text pipeline around it
(readers -> prompts -> generators -> writers). The pipeline's factories
import lazily, as in ``distllm_tpu.generate``, so the engine is usable
without the text pipeline's dependencies."""

from __future__ import annotations

import importlib
from typing import Any

_LAZY = {
    'get_generator': 'distllm_tpu_torch.generate.generators',
    'get_prompt_template': 'distllm_tpu_torch.generate.prompts',
    'get_reader': 'distllm_tpu_torch.generate.readers',
    'get_writer': 'distllm_tpu_torch.generate.writers',
}


def __getattr__(name: str) -> Any:
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(name)
    return getattr(importlib.import_module(module), name)


__all__ = list(_LAZY)
