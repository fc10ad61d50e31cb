"""Generator strategy factory with optional warm-start registration
(counterpart of ``distllm_tpu.generate.generators``).

It builds every name the JAX factory builds:

- ``tpu`` and ``vllm`` (the JAX package's engine names) and the port's own
  ``torch`` build :class:`TorchGenerator` from the JAX generator config's
  keys: ``pretrained_model_name_or_path`` serves a local HF checkpoint
  directory as the JAX ``TpuGenerator`` does, and without it a ``model``
  mapping picks its config class by ``name``, through
  ``models.decoder_family``; ``tensor_parallel_size`` above 1 serves on a
  mesh whose other ranks the generator spawns;
- ``huggingface``: transformers' ``AutoModelForCausalLM``;
- ``api`` and its alias ``langchain``: OpenAI / Anthropic / Google over
  HTTP; ``argo`` and ``openai``: the two dedicated chat endpoints;
- ``fake``: :class:`FakeGenerator`.

``register=True`` keeps the built generator warm in the registry across
work items.
"""

from __future__ import annotations

from typing import Any

import torch

from distllm_tpu_torch.generate.generators.api_backend import (
    ApiGenerator,
    ApiGeneratorConfig,
)
from distllm_tpu_torch.generate.generators.base import LLMGenerator
from distllm_tpu_torch.generate.generators.chat_endpoints import (
    ArgoGenerator,
    ArgoGeneratorConfig,
    OpenAIAPIGenerator,
    OpenAIAPIGeneratorConfig,
)
from distllm_tpu_torch.generate.generators.huggingface_backend import (
    HuggingFaceGenerator,
    HuggingFaceGeneratorConfig,
)
from distllm_tpu_torch.generate.generators.torch_backend import (
    FakeGenerator,
    FakeGeneratorConfig,
    TorchGenerator,
    TorchGeneratorConfig,
)
from distllm_tpu_torch.registry import registry

# Names that build the paged-KV engine: the JAX package's and the port's.
ENGINE_BACKENDS = ('tpu', 'vllm', 'torch')
# Backends whose config takes a ``device``.
DEVICE_BACKENDS = (*ENGINE_BACKENDS, 'huggingface')
# The other backends: name -> (config class, generator class).
OTHER_BACKENDS: dict[str, tuple[type, type]] = {
    'huggingface': (HuggingFaceGeneratorConfig, HuggingFaceGenerator),
    'api': (ApiGeneratorConfig, ApiGenerator),
    'langchain': (ApiGeneratorConfig, ApiGenerator),  # the reference's alias
    'argo': (ArgoGeneratorConfig, ArgoGenerator),
    'openai': (OpenAIAPIGeneratorConfig, OpenAIAPIGenerator),
}
STRATEGIES: dict[str, type] = {
    **dict.fromkeys(ENGINE_BACKENDS, TorchGenerator),
    **{name: cls for name, (_, cls) in OTHER_BACKENDS.items()},
    'fake': FakeGenerator,
}


def engine_generator_config(kwargs: dict[str, Any]) -> TorchGeneratorConfig:
    """The ``TorchGeneratorConfig`` of an engine backend's kwargs (``name``
    dropped); a ``model`` mapping becomes its family's config class."""
    from distllm_tpu_torch.models import decoder_family

    backend = dict(kwargs)
    backend.pop('name', None)
    if isinstance(backend.get('model'), dict):
        fields = dict(backend['model'])
        family = fields.pop('name', 'mistral')
        cfg_cls, _ = decoder_family(family)
        if family in cfg_cls.NAMES:
            fields['name'] = family
        backend['model'] = cfg_cls(**fields)
    return TorchGeneratorConfig(**backend)


def generator_config(kwargs: dict[str, Any]):
    """The config object of ``kwargs['name']``'s backend."""
    name = kwargs.get('name', '')
    if name in ENGINE_BACKENDS:
        return engine_generator_config(kwargs)
    if name == 'fake':
        return FakeGeneratorConfig(**kwargs)
    if name in OTHER_BACKENDS:
        return OTHER_BACKENDS[name][0].from_dict(kwargs)
    raise ValueError(
        f'Unknown generator name: {name!r}. Available: {sorted(STRATEGIES)}'
    )


def _build_generator(**kwargs: Any):
    return STRATEGIES[kwargs['name']](generator_config(kwargs))


def get_generator(
    kwargs: dict[str, Any],
    register: bool = False,
    device: 'str | torch.device | None' = None,
):
    """Build a generator; ``device`` (``None`` = the config's, CUDA unless
    it says otherwise) overrides the ``device`` field of an engine or
    ``huggingface`` backend; ``register=True`` reuses the cached warm
    instance."""
    if device is not None and kwargs.get('name') in DEVICE_BACKENDS:
        kwargs = {**kwargs, 'device': str(device)}
    generator_config(kwargs)  # refuses a bad name before the registry is touched
    if register:
        return registry().get(_build_generator, slot='generator', **kwargs)
    return _build_generator(**kwargs)


__all__ = [
    'ENGINE_BACKENDS',
    'ApiGenerator',
    'ArgoGenerator',
    'FakeGenerator',
    'HuggingFaceGenerator',
    'LLMGenerator',
    'OpenAIAPIGenerator',
    'TorchGenerator',
    'get_generator',
    'STRATEGIES',
]
