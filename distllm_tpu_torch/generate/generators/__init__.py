"""Generator strategy factory with optional warm-start registration
(counterpart of ``distllm_tpu.generate.generators``).

``tpu`` and ``vllm`` (the JAX package's engine names) and the port's own
``torch`` build :class:`TorchGenerator` from the JAX generator config's
keys: ``pretrained_model_name_or_path`` serves a local HF checkpoint
directory as the JAX ``TpuGenerator`` does, and without it a ``model``
mapping picks its config class by ``name``, through
``models.decoder_family``; ``tensor_parallel_size`` above 1 raises naming
ROADMAP A10. ``fake`` builds :class:`FakeGenerator`. The JAX package's
other backends need network endpoints or ``transformers`` generation and
raise naming ROADMAP A11. ``register=True`` keeps the built generator
warm in the registry across work items.
"""

from __future__ import annotations

from typing import Any

import torch

from distllm_tpu_torch.generate.generators.torch_backend import (
    FakeGenerator,
    FakeGeneratorConfig,
    TorchGenerator,
    TorchGeneratorConfig,
)
from distllm_tpu_torch.registry import registry

# Names that build the paged-KV engine: the JAX package's and the port's.
ENGINE_BACKENDS = ('tpu', 'vllm', 'torch')
# The JAX factory's other backends, with the ROADMAP item that ports them.
NOT_PORTED = dict.fromkeys(
    ('huggingface', 'api', 'langchain', 'argo', 'openai'), 'ROADMAP A11'
)
STRATEGIES: dict[str, type] = {
    **dict.fromkeys(ENGINE_BACKENDS, TorchGenerator),
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
    if name in NOT_PORTED:
        raise ValueError(
            f'generator backend {name!r} is not ported to distllm_tpu_torch yet '
            f'({NOT_PORTED[name]}): it needs a network endpoint or transformers '
            'generation'
        )
    if name in ENGINE_BACKENDS:
        return engine_generator_config(kwargs)
    if name == 'fake':
        return FakeGeneratorConfig(**kwargs)
    raise ValueError(
        f'Unknown generator name: {name!r}. Available: '
        f'{sorted([*STRATEGIES, *NOT_PORTED])}'
    )


def _build_generator(**kwargs: Any):
    return STRATEGIES[kwargs['name']](generator_config(kwargs))


def get_generator(
    kwargs: dict[str, Any],
    register: bool = False,
    device: 'str | torch.device | None' = None,
):
    """Build a generator; ``device`` (``None`` = the config's, CUDA unless
    it says otherwise) overrides an engine backend's ``device`` field;
    ``register=True`` reuses the cached warm instance."""
    if device is not None and kwargs.get('name') in ENGINE_BACKENDS:
        kwargs = {**kwargs, 'device': str(device)}
    generator_config(kwargs)  # refuses a bad name before the registry is touched
    if register:
        return registry().get(_build_generator, slot='generator', **kwargs)
    return _build_generator(**kwargs)


__all__ = [
    'ENGINE_BACKENDS',
    'FakeGenerator',
    'TorchGenerator',
    'get_generator',
    'STRATEGIES',
]
