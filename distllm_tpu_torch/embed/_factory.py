"""The strategy factories' one lookup: ``{'name': ..., **config}`` kwargs
to an instance, refusing the strategies that are not ported yet."""

from __future__ import annotations

from typing import Any

# The JAX package's strategies that this port does not have yet, by family.
NOT_PORTED = {
    'dataset': ('jsonl_chunk', 'fasta', 'sequence_per_line', 'huggingface'),
    'encoder': ('esm2', 'esmc', 'fake'),
    'embedder': ('semantic_chunk',),
    'writer': ('huggingface',),
    'pooler': (),
}


def build(family: str, strategies: dict, kwargs: dict[str, Any], **extra: Any):
    """``strategies[name]`` = (config class, class); the instance is
    ``cls(config_cls(**kwargs), **extra)``."""
    name = kwargs.get('name', '')
    if name in NOT_PORTED[family]:
        raise NotImplementedError(
            f'{family} {name!r} is not ported to distllm_tpu_torch yet '
            '(ROADMAP A8)'
        )
    entry = strategies.get(name)
    if entry is None:
        raise ValueError(
            f'Unknown {family} name: {name!r}. Available: {sorted(strategies)}'
        )
    config_cls, cls = entry
    return cls(config_cls(**kwargs), **extra)
