"""The strategy factories' one lookup: ``{'name': ..., **config}`` kwargs
to an instance."""

from __future__ import annotations

from typing import Any


def build(family: str, strategies: dict, kwargs: dict[str, Any], **extra: Any):
    """``strategies[name]`` = (config class, class); the instance is
    ``cls(config_cls(**kwargs), **extra)``."""
    name = kwargs.get('name', '')
    entry = strategies.get(name)
    if entry is None:
        raise ValueError(
            f'Unknown {family} name: {name!r}. Available: {sorted(strategies)}'
        )
    config_cls, cls = entry
    return cls(config_cls(**kwargs), **extra)
