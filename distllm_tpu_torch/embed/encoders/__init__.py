"""Encoder strategy factory with optional warm-start registration
(counterpart of ``distllm_tpu.embed.encoders``): ``register=True`` keeps
the encoder cached across work items of a persistent worker."""

from __future__ import annotations

from typing import Any

import torch

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.embed.encoders.auto import AutoEncoder, AutoEncoderConfig
from distllm_tpu_torch.embed.encoders.base import Encoder, TorchEncoder
from distllm_tpu_torch.embed.encoders.esm2 import (
    Esm2Encoder,
    Esm2EncoderConfig,
    EsmCambrianEncoder,
    EsmCambrianEncoderConfig,
)
from distllm_tpu_torch.embed.encoders.fake import FakeEncoder, FakeEncoderConfig
from distllm_tpu_torch.registry import registry

STRATEGIES: dict[str, tuple[type, type]] = {
    'auto': (AutoEncoderConfig, AutoEncoder),
    'esm2': (Esm2EncoderConfig, Esm2Encoder),
    'esmc': (EsmCambrianEncoderConfig, EsmCambrianEncoder),
    'fake': (FakeEncoderConfig, FakeEncoder),
}


def _build_encoder(device=None, **kwargs: Any) -> Encoder:
    return _factory.build('encoder', STRATEGIES, kwargs, device=device)


def get_encoder(
    kwargs: dict[str, Any],
    register: bool = False,
    device: 'str | torch.device | None' = None,
) -> Encoder:
    """Build an encoder on ``device`` (``None`` = CUDA); with
    ``register=True`` reuse the cached instance built from the same
    kwargs and device."""
    if register:
        return registry().get(
            _build_encoder, slot='encoder',
            device=None if device is None else str(device), **kwargs,
        )
    return _build_encoder(device=device, **kwargs)


__all__ = ['Encoder', 'TorchEncoder', 'get_encoder', 'STRATEGIES']
