"""Deterministic fake encoder for tests and pipeline runs (counterpart of
``distllm_tpu.embed.encoders.fake``): a fixed random fp32 table indexed by
token id over the ``WhitespaceTokenizer``, so no model files are needed.

The table is drawn from a CPU ``torch.Generator`` seeded with
``config.seed`` and then moved to the device, so it is the same on every
device and process. Its values are not the JAX encoder's: those come from
JAX's threefry bits, which cannot be made without JAX. Shapes, dtype and
per-seed determinism are the JAX encoder's.
"""

from __future__ import annotations

import dataclasses

import torch

from distllm_tpu_torch.embed.encoders.base import TorchEncoder
from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer
from distllm_tpu_torch.utils import BaseConfig, resolve_device


@dataclasses.dataclass
class FakeEncoderConfig(BaseConfig):
    name: str = 'fake'
    embedding_size: int = 64
    vocab_size: int = 4096
    model_max_length: int = 128
    seed: int = 0


def _lookup(params: dict, cfg, input_ids: torch.Tensor, attention_mask) -> torch.Tensor:
    return params['table'][input_ids.long()]


class FakeEncoder(TorchEncoder):
    def __init__(
        self,
        config: FakeEncoderConfig,
        device: 'str | torch.device | None' = None,
    ) -> None:
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(config.seed)
        table = torch.randn(
            (config.vocab_size, config.embedding_size), generator=generator
        )
        super().__init__(
            config=config,
            apply_fn=_lookup,
            model_cfg=None,
            params={'table': table.to(device)},
            tokenizer=WhitespaceTokenizer(
                vocab_size=config.vocab_size, model_max_length=config.model_max_length
            ),
            embedding_size=config.embedding_size,
            device=device,
        )
