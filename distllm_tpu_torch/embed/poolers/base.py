"""Pooler protocol: ``[B, S, H]`` hidden states + ``[B, S]`` mask ->
``[B, H]`` fp32, on the hidden states' device."""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class Pooler(Protocol):
    config: object

    def pool(
        self, embeddings: torch.Tensor, attention_mask: torch.Tensor
    ) -> torch.Tensor: ...
