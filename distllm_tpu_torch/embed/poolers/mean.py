"""Mean pooler: masked average excluding the start token and each row's
own end token (the PyTorch counterpart of ``distllm_tpu.embed.poolers.
mean``, with its per-row end-token fix over the reference: the reference
zeroes the union of every row's end column across the batch)."""

from __future__ import annotations

import dataclasses

import torch

from distllm_tpu_torch.utils import BaseConfig


def average_pool(
    embeddings: torch.Tensor, attention_mask: torch.Tensor
) -> torch.Tensor:
    """Masked fp32 mean over interior tokens: ``[B, S, H]`` -> ``[B, H]``.
    A row with no interior token (zero length, or only start/end) gives
    zeros, not NaN (the denominator is clamped)."""
    mask = torch.as_tensor(attention_mask, device=embeddings.device)
    positions = torch.arange(mask.shape[1], device=mask.device)[None, :]
    lengths = mask.sum(dim=1, keepdim=True)
    interior = mask.bool() & (positions != 0) & (positions != lengths - 1)
    weights = interior.float()
    summed = torch.bmm(weights[:, None, :], embeddings.float())[:, 0]
    denom = weights.sum(dim=1, keepdim=True).clamp(min=1e-9)
    return summed / denom


@dataclasses.dataclass
class MeanPoolerConfig(BaseConfig):
    name: str = 'mean'


class MeanPooler:
    """Averages interior hidden states (no pad/start/end tokens)."""

    def __init__(self, config: MeanPoolerConfig) -> None:
        self.config = config

    def pool(
        self, embeddings: torch.Tensor, attention_mask: torch.Tensor
    ) -> torch.Tensor:
        return average_pool(embeddings, attention_mask)
