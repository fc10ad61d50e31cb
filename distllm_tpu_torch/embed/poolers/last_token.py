"""Last-token pooler (SFR-Embedding-Mistral style; the PyTorch counterpart
of ``distllm_tpu.embed.poolers.last_token``): if every row's final
position is valid (a left-padded batch) take position -1, else each row's
last valid token at ``mask.sum(1) - 1``."""

from __future__ import annotations

import dataclasses

import torch

from distllm_tpu_torch.utils import BaseConfig


def last_token_pool(
    last_hidden_states: torch.Tensor, attention_mask: torch.Tensor
) -> torch.Tensor:
    """``[B, S, H]`` -> ``[B, H]`` fp32, the last valid token per row.
    Decided on the device: no host round trip."""
    mask = torch.as_tensor(attention_mask, device=last_hidden_states.device)
    batch = last_hidden_states.shape[0]
    left_padded = mask[:, -1].sum() == batch
    gather_idx = (mask.sum(dim=1) - 1).clamp(min=0)
    rows = torch.arange(batch, device=mask.device)
    gathered = last_hidden_states[rows, gather_idx]
    return torch.where(left_padded, last_hidden_states[:, -1], gathered).float()


@dataclasses.dataclass
class LastTokenPoolerConfig(BaseConfig):
    name: str = 'last_token'


class LastTokenPooler:
    def __init__(self, config: LastTokenPoolerConfig) -> None:
        self.config = config

    def pool(
        self, embeddings: torch.Tensor, attention_mask: torch.Tensor
    ) -> torch.Tensor:
        return last_token_pool(embeddings, attention_mask)
