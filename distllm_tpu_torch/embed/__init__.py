"""Embedding pipeline: datasets -> encoders -> poolers -> embedders ->
writers (the PyTorch counterpart of ``distllm_tpu.embed``), with the same
``{'name': ..., **config}`` strategy factories. Ported strategies:
``jsonl``; ``auto`` (BERT family); ``mean`` and ``last_token``;
``full_sequence``; ``numpy``. The JAX package's other strategies raise
``NotImplementedError`` naming their ROADMAP item."""

from distllm_tpu_torch.embed.datasets import get_dataset
from distllm_tpu_torch.embed.embedders import get_embedder
from distllm_tpu_torch.embed.encoders import get_encoder
from distllm_tpu_torch.embed.poolers import get_pooler
from distllm_tpu_torch.embed.writers import get_writer

__all__ = [
    'get_dataset',
    'get_embedder',
    'get_encoder',
    'get_pooler',
    'get_writer',
]
