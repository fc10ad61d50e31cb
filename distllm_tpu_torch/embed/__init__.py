"""Embedding pipeline: datasets -> encoders -> poolers -> embedders ->
writers (the PyTorch counterpart of ``distllm_tpu.embed``), with the same
``{'name': ..., **config}`` strategy factories and every strategy of the
JAX package: datasets ``jsonl``, ``jsonl_chunk``, ``fasta``,
``sequence_per_line``, ``huggingface``; encoders ``auto`` (BERT, ESM-2,
ModernBERT and the decoder families), ``esm2``, ``esmc``, ``fake``;
poolers ``mean``, ``last_token``; embedders ``full_sequence``,
``semantic_chunk``; writers ``numpy``, ``huggingface``."""

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
