"""Full-sequence embedder — the hot loop of the embed pipeline (the
PyTorch counterpart of ``distllm_tpu.embed.embedders.full_sequence``).

- texts are sorted by whitespace length and the original order restored
  afterwards, so each bucketed batch carries little padding;
- a partial final batch is padded to the fixed batch size with fully
  masked rows, so every batch of a bucket has one shape;
- encode + pool + normalise stay on the device; pooled ``[B, H]`` rows
  are gathered into flush groups, and each group is copied to the host
  once, asynchronously (pinned memory, an event per group);
- a background thread tokenizes the next batches while the device runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.embed.embedders.base import EmbedderResult
from distllm_tpu_torch.embed.encoders.base import Encoder
from distllm_tpu_torch.embed.poolers.base import Pooler
from distllm_tpu_torch.utils import BaseConfig, resolve_device

# Batches per flush group (one device concat + one host copy each), and
# how many sealed groups may be in flight before the oldest is drained:
# device residency stays O(FLUSH_EVERY * batch * H), not O(corpus).
FLUSH_EVERY = 64
MAX_RESIDENT_GROUPS = 8


def compute_embeddings(
    texts: list[str],
    encoder: Encoder,
    pooler: Pooler,
    batch_size: int,
    normalize: bool = False,
    tokenize_ahead: int = 2,
    stats: dict | None = None,
    device: 'str | torch.device | None' = None,
) -> np.ndarray:
    """Embed ``texts`` -> host ``[N, H]`` float32 array in original order.

    ``device`` (``None`` = CUDA, raising without it) must be the encoder's.
    Launches are asynchronous: host tokenization of batch *i+1* overlaps
    the device's work on batch *i*. Every ``FLUSH_EVERY`` batches the
    pooled rows are concatenated on the device and copied to pinned host
    memory in one asynchronous copy; at most ``MAX_RESIDENT_GROUPS``
    groups are in flight before the oldest is waited for and drained.
    ``tokenize_ahead`` batches are tokenized on a background thread
    (``0``: inline). ``stats``, when given, receives the bucket telemetry
    of the JAX function: ``tokens_real``, ``tokens_padded`` and
    ``bucket_batches`` (batches dispatched per bucket length).
    """
    device = resolve_device(device)
    if encoder.device != device:
        raise ValueError(f'the encoder runs on {encoder.device}, not {device}')
    n = len(texts)
    out = np.empty((n, encoder.embedding_size), dtype=np.float32)
    if n == 0:
        return out
    order = sorted(range(n), key=lambda i: len(texts[i].split()))
    pending: list[tuple[list[int], torch.Tensor]] = []
    # (indices, host rows, copy-done event or None) per sealed group.
    groups: list[tuple[list[int], torch.Tensor, 'torch.cuda.Event | None']] = []
    fused = encoder.pooled_forward(pooler, normalize)

    def drain_group() -> None:
        idx_all, host, done = groups.pop(0)
        if done is not None:
            done.synchronize()
        out[idx_all] = host.numpy()

    def seal_group() -> None:
        if not pending:
            return
        idx_all = [i for idx, _ in pending for i in idx]
        rows = [dev[: len(idx)] for idx, dev in pending]
        group = torch.cat(rows) if len(rows) > 1 else rows[0]
        if group.device.type == 'cuda':
            host = torch.empty(group.shape, dtype=group.dtype, pin_memory=True)
            host.copy_(group, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = group, None
        groups.append((idx_all, host, done))
        pending.clear()
        while len(groups) > MAX_RESIDENT_GROUPS:
            drain_group()

    def tokenize(lo: int):
        idx = order[lo : lo + batch_size]
        batch = encoder.tokenizer([texts[i] for i in idx])
        return idx, batch.pad_batch_to(batch_size, pad_id=encoder.tokenizer.pad_id)

    starts = list(range(0, n, batch_size))
    if tokenize_ahead > 0 and len(starts) > 1:
        batches = _prefetched(tokenize, starts, tokenize_ahead)
    else:
        batches = (tokenize(s) for s in starts)
    # try/finally: close the prefetch generator (its finally stops the
    # tokenizer thread) even when the loop raises.
    try:
        for idx, batch in batches:
            if stats is not None:
                stats['tokens_real'] = stats.get('tokens_real', 0) + int(
                    batch.attention_mask.sum()
                )
                stats['tokens_padded'] = (
                    stats.get('tokens_padded', 0) + batch.input_ids.size
                )
                hist = stats.setdefault('bucket_batches', {})
                bucket = int(batch.input_ids.shape[1])
                hist[bucket] = hist.get(bucket, 0) + 1
            pending.append((idx, fused(batch)))
            if len(pending) >= FLUSH_EVERY:
                seal_group()
    finally:
        batches.close()
    seal_group()
    while groups:
        drain_group()
    return out


def _prefetched(tokenize, starts, depth):
    """Yield tokenized batches in order, keeping ``depth`` submissions in
    flight on one background thread; the pool is shut down in the
    generator's ``finally``."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        window = [pool.submit(tokenize, s) for s in starts[:depth]]
        for i, _ in enumerate(starts):
            if i + depth < len(starts):
                window.append(pool.submit(tokenize, starts[i + depth]))
            yield window.pop(0).result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


@dataclasses.dataclass
class FullSequenceEmbedderConfig(BaseConfig):
    name: str = 'full_sequence'
    normalize_embeddings: bool = False  # L2-normalise pooled embeddings


class FullSequenceEmbedder:
    def __init__(self, config: FullSequenceEmbedderConfig) -> None:
        self.config = config
        # Bucket telemetry of the last embed call (compute_embeddings' stats).
        self.stats: dict = {}

    def embed(
        self,
        corpus: TextCorpus,
        encoder: Encoder,
        pooler: Pooler,
        batch_size: int,
    ) -> EmbedderResult:
        self.stats = {}
        embeddings = compute_embeddings(
            corpus.texts,
            encoder,
            pooler,
            batch_size,
            normalize=self.config.normalize_embeddings,
            stats=self.stats,
            device=encoder.device,
        )
        return EmbedderResult(
            embeddings=embeddings, text=corpus.texts, metadata=corpus.metadata
        )
