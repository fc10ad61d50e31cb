"""The embedder's result container (copy of
``distllm_tpu.embed.embedders.base``'s ``EmbedderResult``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EmbedderResult:
    """Pooled embeddings ``[N, H]`` with aligned texts and metadata."""

    embeddings: np.ndarray
    text: list[str]
    metadata: list[dict] | None = None
