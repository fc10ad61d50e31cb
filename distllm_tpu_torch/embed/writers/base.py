"""Writer protocol: persist an embedder's result and merge shard outputs
(counterpart of ``distllm_tpu.embed.writers.base``)."""

from __future__ import annotations

from pathlib import Path
from typing import Protocol, runtime_checkable

from distllm_tpu_torch.embed.embedders.base import EmbedderResult


@runtime_checkable
class Writer(Protocol):
    config: object

    def write(self, output_dir: str | Path, result: EmbedderResult) -> None: ...

    def merge(
        self, dataset_dirs: list[str | Path], output_dir: str | Path
    ) -> None: ...
