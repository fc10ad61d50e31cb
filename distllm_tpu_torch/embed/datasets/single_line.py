"""Sequence-per-line dataset (copy of
``distllm_tpu.embed.datasets.single_line``): plain text, one item per
stripped non-empty line, after ``header_lines`` skipped lines."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class SequencePerLineDatasetConfig(BaseConfig):
    name: str = 'sequence_per_line'
    header_lines: int = 0
    batch_size: int = 8


class SequencePerLineDataset:
    def __init__(self, config: SequencePerLineDatasetConfig) -> None:
        self.config = config

    def read(self, data_file: 'str | Path') -> TextCorpus:
        lines = Path(data_file).read_text().splitlines()
        texts = [line.strip() for line in lines[self.config.header_lines:] if line.strip()]
        return TextCorpus(texts=texts, metadata=None)
