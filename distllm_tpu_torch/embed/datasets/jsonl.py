"""Jsonl dataset: one JSON object per line, one text field (copy of
``distllm_tpu.embed.datasets.jsonl``); the other fields become metadata."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class JsonlDatasetConfig(BaseConfig):
    name: str = 'jsonl'
    text_field: str = 'text'
    batch_size: int = 8

    def validate(self) -> None:
        if self.batch_size < 1:
            raise ValueError(f'batch_size must be >= 1, got {self.batch_size}')


class JsonlDataset:
    def __init__(self, config: JsonlDatasetConfig) -> None:
        self.config = config

    def read(self, data_file: 'str | Path') -> TextCorpus:
        texts: list[str] = []
        metadata: list[dict] = []
        with open(data_file) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                entry = json.loads(line)
                texts.append(entry[self.config.text_field])
                metadata.append(
                    {k: v for k, v in entry.items() if k != self.config.text_field}
                )
        return TextCorpus(texts, metadata)
