"""HuggingFace on-disk dataset with selectable metadata columns (copy of
``distllm_tpu.embed.datasets.huggingface``); ``datasets`` is imported in
``read``."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class HuggingFaceDatasetConfig(BaseConfig):
    name: str = 'huggingface'
    text_field: str = 'text'
    metadata_fields: list[str] = dataclasses.field(default_factory=list)
    batch_size: int = 8


class HuggingFaceDataset:
    def __init__(self, config: HuggingFaceDatasetConfig) -> None:
        self.config = config

    def read(self, data_file: 'str | Path') -> TextCorpus:
        from datasets import load_from_disk

        ds = load_from_disk(str(data_file))
        texts = list(ds[self.config.text_field])
        metadata = None
        if self.config.metadata_fields:
            columns = {f: ds[f] for f in self.config.metadata_fields}
            metadata = [
                {f: columns[f][i] for f in self.config.metadata_fields}
                for i in range(len(texts))
            ]
        return TextCorpus(texts=texts, metadata=metadata)
