"""HF-dataset reader (copy of ``distllm_tpu.generate.readers.huggingface``);
``datasets`` is imported in ``read``."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class HuggingFaceReaderConfig(BaseConfig):
    name: str = 'huggingface'
    text_field: str = 'text'
    path_field: str = 'path'


class HuggingFaceReader:
    def __init__(self, config: HuggingFaceReaderConfig) -> None:
        self.config = config

    def read(self, input_path: str | Path) -> tuple[list[str], list[str]]:
        from datasets import load_from_disk

        ds = load_from_disk(str(input_path))
        texts = [str(t) for t in ds[self.config.text_field]]
        if self.config.path_field in ds.column_names:
            paths = [str(p) for p in ds[self.config.path_field]]
        else:
            paths = [str(input_path)] * len(texts)
        return texts, paths
