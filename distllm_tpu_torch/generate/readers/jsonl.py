"""Jsonl reader (copy of ``distllm_tpu.generate.readers.jsonl``): one JSON
object a line; ``path_field`` when present, else the file's path."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class JsonlReaderConfig(BaseConfig):
    name: str = 'jsonl'
    text_field: str = 'text'
    path_field: str = 'path'


class JsonlReader:
    def __init__(self, config: JsonlReaderConfig) -> None:
        self.config = config

    def read(self, input_path: str | Path) -> tuple[list[str], list[str]]:
        texts: list[str] = []
        paths: list[str] = []
        with open(input_path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                entry = json.loads(line)
                texts.append(entry[self.config.text_field])
                paths.append(str(entry.get(self.config.path_field, input_path)))
        return texts, paths
