"""AMP protein JSON reader (copy of ``distllm_tpu.generate.readers.amp_json``):
the nested JSON maps a group name to a list of entries; each entry,
serialized back to JSON, is both the text and the path, so the writer can
merge the model's output back into it."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class AMPJsonReaderConfig(BaseConfig):
    name: str = 'amp_json'


class AMPJsonReader:
    def __init__(self, config: AMPJsonReaderConfig) -> None:
        self.config = config

    def read(self, input_path: str | Path) -> tuple[list[str], list[str]]:
        with open(input_path) as fh:
            data = json.load(fh)
        texts: list[str] = []
        paths: list[str] = []
        for entries in data.values():
            for entry in entries:
                serialized = json.dumps(entry)
                texts.append(serialized)
                paths.append(serialized)
        return texts, paths
