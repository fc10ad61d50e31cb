"""Reader protocol: ``read(input_path) -> (texts, paths)`` (copy of
``distllm_tpu.generate.readers.base``). ``paths`` carries each item's
provenance (or, for AMP, its whole entry as JSON) through the generation
job to the writer."""

from __future__ import annotations

from pathlib import Path
from typing import Protocol, runtime_checkable


@runtime_checkable
class Reader(Protocol):
    config: object

    def read(self, input_path: str | Path) -> tuple[list[str], list[str]]: ...
