"""Generation writer protocol (copy of ``distllm_tpu.generate.writers.base``)."""

from __future__ import annotations

from pathlib import Path
from typing import Protocol, runtime_checkable


@runtime_checkable
class Writer(Protocol):
    config: object

    def write(
        self,
        output_dir: str | Path,
        paths: list[str],
        text: list[str],
        responses: list[str],
    ) -> None: ...

    def merge(self, dataset_dirs: list[str | Path], output_dir: str | Path) -> None: ...
