"""HF-dataset generation writer (copy of
``distllm_tpu.generate.writers.huggingface``): ``{path, text, response}``
rows; ``merge`` loads every shard and skips a missing or corrupt one with
a message (partial re-runs rely on this). ``datasets`` is imported in
each method."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class HuggingFaceWriterConfig(BaseConfig):
    name: str = 'huggingface'
    num_proc: int | None = None  # workers for merge's save_to_disk


class HuggingFaceWriter:
    def __init__(self, config: HuggingFaceWriterConfig) -> None:
        self.config = config

    def write(
        self,
        output_dir: str | Path,
        paths: list[str],
        text: list[str],
        responses: list[str],
    ) -> None:
        from datasets import Dataset

        Dataset.from_dict(
            {'path': paths, 'text': text, 'response': responses}
        ).save_to_disk(str(output_dir))

    def merge(self, dataset_dirs: list[str | Path], output_dir: str | Path) -> None:
        from datasets import concatenate_datasets, load_from_disk

        shards = []
        for path in dataset_dirs:
            try:
                shards.append(load_from_disk(str(path)))
            except Exception as exc:  # noqa: BLE001 - a bad shard is skipped
                print(f'[writer] skipping shard {path}: {exc}', flush=True)
        if not shards:
            raise ValueError(f'no readable shards among {len(dataset_dirs)} dirs')
        concatenate_datasets(shards).save_to_disk(
            str(output_dir), num_proc=self.config.num_proc
        )
