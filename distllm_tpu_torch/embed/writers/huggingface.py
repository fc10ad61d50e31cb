"""HuggingFace datasets writer (counterpart of
``distllm_tpu.embed.writers.huggingface``): ``write`` builds the dataset
from an in-memory dict (``text``, ``embeddings`` and the metadata keys of
the first row as columns) and saves it; ``merge`` loads every shard,
skips the unreadable ones with a message, concatenates and saves with
``num_proc`` workers. ``datasets`` is imported in each method."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from distllm_tpu_torch.embed.embedders.base import EmbedderResult
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class HuggingFaceWriterConfig(BaseConfig):
    name: str = 'huggingface'
    num_proc: int | None = None  # workers for merge's save_to_disk


class HuggingFaceWriter:
    def __init__(self, config: HuggingFaceWriterConfig) -> None:
        self.config = config

    def write(self, output_dir: 'str | Path', result: EmbedderResult) -> None:
        from datasets import Dataset

        rows: dict[str, list] = {
            'text': list(result.text),
            'embeddings': list(result.embeddings),
        }
        if result.metadata:
            for key in result.metadata[0]:
                rows[key] = [m.get(key) for m in result.metadata]
        Dataset.from_dict(rows).save_to_disk(str(output_dir))

    def merge(
        self, dataset_dirs: 'list[str | Path]', output_dir: 'str | Path'
    ) -> None:
        from datasets import concatenate_datasets, load_from_disk

        shards = []
        for path in dataset_dirs:
            try:
                shards.append(load_from_disk(str(path)))
            except Exception as exc:  # noqa: BLE001 - a bad shard is skipped
                print(f'[writer] skipping shard {path}: {exc}', flush=True)
        if not shards:
            raise ValueError(f'no readable shards among {len(dataset_dirs)} dirs')
        merged = concatenate_datasets(shards)
        merged.save_to_disk(str(output_dir), num_proc=self.config.num_proc)
