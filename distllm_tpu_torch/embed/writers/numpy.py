"""Numpy writer: ``embeddings.npy`` / ``text.npy`` / ``metadata.npy``
(copy of ``distllm_tpu.embed.writers.numpy``, the same files, so either
package reads the other's output). Metadata is a pickled object array:
load only shards this program wrote."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from distllm_tpu_torch.embed.embedders.base import EmbedderResult
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class NumpyWriterConfig(BaseConfig):
    name: str = 'numpy'


class NumpyWriter:
    def __init__(self, config: NumpyWriterConfig) -> None:
        self.config = config

    def write(self, output_dir: 'str | Path', result: EmbedderResult) -> None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        np.save(output_dir / 'embeddings.npy', result.embeddings)
        np.save(output_dir / 'text.npy', np.array(result.text, dtype=object))
        if result.metadata is not None:
            np.save(
                output_dir / 'metadata.npy',
                np.array(result.metadata, dtype=object),
            )

    def merge(
        self, dataset_dirs: 'list[str | Path]', output_dir: 'str | Path'
    ) -> None:
        embeddings, texts, metadata = [], [], []
        have_metadata = False
        for path in dataset_dirs:
            path = Path(path)
            embeddings.append(np.load(path / 'embeddings.npy'))
            texts.append(np.load(path / 'text.npy', allow_pickle=True))
            meta_path = path / 'metadata.npy'
            if meta_path.exists():
                have_metadata = True
                metadata.append(np.load(meta_path, allow_pickle=True))
        result = EmbedderResult(
            embeddings=np.concatenate(embeddings, axis=0),
            text=list(np.concatenate(texts, axis=0)),
            metadata=(
                list(np.concatenate(metadata, axis=0)) if have_metadata else None
            ),
        )
        self.write(output_dir, result)
