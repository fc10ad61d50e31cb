"""Jsonl dataset with sentence splitting and buffered windows (copy of
``distllm_tpu.embed.datasets.jsonl_chunk``): NLTK Punkt sentence spans
(each extended to the start of the next, keeping the whitespace between
sentences), windows of ``buffer_size`` sentences on each side, and buffers
shorter than ``min_buffer_length`` characters dropped. Each buffer's
metadata holds the line's other fields and its ``sentence``, from which
the ``semantic_chunk`` embedder rebuilds chunks. ``nltk`` is imported when
the dataset is built, not with this module."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable

from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.utils import BaseConfig


def split_by_sentence_tokenizer() -> Callable[[str], list[str]]:
    """NLTK Punkt span-based splitter preserving inter-sentence whitespace."""
    import nltk

    tokenizer = nltk.tokenize.PunktSentenceTokenizer()

    def split(text: str) -> list[str]:
        spans = list(tokenizer.span_tokenize(text))
        sentences = []
        for i, (start, _end) in enumerate(spans):
            end = spans[i + 1][0] if i < len(spans) - 1 else len(text)
            sentences.append(text[start:end])
        return sentences

    return split


def sentences_to_buffers(sentences: list[str], buffer_size: int) -> list[str]:
    """Sliding +/-``buffer_size`` sentence windows joined into buffers."""
    buffers = []
    for i in range(len(sentences)):
        lo = max(0, i - buffer_size)
        hi = min(i + 1 + buffer_size, len(sentences))
        buffers.append(''.join(sentences[lo:hi]))
    return buffers


@dataclasses.dataclass
class JsonlChunkDatasetConfig(BaseConfig):
    name: str = 'jsonl_chunk'
    text_field: str = 'text'
    batch_size: int = 8
    # Buffers with fewer characters are dropped (citations and the like).
    min_buffer_length: int = 750
    # Sentences on each side grouped into a buffer window.
    buffer_size: int = 1


class JsonlChunkDataset:
    def __init__(self, config: JsonlChunkDatasetConfig) -> None:
        self.config = config
        self._split = split_by_sentence_tokenizer()

    def read(self, data_file: 'str | Path') -> TextCorpus:
        texts: list[str] = []
        metadata: list[dict] = []
        with open(data_file) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                entry = json.loads(line)
                text = entry[self.config.text_field]
                extra = {k: v for k, v in entry.items() if k != self.config.text_field}
                sentences = self._split(text)
                buffers = sentences_to_buffers(sentences, self.config.buffer_size)
                for sentence, buffer in zip(sentences, buffers):
                    if len(buffer) < self.config.min_buffer_length:
                        continue
                    texts.append(buffer)
                    metadata.append({**extra, 'sentence': sentence})
        return TextCorpus(texts, metadata)
