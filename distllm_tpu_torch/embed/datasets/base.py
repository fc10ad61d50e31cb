"""The corpus a dataset reads from one input file (copy of
``distllm_tpu.embed.datasets.base``'s ``TextCorpus``). Batching and
tokenization happen downstream, in the embedder, with bucketed fixed
shapes."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TextCorpus:
    """Texts plus optional aligned per-text metadata."""

    texts: list[str]
    metadata: list[dict] | None = None

    def __post_init__(self) -> None:
        if self.metadata is not None and len(self.metadata) != len(self.texts):
            raise ValueError(
                f'metadata length {len(self.metadata)} != texts {len(self.texts)}'
            )
