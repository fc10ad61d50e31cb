"""Prompt template protocol (copy of ``distllm_tpu.generate.prompts.base``).

``preprocess`` turns raw texts (plus optional retrieval contexts/scores) into
model prompts; ``postprocess`` extracts the useful payload from raw model
responses.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class PromptTemplate(Protocol):
    config: object

    def preprocess(
        self,
        text: str | list[str],
        contexts: list[list[str]] | None = None,
        scores: list[list[float]] | None = None,
    ) -> list[str]: ...

    def postprocess(self, responses: list[str]) -> list[str]: ...


def ensure_list(text: str | list[str]) -> list[str]:
    return [text] if isinstance(text, str) else list(text)
