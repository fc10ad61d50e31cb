"""Generator protocol (counterpart of ``distllm_tpu.generate.generators.base``)."""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class LLMGenerator(Protocol):
    config: object

    def generate(self, prompts: str | list[str]) -> list[str]: ...
