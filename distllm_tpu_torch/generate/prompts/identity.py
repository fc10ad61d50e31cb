"""Identity template: pass texts through unchanged (copy of
``distllm_tpu.generate.prompts.identity``)."""

from __future__ import annotations

import dataclasses

from distllm_tpu_torch.generate.prompts.base import ensure_list
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class IdentityPromptTemplateConfig(BaseConfig):
    name: str = 'identity'


class IdentityPromptTemplate:
    def __init__(self, config: IdentityPromptTemplateConfig) -> None:
        self.config = config

    def preprocess(
        self,
        text: str | list[str],
        contexts: list[list[str]] | None = None,
        scores: list[list[float]] | None = None,
    ) -> list[str]:
        return ensure_list(text)

    def postprocess(self, responses: list[str]) -> list[str]:
        return responses
