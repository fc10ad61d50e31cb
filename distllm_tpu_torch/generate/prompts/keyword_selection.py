"""Keyword-selection template (copy of
``distllm_tpu.generate.prompts.keyword_selection``): given a fixed keyword
list (inline, or a newline-separated file) and a document, ask the model
for the 3 most relevant keywords."""

from __future__ import annotations

import dataclasses
from pathlib import Path

from distllm_tpu_torch.generate.prompts.base import ensure_list
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass(kw_only=True)
class KeywordSelectionPromptTemplateConfig(BaseConfig):
    name: str = 'keyword_selection'
    # A path to a keyword file (a string is read as a path, as the JAX
    # config's Union[Path, list[str]] reads it), or the keywords.
    keywords: 'Path | list[str]'

    def validate(self) -> None:
        if isinstance(self.keywords, (str, Path)):
            self.keywords = Path(self.keywords)
        elif isinstance(self.keywords, (list, tuple)) and all(
            isinstance(k, str) for k in self.keywords
        ):
            self.keywords = list(self.keywords)
        else:
            raise ValueError('keywords must be a path or a list of strings')


class KeywordSelectionPromptTemplate:
    template = (
        'You are an expert scientist in radiation-based medicine and biology '
        'and all adjacent scientific domains.\n'
        'Given a list of domain keywords and a paragraph, select the 3 '
        'keywords most relevant to the paragraph, ordered by relevance '
        'ascending.\n'
        'The document:\n\n{document}\n\n----\n\n'
        'List of keywords: {keywords_list}\n\n'
        'Write an answer based on the context.\n'
        'If every keyword is equally irrelevant, return the str '
        '`None of the above` 3 times.\n'
        'Answer: '
    )

    def __init__(self, config: KeywordSelectionPromptTemplateConfig) -> None:
        self.config = config
        if isinstance(config.keywords, Path):
            self.keywords_list = config.keywords.read_text().splitlines()
        else:
            self.keywords_list = list(config.keywords)

    def preprocess(
        self,
        text: str | list[str],
        contexts: list[list[str]] | None = None,
        scores: list[list[float]] | None = None,
    ) -> list[str]:
        return [
            self.template.format(keywords_list=self.keywords_list, document=document)
            for document in ensure_list(text)
        ]

    def postprocess(self, responses: list[str]) -> list[str]:
        return responses
