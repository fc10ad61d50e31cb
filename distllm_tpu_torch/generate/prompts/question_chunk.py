"""Question-generation template: one deep question per text chunk (copy of
``distllm_tpu.generate.prompts.question_chunk``). The postprocess
sentence-tokenizes a response with NLTK's untrained Punkt and keeps only
the FIRST sentence ending in '?', or '' when the model produced no
question; ``nltk`` is imported there, so the template builds without it."""

from __future__ import annotations

import dataclasses

from distllm_tpu_torch.generate.prompts.base import ensure_list
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class QuestionChunkPromptTemplateConfig(BaseConfig):
    name: str = 'question_chunk'


class QuestionChunkPromptTemplate:
    template = (
        'You are a scientific researcher. Read the following chunk of text '
        'and write one high-quality question that requires deep understanding '
        'of the concepts it presents. Avoid questions about paper-specific '
        'details such as results, findings, or references.\n\n'
        'Text: {chunk}\nQuestion:'
    )

    def __init__(self, config: QuestionChunkPromptTemplateConfig) -> None:
        self.config = config

    def preprocess(
        self,
        text: str | list[str],
        contexts: list[list[str]] | None = None,
        scores: list[list[float]] | None = None,
    ) -> list[str]:
        return [self.template.format(chunk=chunk) for chunk in ensure_list(text)]

    @staticmethod
    def _first_question(response: str) -> str:
        # Untrained Punkt (default heuristics): no nltk data download.
        import nltk

        tokenizer = nltk.tokenize.PunktSentenceTokenizer()
        for sentence in tokenizer.tokenize(response):
            if sentence.strip().endswith('?'):
                return sentence
        return ''

    def postprocess(self, responses: list[str]) -> list[str]:
        return [self._first_question(r) for r in responses]
