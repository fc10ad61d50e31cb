"""Multiple-choice answering template with optional scored retrieval
context (copy of ``distllm_tpu.generate.prompts.question_answer``): the
"Context (with relevance scores)" block, ``[INST]``-tagged answering
instructions, and a postprocess that strips a leading option number
(``1.``-``4.``) and a trailing period and lowercases (the QA tasks grade
on these normalisations)."""

from __future__ import annotations

import dataclasses

from distllm_tpu_torch.generate.prompts.base import ensure_list
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class QuestionAnswerPromptTemplateConfig(BaseConfig):
    name: str = 'question_answer'


class QuestionAnswerPromptTemplate:
    template_with_context = (
        'Context (with relevance scores):\n\n{context}\n\n----\n\n'
        'Question: {question}'
        '[INST] Use the context to answer the question by choosing one of '
        'the options. Do not add the option number or any explanation. '
        'Output your chosen option exactly as presented. [/INST]'
        'Answer: '
    )
    template_no_context = (
        'Question: {question}'
        '[INST] Answer the question by choosing one of the options. '
        'Do not add the option number or any explanation. '
        'Output your chosen option exactly as presented. [/INST]'
        'Answer: '
    )

    def __init__(self, config: QuestionAnswerPromptTemplateConfig) -> None:
        self.config = config

    def preprocess(
        self,
        text: str | list[str],
        contexts: list[list[str]] | None = None,
        scores: list[list[float]] | None = None,
    ) -> list[str]:
        questions = ensure_list(text)
        if contexts is None or scores is None:
            return [self.template_no_context.format(question=q) for q in questions]
        prompts = []
        for question, context, score in zip(questions, contexts, scores):
            block = '\n'.join(
                f'Context: {c}, score: {s}' for c, s in zip(context, score)
            )
            prompts.append(
                self.template_with_context.format(context=block, question=question)
            )
        return prompts

    def postprocess(self, responses: list[str]) -> list[str]:
        out = []
        for response in responses:
            if response[:2] in ('1.', '2.', '3.', '4.'):
                response = response[3:]
            if response and response[-1] == '.':
                response = response[:-1]
            out.append(response.lower())
        return out
