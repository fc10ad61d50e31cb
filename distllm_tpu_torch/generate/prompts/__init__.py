"""Prompt template factory (counterpart of ``distllm_tpu.generate.prompts``):
``identity``, ``question_chunk``, ``question_answer`` (the RAG template),
``keyword_selection`` and ``amp_question``, each giving the JAX package's
strings character for character."""

from __future__ import annotations

from typing import Any

from distllm_tpu_torch.embed import _factory
from distllm_tpu_torch.generate.prompts.amp_question import (
    AMPQuestionPromptConfig,
    AMPQuestionPromptTemplate,
)
from distllm_tpu_torch.generate.prompts.base import PromptTemplate
from distllm_tpu_torch.generate.prompts.identity import (
    IdentityPromptTemplate,
    IdentityPromptTemplateConfig,
)
from distllm_tpu_torch.generate.prompts.keyword_selection import (
    KeywordSelectionPromptTemplate,
    KeywordSelectionPromptTemplateConfig,
)
from distllm_tpu_torch.generate.prompts.question_answer import (
    QuestionAnswerPromptTemplate,
    QuestionAnswerPromptTemplateConfig,
)
from distllm_tpu_torch.generate.prompts.question_chunk import (
    QuestionChunkPromptTemplate,
    QuestionChunkPromptTemplateConfig,
)

STRATEGIES: dict[str, tuple[type, type]] = {
    'identity': (IdentityPromptTemplateConfig, IdentityPromptTemplate),
    'question_chunk': (QuestionChunkPromptTemplateConfig, QuestionChunkPromptTemplate),
    'question_answer': (QuestionAnswerPromptTemplateConfig, QuestionAnswerPromptTemplate),
    'keyword_selection': (
        KeywordSelectionPromptTemplateConfig,
        KeywordSelectionPromptTemplate,
    ),
    'amp_question': (AMPQuestionPromptConfig, AMPQuestionPromptTemplate),
}


def get_prompt_template(kwargs: dict[str, Any]) -> PromptTemplate:
    return _factory.build('prompt template', STRATEGIES, kwargs)


__all__ = ['PromptTemplate', 'get_prompt_template', 'STRATEGIES']
