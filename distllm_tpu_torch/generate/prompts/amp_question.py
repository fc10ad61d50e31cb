"""AMP protein MCQ-generation template (copy of
``distllm_tpu.generate.prompts.amp_question``): prompt the model for a
protein-function multiple-choice question in a ``Question: ... A) .. B)
.. C) .. D) .. Answer: X)`` layout, then regex-parse the response into
``{full_question_text, correct_answer, distractors}`` JSON (empty fields
when parsing fails)."""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any

from distllm_tpu_torch.generate.prompts.base import ensure_list
from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class AMPQuestionPromptConfig(BaseConfig):
    name: str = 'amp_question'


class AMPQuestionPromptTemplate:
    template = (
        'Generate a biologically accurate multiple-choice question with '
        "exactly one correct answer that explicitly uses the protein name "
        "'{protein_name}', based on this description of its function: "
        "'{function_description}'. Format the output as the question after "
        "'Question:', four short answer options labeled A), B), C), D), and "
        "the correct answer after 'Answer:'. Keep the options concise and "
        'correct.'
    )

    def __init__(self, config: AMPQuestionPromptConfig) -> None:
        self.config = config

    def preprocess(
        self,
        text: str | list[str],
        contexts: list[list[str]] | None = None,
        scores: list[list[float]] | None = None,
    ) -> list[str]:
        prompts = []
        for entry_json in ensure_list(text):
            entry = json.loads(entry_json)
            prompts.append(
                self.template.format(
                    protein_name=entry['Protein_Name'],
                    function_description=entry['Function'],
                )
            )
        return prompts

    @staticmethod
    def _parse(response: str) -> str:
        output: dict[str, Any] = {
            'full_question_text': None,
            'correct_answer': None,
            'distractors': [],
        }
        parts = re.split(r'\n\s*Question:', response, flags=re.IGNORECASE)
        if len(parts) < 2:
            return json.dumps(output)
        body = parts[1].strip()
        answer_match = re.search(r'Answer:\s*([A-D])\)', body)
        answer_label = answer_match.group(1) if answer_match else None
        options_start = re.search(r'\s*\bA\)', body)
        if not options_start:
            return json.dumps(output)
        question_text = body[: options_start.start()].strip()
        options_text = re.sub(
            r'\s*Answer:\s*[A-D]\).*',
            '',
            body[options_start.start() :].strip(),
            flags=re.IGNORECASE,
        ).strip()
        correct = None
        distractors = []
        for option in re.split(r'\s+(?=[A-D]\))', options_text):
            label, option_text = option[:2], option[3:].strip()
            if answer_label is not None and label == f'{answer_label})':
                correct = option_text
            else:
                distractors.append(option_text)
        output['full_question_text'] = f'{question_text} {options_text}'
        output['correct_answer'] = correct
        output['distractors'] = distractors
        return json.dumps(output)

    def postprocess(self, responses: list[str]) -> list[str]:
        return [self._parse(r) for r in responses]
