"""The AmpQA protein tasks (counterpart of
``distllm_tpu.rag.tasks.protein_qa``): entries whose ideal answer runs past
200 words are left out, the rest rendered as LitQA renders them."""

from __future__ import annotations

import json

from distllm_tpu_torch.rag.tasks.base import QuestionAnswerTask
from distllm_tpu_torch.rag.tasks.litqa import QuestionAnswerEntry
from distllm_tpu_torch.utils import curl_download

FUNCTION_QA_URL = (
    'https://raw.githubusercontent.com/ramanathanlab/AmpQA/main/FunctionQA.jsonl'
)
INTERACTION_QA_URL = (
    'https://raw.githubusercontent.com/ramanathanlab/AmpQA/main/interactionQA.json'
)

_MAX_IDEAL_WORDS = 200


def _to_questions(entries: list[QuestionAnswerEntry]) -> tuple[list[str], list[str]]:
    entries = [e for e in entries if len(e.ideal.split()) <= _MAX_IDEAL_WORDS]
    return [e.get_multiple_choice() for e in entries], [e.ideal for e in entries]


class ProteinFunctionQATask(QuestionAnswerTask):
    task_name = 'protein_function_qa'

    def download(self) -> None:
        self.data_file = self.download_dir / 'functionQA.jsonl'
        curl_download(FUNCTION_QA_URL, self.data_file)

    def load_data(self) -> tuple[list[str], list[str]]:
        lines = self.data_file.read_text().strip().split('\n')
        return _to_questions(
            [QuestionAnswerEntry.from_dict(json.loads(line)) for line in lines]
        )


class ProteinInteractionQATask(QuestionAnswerTask):
    task_name = 'protein_interaction_qa'

    def download(self) -> None:
        self.data_file = self.download_dir / 'interactionQA.json'
        curl_download(INTERACTION_QA_URL, self.data_file)

    def load_data(self) -> tuple[list[str], list[str]]:
        with open(self.data_file) as fh:
            data = json.load(fh)
        return _to_questions([QuestionAnswerEntry.from_dict(entry) for entry in data])
