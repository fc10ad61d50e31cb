"""The SciQ task (counterpart of ``distllm_tpu.rag.tasks.sciq``): all four
options rendered, ground truths lowercased to match the question_answer
postprocess."""

from __future__ import annotations

import dataclasses
import json

from distllm_tpu_torch.rag.tasks.base import QuestionAnswerTask, check_str, entry_from_dict
from distllm_tpu_torch.utils import curl_download

SCIQ_URL = 'https://raw.githubusercontent.com/ogkdmr/sciqa_questions/main/test.json'


@dataclasses.dataclass
class SciQEntry:
    question: str
    distractor1: str
    distractor2: str
    distractor3: str
    correct_answer: str
    support: str = ''

    def __post_init__(self) -> None:
        for field in dataclasses.fields(self):
            check_str(field.name, getattr(self, field.name))

    @classmethod
    def from_dict(cls, raw: dict) -> 'SciQEntry':
        return entry_from_dict(cls, raw)

    def get_multiple_choice(self) -> str:
        mark = '' if self.question.endswith('?') else '?'
        options = [
            self.correct_answer, self.distractor1, self.distractor2, self.distractor3,
        ]
        return '{}\nOptions:\n1. {}\n2. {}\n3. {}\n4. {}\n'.format(
            f'{self.question}{mark}', *options
        )


class SciQTask(QuestionAnswerTask):
    task_name = 'sciq'

    def download(self) -> None:
        self.data_file = self.download_dir / 'sciq.json'
        curl_download(SCIQ_URL, self.data_file)

    def load_data(self) -> tuple[list[str], list[str]]:
        with open(self.data_file) as fh:
            data = json.load(fh)
        entries = [SciQEntry.from_dict(entry) for entry in data]
        return (
            [e.get_multiple_choice() for e in entries],
            [e.correct_answer.lower() for e in entries],
        )
