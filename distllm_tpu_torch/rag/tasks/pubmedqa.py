"""The PubMedQA task (counterpart of ``distllm_tpu.rag.tasks.pubmedqa``)."""

from __future__ import annotations

import dataclasses
import json

from distllm_tpu_torch.rag.tasks.base import (
    QuestionAnswerTask,
    check_str,
    check_str_list,
    entry_from_dict,
)
from distllm_tpu_torch.utils import curl_download

PUBMEDQA_URL = (
    'https://raw.githubusercontent.com/pubmedqa/pubmedqa/master/data/ori_pqal.json'
)


@dataclasses.dataclass
class PubmedQAEntry:
    QUESTION: str
    CONTEXTS: list[str]
    final_decision: str  # yes / no / maybe

    def __post_init__(self) -> None:
        check_str('QUESTION', self.QUESTION)
        self.CONTEXTS = check_str_list('CONTEXTS', self.CONTEXTS)
        check_str('final_decision', self.final_decision)

    @classmethod
    def from_dict(cls, raw: dict) -> 'PubmedQAEntry':
        return entry_from_dict(cls, raw)

    def get_multiple_choice(self) -> str:
        """yes / no / maybe options under the entry's own contexts."""
        mark = '' if self.QUESTION.endswith('?') else '?'
        options = ['yes', 'no', 'maybe']
        joined = '\n'.join(self.CONTEXTS)
        return '{}\n{}\n{}\nOptions:\n1. {}\n2. {}\n3. {}\n'.format(
            'Most relevant context:', joined, f'{self.QUESTION}{mark}', *options
        )


class PubmedQATask(QuestionAnswerTask):
    task_name = 'pubmedqa'

    def download(self) -> None:
        self.data_file = self.download_dir / 'pubmedQA.json'
        curl_download(PUBMEDQA_URL, self.data_file)

    def load_data(self) -> tuple[list[str], list[str]]:
        with open(self.data_file) as fh:
            data = json.load(fh)
        entries = [PubmedQAEntry.from_dict(value) for value in data.values()]
        return (
            [e.get_multiple_choice() for e in entries],
            [e.final_decision for e in entries],
        )
