"""The LitQA task (counterpart of ``distllm_tpu.rag.tasks.litqa``)."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random

from distllm_tpu_torch.rag.tasks.base import (
    QuestionAnswerTask,
    check_str,
    check_str_list,
    entry_from_dict,
)
from distllm_tpu_torch.utils import curl_download

LITQA_URL = 'https://raw.githubusercontent.com/Future-House/LitQA/main/litqa-v0.jsonl'


@dataclasses.dataclass(kw_only=True)
class QuestionAnswerEntry:
    """A multiple-choice entry; ``ideal`` and ``distractors`` lowercased."""

    id: str = ''
    question: str
    ideal: str
    distractors: list[str]
    sources: 'str | list[str]' = ''

    def __post_init__(self) -> None:
        check_str('id', self.id)
        check_str('question', self.question)
        self.ideal = check_str('ideal', self.ideal).lower()
        self.distractors = [v.lower() for v in check_str_list('distractors', self.distractors)]
        if not isinstance(self.sources, str):
            self.sources = check_str_list('sources', self.sources)

    @classmethod
    def from_dict(cls, raw: dict) -> 'QuestionAnswerEntry':
        return entry_from_dict(cls, raw)

    def get_multiple_choice(self, rng: random.Random | None = None) -> str:
        """Three random distractors (padded with '' when fewer) and the
        ideal answer, shuffled, by an RNG seeded from the question's hash,
        so every model of a suite is graded on the same rendering."""
        if rng is None:
            seed = int.from_bytes(
                hashlib.sha256(self.question.encode()).digest()[:8], 'little'
            )
            rng = random.Random(seed)
        k = 3
        distractors = rng.sample(self.distractors, min(k, len(self.distractors)))
        distractors.extend([''] * (k - len(distractors)))
        options = [self.ideal, *distractors]
        rng.shuffle(options)
        mark = '' if self.question.endswith('?') else '?'
        return '{}\nOptions:\n1. {}\n2. {}\n3. {}\n4. {}\n'.format(
            f'{self.question}{mark}', *options
        )


class LitQATask(QuestionAnswerTask):
    task_name = 'litqa'

    def download(self) -> None:
        self.data_file = self.download_dir / 'litqa.jsonl'
        curl_download(LITQA_URL, self.data_file)

    def load_data(self) -> tuple[list[str], list[str]]:
        lines = self.data_file.read_text().strip().split('\n')
        entries = [QuestionAnswerEntry.from_dict(json.loads(line)) for line in lines]
        return [e.get_multiple_choice() for e in entries], [e.ideal for e in entries]
