"""Evaluation task interfaces (the PyTorch counterpart of
``distllm_tpu.rag.tasks.base``). ``QuestionAnswerTask`` runs: download
(curl, skipped when the file is there) -> load_data -> ``RagGenerator``
with the ``question_answer`` template -> accuracy and precision, where
precision leaves out abstentions ('I cannot answer.') and keeps each
prediction beside its own ground truth."""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Protocol, runtime_checkable

from distllm_tpu_torch.generate.prompts import get_prompt_template

ABSTAIN_ANSWER = 'I cannot answer.'


def _normalize_answer(text: str) -> str:
    """The question_answer postprocess's normalisation (trailing period
    stripped, lowercased), so an abstention is recognised after it."""
    text = text.strip()
    if text.endswith('.'):
        text = text[:-1]
    return text.lower()


_ABSTAIN_NORMALIZED = _normalize_answer(ABSTAIN_ANSWER)


def entry_from_dict(cls, raw: dict[str, Any]):
    """A task entry dataclass from a dataset row: extra keys ignored (as
    the JAX entry models ignore them), a missing required key or a value
    of another type a ``ValueError``."""
    if not isinstance(raw, dict):
        raise ValueError(f'{cls.__name__} needs a mapping, got {type(raw).__name__}')
    kwargs = {}
    for field in dataclasses.fields(cls):
        if field.name in raw:
            kwargs[field.name] = raw[field.name]
        elif field.default is dataclasses.MISSING and field.default_factory is dataclasses.MISSING:
            raise ValueError(f'{cls.__name__}: missing field {field.name!r}')
    return cls(**kwargs)


def check_str(name: str, value) -> str:
    if not isinstance(value, str):
        raise ValueError(f'{name} must be a string, got {value!r}')
    return value


def check_str_list(name: str, value) -> list[str]:
    if not isinstance(value, (list, tuple)) or not all(isinstance(v, str) for v in value):
        raise ValueError(f'{name} must be a list of strings, got {value!r}')
    return list(value)


@runtime_checkable
class EvaluationTask(Protocol):
    task_name: str

    def __init__(self, download_dir: Path) -> None: ...

    def evaluate(self, generator) -> dict[str, Any]: ...


class QuestionAnswerTask(ABC):
    task_name = ''

    def __init__(self, download_dir: Path) -> None:
        if not self.task_name:
            raise NotImplementedError('task_name must be set in the subclass.')
        self.prompt_template = get_prompt_template({'name': 'question_answer'})
        self.download_dir = Path(download_dir) / self.task_name
        self.download_dir.mkdir(parents=True, exist_ok=True)
        self.data_file: Path | None = None

    @abstractmethod
    def download(self) -> None:
        """Fetch the dataset (nothing when the file is already there)."""

    @abstractmethod
    def load_data(self) -> tuple[list[str], list[str]]:
        """(questions, ground-truth answers)."""

    @staticmethod
    def compute_accuracy(ground_truths: list[str], preds: list[str]) -> float:
        if not ground_truths:
            return 0.0
        correct = sum(g == p for g, p in zip(ground_truths, preds))
        return correct / len(ground_truths)

    def compute_precision(self, ground_truths: list[str], preds: list[str]) -> float:
        """Accuracy over the answered subset: abstentions are left out and
        every remaining prediction stays beside its own ground truth."""
        kept = [
            (g, p) for g, p in zip(ground_truths, preds)
            if _normalize_answer(p) != _ABSTAIN_NORMALIZED
        ]
        return self.compute_accuracy([g for g, _ in kept], [p for _, p in kept])

    def evaluate(self, generator) -> dict[str, float]:
        self.download()
        questions, ground_truths = self.load_data()
        preds = generator.generate(questions, self.prompt_template)
        return {
            'accuracy': self.compute_accuracy(ground_truths, preds),
            'precision': self.compute_precision(ground_truths, preds),
        }
