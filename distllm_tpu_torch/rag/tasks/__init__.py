"""Task registry (counterpart of ``distllm_tpu.rag.tasks``)."""

from __future__ import annotations

from pathlib import Path

from distllm_tpu_torch.rag.tasks.base import EvaluationTask, QuestionAnswerTask
from distllm_tpu_torch.rag.tasks.litqa import LitQATask
from distllm_tpu_torch.rag.tasks.protein_qa import (
    ProteinFunctionQATask,
    ProteinInteractionQATask,
)
from distllm_tpu_torch.rag.tasks.pubmedqa import PubmedQATask
from distllm_tpu_torch.rag.tasks.sciq import SciQTask

TASKS: dict[str, type] = {
    'litqa': LitQATask,
    'pubmedqa': PubmedQATask,
    'sciq': SciQTask,
    'protein_function_qa': ProteinFunctionQATask,
    'protein_interaction_qa': ProteinInteractionQATask,
}


def get_task(name: str, download_dir: Path) -> EvaluationTask:
    cls = TASKS.get(name)
    if cls is None:
        raise ValueError(f'Unknown task: {name!r}. Available: {sorted(TASKS)}')
    return cls(download_dir)


__all__ = ['EvaluationTask', 'QuestionAnswerTask', 'TASKS', 'get_task']
