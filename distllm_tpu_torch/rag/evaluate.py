"""The evaluation suite: every RAG setup on every task (the PyTorch
counterpart of ``distllm_tpu.rag.evaluate``). The YAML is the JAX
package's.

    python -m distllm_tpu_torch.rag.evaluate --config eval.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Any

import torch

from distllm_tpu_torch.distributed_embedding import log
from distllm_tpu_torch.rag.tasks import get_task
from distllm_tpu_torch.utils import BaseConfig, lax_float, lax_int


@dataclasses.dataclass(kw_only=True)
class RetrievalAugmentedGenerationConfig(BaseConfig):
    """One RAG setup: a generator and an optional retriever."""

    generator_config: dict[str, Any]
    retriever_config: dict[str, Any] | None = None
    retrieval_top_k: int = 5
    retrieval_score_threshold: float = 0.0

    def validate(self) -> None:
        if not isinstance(self.generator_config, dict):
            raise ValueError('generator_config must be a mapping')
        if self.retriever_config is not None and not isinstance(self.retriever_config, dict):
            raise ValueError('retriever_config must be a mapping or null')
        self.retrieval_top_k = lax_int('retrieval_top_k', self.retrieval_top_k)
        self.retrieval_score_threshold = lax_float(
            'retrieval_score_threshold', self.retrieval_score_threshold
        )

    def get_rag_generator(
        self, register: bool = True, device: 'str | torch.device | None' = None
    ):
        from distllm_tpu_torch.generate import get_generator
        from distllm_tpu_torch.rag.response_synthesizer import RagGenerator
        from distllm_tpu_torch.rag.search import RetrieverConfig

        generator = get_generator(self.generator_config, register=register, device=device)
        retriever = None
        if self.retriever_config is not None:
            retriever = RetrieverConfig.from_dict(self.retriever_config).get_retriever(
                register=register, device=device
            )
        return RagGenerator(generator=generator, retriever=retriever)


@dataclasses.dataclass(kw_only=True)
class EvalSuiteConfig(BaseConfig):
    rag_configs: list
    tasks: list[str]
    download_dir: Path
    output_path: Path | None = None

    def validate(self) -> None:
        self.rag_configs = [
            c if isinstance(c, RetrievalAugmentedGenerationConfig)
            else RetrievalAugmentedGenerationConfig.from_dict(c)
            for c in self.rag_configs
        ]
        self.download_dir = Path(self.download_dir)
        if self.output_path is not None:
            self.output_path = Path(self.output_path)



def run_eval_suite(
    config: EvalSuiteConfig, device: 'str | torch.device | None' = None
) -> dict[str, dict[str, Any]]:
    """Evaluate every rag_config on every task; returns
    ``{'model_<i>': {task: metrics}}`` and writes it to ``output_path``."""
    results: dict[str, dict[str, Any]] = {}
    for model_idx, rag_config in enumerate(config.rag_configs):
        generator = rag_config.get_rag_generator(device=device)
        for task_name in config.tasks:
            task = get_task(task_name, config.download_dir)
            metrics = task.evaluate(generator)
            results.setdefault(f'model_{model_idx}', {})[task_name] = metrics
            log(f'[eval] model_{model_idx} {task_name}: {metrics}')
    if config.output_path is not None:
        config.output_path.parent.mkdir(parents=True, exist_ok=True)
        config.output_path.write_text(json.dumps(results, indent=2))
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config', required=True, type=Path)
    parser.add_argument(
        '--device', default=None,
        help="device of the engine and the retriever (default: cuda; 'cpu' only when asked)",
    )
    args = parser.parse_args(argv)
    run_eval_suite(EvalSuiteConfig.from_yaml(args.config), device=args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
