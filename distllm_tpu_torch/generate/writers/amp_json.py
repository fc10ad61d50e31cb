"""AMP jsonl writer (copy of ``distllm_tpu.generate.writers.amp_json``):
``paths`` carry the original entry JSON; each response (itself JSON, from
the ``amp_question`` postprocess) is merged into its entry and written one
a line; ``merge`` concatenates every shard's files."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from distllm_tpu_torch.utils import BaseConfig


@dataclasses.dataclass
class AMPJsonlWriterConfig(BaseConfig):
    name: str = 'amp_jsonl'
    base_name: str = 'amp_questions'


class AMPJsonlWriter:
    def __init__(self, config: AMPJsonlWriterConfig) -> None:
        self.config = config
        self.current_chunk = 0

    def write(
        self,
        output_dir: str | Path,
        paths: list[str],
        text: list[str],
        responses: list[str],
    ) -> None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        out_path = output_dir / f'{self.config.base_name}_{self.current_chunk}.jsonl'
        with open(out_path, 'w') as fh:
            for original, response in zip(paths, responses):
                entry = json.loads(original)
                entry.update(json.loads(response))
                fh.write(json.dumps(entry) + '\n')
        self.current_chunk += 1

    def merge(self, dataset_dirs: list[str | Path], output_dir: str | Path) -> None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        out_path = output_dir / f'{self.config.base_name}_merged.jsonl'
        with open(out_path, 'w') as fh:
            for shard_dir in dataset_dirs:
                for jsonl in sorted(Path(shard_dir).glob('*.jsonl')):
                    fh.write(jsonl.read_text())
