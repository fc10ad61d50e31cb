"""The tokenization job: tokenize jsonl text files with an HF tokenizer into
``input_ids`` / ``attention_mask`` (and ``labels`` when asked) and save one
HF dataset shard per file (the counterpart of
``distllm_tpu.distributed_tokenization``).

The YAML config is the JAX package's, key for key. Each file goes through
:func:`tokenizer_worker` (stages timed by ``[timer]`` lines tagged as in
the JAX package) on the compute config's executor: ``local`` in this
process, ``workstation`` on a process pool, the pod configs on fabric
workers (each gets the poison pill at the end). The tokenizer is read from local
files. Tokenization runs on the host: there is no ``--device``.

    python -m distllm_tpu_torch.distributed_tokenization --config tok.yaml
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import uuid
from pathlib import Path
from typing import Any

from distllm_tpu_torch.distributed_embedding import log
from distllm_tpu_torch.parallel.launcher import get_compute_config, map_with_teardown
from distllm_tpu_torch.timer import Timer
from distllm_tpu_torch.utils import (
    BaseConfig,
    canonical_function,
    lax_bool,
    lax_int,
    lax_str,
)


@dataclasses.dataclass(kw_only=True)
class TokenizerConfig(BaseConfig):
    """The JAX ``TokenizerConfig``'s fields."""

    tokenizer_name_or_path: str
    text_field: str = 'text'
    max_length: int = 2048
    truncation: bool = True
    padding: bool | str = False
    return_labels: bool = False
    trust_remote_code: bool = False

    def validate(self) -> None:
        lax_str('tokenizer_name_or_path', self.tokenizer_name_or_path)
        lax_str('text_field', self.text_field)
        self.max_length = lax_int('max_length', self.max_length)
        for key in ('truncation', 'return_labels', 'trust_remote_code'):
            setattr(self, key, lax_bool(key, getattr(self, key)))
        if not isinstance(self.padding, (bool, str)):
            raise ValueError(f'padding must be a bool or a string, got {self.padding!r}')


def tokenizer_worker(file: str, output_dir: str, tokenizer_kwargs: dict[str, Any]) -> str:
    """Tokenize one jsonl file into a fresh UUID HF dataset shard; returns
    the shard's path."""
    os.environ.setdefault('TOKENIZERS_PARALLELISM', '0')
    from datasets import Dataset
    from transformers import AutoTokenizer

    config = TokenizerConfig(**tokenizer_kwargs)
    file_tag = Path(file).name
    with Timer('loaded-tokenizer', file_tag):
        tokenizer = AutoTokenizer.from_pretrained(
            config.tokenizer_name_or_path,
            trust_remote_code=config.trust_remote_code,
        )

    with Timer('read-input', file_tag):
        texts = []
        with open(file) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    texts.append(json.loads(line)[config.text_field])

    with Timer('tokenized', file_tag):
        encoded = tokenizer(
            texts,
            truncation=config.truncation,
            max_length=config.max_length,
            padding=config.padding,
        )
        columns: dict[str, Any] = {
            'input_ids': encoded['input_ids'],
            'attention_mask': encoded['attention_mask'],
        }
        if config.return_labels:
            columns['labels'] = [list(row) for row in encoded['input_ids']]

    shard_dir = Path(output_dir) / uuid.uuid4().hex
    with Timer('wrote-dataset', file_tag):
        Dataset.from_dict(columns).save_to_disk(str(shard_dir))
    return str(shard_dir)


@dataclasses.dataclass(kw_only=True)
class Config(BaseConfig):
    """The run's configuration: the JAX ``Config``'s fields."""

    input_dir: Path
    output_dir: Path
    glob_patterns: list[str] = dataclasses.field(default_factory=lambda: ['*.jsonl'])
    tokenizer_config: dict[str, Any]
    compute_config: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {'name': 'local'}
    )

    def validate(self) -> None:
        self.input_dir = Path(self.input_dir)
        self.output_dir = Path(self.output_dir)
        if not isinstance(self.tokenizer_config, dict):
            raise ValueError('tokenizer_config must be a mapping')
        get_compute_config(self.compute_config)


def run_tokenization(config: Config) -> int:
    """Tokenize every file matching ``config.glob_patterns`` under
    ``config.input_dir`` into ``output_dir/tokenized/<uuid>/``. Returns 0,
    or 1 when no file matched."""
    dataset_dir = config.output_dir / 'tokenized'
    dataset_dir.mkdir(parents=True, exist_ok=True)
    # Audit copy, written as JSON: JSON is valid YAML.
    (config.output_dir / 'config.yaml').write_text(
        json.dumps(config.to_dict(), indent=2) + '\n'
    )

    files: list[str] = []
    for pattern in config.glob_patterns:
        files.extend(str(p) for p in sorted(config.input_dir.glob(pattern)))
    if not files:
        log(f'No input files matched {config.glob_patterns} in {config.input_dir}')
        return 1
    log(f'Tokenizing {len(files)} files -> {dataset_dir}')

    worker_fn = functools.partial(
        # Run as `python -m`, this module is __main__: a spawned worker
        # unpickles the function by its importable path.
        canonical_function(tokenizer_worker, 'distllm_tpu_torch.distributed_tokenization'),
        output_dir=str(dataset_dir),
        tokenizer_kwargs=config.tokenizer_config,
    )
    executor = get_compute_config(config.compute_config).get_executor(
        config.output_dir / 'run'
    )
    shards = map_with_teardown(executor, worker_fn, files)
    log(f'Finished: {len(shards)} shards written')
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--config', required=True, type=Path)
    args = parser.parse_args(argv)
    return run_tokenization(Config.from_yaml(args.config))


if __name__ == '__main__':
    raise SystemExit(main())
