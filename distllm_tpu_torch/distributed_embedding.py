"""The embedding entry point: embed every input file into its own output
shard (the PyTorch counterpart of ``distllm_tpu.distributed_embedding``).

The YAML config is the JAX package's, key for key, so one file drives
either package. Each file goes through :func:`embedding_worker`: the
registry-warm-started encoder, the dataset read, the embedder, and the
writer into a fresh UUID shard, each stage timed by a ``[timer]`` line
tagged as in the JAX package. The ``local`` compute config runs the files
in this process, ``workstation`` on a process pool of ``max_workers``
(1, the default, runs them in this process too), and the pod configs
(``pod``, ``pbspro``, ``slurm``) on fabric workers, one file a task
(``parallel.launcher``); every worker gets the poison pill at the end.

    python -m distllm_tpu_torch.distributed_embedding --config embed.yaml [--device cpu]

Without ``--device`` the encoder runs on CUDA and the run fails without a
GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import uuid
from pathlib import Path
from typing import Any

import torch

from distllm_tpu_torch.parallel.launcher import get_compute_config, map_with_teardown
from distllm_tpu_torch.timer import Timer
from distllm_tpu_torch.utils import BaseConfig, canonical_function

def log(message: str) -> None:
    print(message, flush=True)


def embedding_worker(
    file: str,
    output_dir: str,
    dataset_kwargs: dict[str, Any],
    encoder_kwargs: dict[str, Any],
    pooler_kwargs: dict[str, Any],
    embedder_kwargs: dict[str, Any],
    writer_kwargs: dict[str, Any],
    device: 'str | torch.device | None' = None,
) -> str:
    """Embed one input file into a fresh UUID output shard; returns the
    shard's path. ``device=None`` means CUDA."""
    from distllm_tpu_torch.embed import (
        get_dataset,
        get_embedder,
        get_encoder,
        get_pooler,
        get_writer,
    )

    file_tag = Path(file).name
    with Timer('loaded-encoder', file_tag):
        encoder = get_encoder(encoder_kwargs, register=True, device=device)
    dataset = get_dataset(dataset_kwargs)
    pooler = get_pooler(pooler_kwargs)
    embedder = get_embedder(embedder_kwargs)
    writer = get_writer(writer_kwargs)

    with Timer('loaded-dataset', file_tag):
        corpus = dataset.read(file)
    with Timer('computed-embeddings', file_tag):
        result = embedder.embed(
            corpus, encoder, pooler, batch_size=dataset.config.batch_size
        )
    shard_dir = Path(output_dir) / uuid.uuid4().hex
    with Timer('wrote-embeddings', file_tag):
        writer.write(shard_dir, result)
    return str(shard_dir)


@dataclasses.dataclass(kw_only=True)
class Config(BaseConfig):
    """The run's configuration: the JAX ``Config``'s fields."""

    input_dir: Path
    output_dir: Path
    glob_patterns: list[str] = dataclasses.field(default_factory=lambda: ['*'])
    dataset_config: dict[str, Any]
    encoder_config: dict[str, Any]
    pooler_config: dict[str, Any]
    embedder_config: dict[str, Any]
    writer_config: dict[str, Any]
    compute_config: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {'name': 'local'}
    )

    def validate(self) -> None:
        self.input_dir = Path(self.input_dir)
        self.output_dir = Path(self.output_dir)
        get_compute_config(self.compute_config)


def run_embedding(
    config: Config, device: 'str | torch.device | None' = None
) -> int:
    """Embed every file matching ``config.glob_patterns`` under
    ``config.input_dir`` into ``output_dir/embeddings/<uuid>/`` on the
    compute config's executor (``device=None`` = CUDA). Returns 0, or 1
    when no file matched."""
    embedding_dir = config.output_dir / 'embeddings'
    embedding_dir.mkdir(parents=True, exist_ok=True)
    # Audit copy, written as JSON: JSON is valid YAML, so either package's
    # Config.from_yaml reads it back, and writing it needs no PyYAML.
    (config.output_dir / 'config.yaml').write_text(
        json.dumps(config.to_dict(), indent=2) + '\n'
    )

    files: list[str] = []
    for pattern in config.glob_patterns:
        files.extend(str(p) for p in sorted(config.input_dir.glob(pattern)))
    if not files:
        log(f'No input files matched {config.glob_patterns} in {config.input_dir}')
        return 1
    log(f'Embedding {len(files)} files -> {embedding_dir}')
    worker_fn = functools.partial(
        # Run as `python -m`, this module is __main__: a fabric worker
        # unpickles the function by its importable path.
        canonical_function(embedding_worker, 'distllm_tpu_torch.distributed_embedding'),
        output_dir=str(embedding_dir),
        dataset_kwargs=config.dataset_config,
        encoder_kwargs=config.encoder_config,
        pooler_kwargs=config.pooler_config,
        embedder_kwargs=config.embedder_config,
        writer_kwargs=config.writer_config,
        device=device,
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
    parser.add_argument(
        '--device', default=None,
        help="device to embed on (default: cuda; 'cpu' only when asked)",
    )
    args = parser.parse_args(argv)
    return run_embedding(Config.from_yaml(args.config), device=args.device)


if __name__ == '__main__':
    raise SystemExit(main())
