"""The generation job: generate responses for every input file into its
own output shard (the PyTorch counterpart of
``distllm_tpu.distributed_generation``).

The YAML config is the JAX package's, key for key, so one file drives
either package. Each file goes through :func:`generate_worker`: the
registry-warm-started generator, the reader, the prompt template's
``preprocess``, one ``generate`` call over the file's prompts, the
``postprocess``, and the writer into a fresh UUID shard, each stage timed
by a ``[timer]`` line tagged as in the JAX package. Items whose
postprocessed response is empty are dropped. An ``output_dir`` that
already exists is refused (exit 1), so a finished run is never
clobbered. The ``local`` compute config runs the files in this process,
``workstation`` on a process pool of ``max_workers`` (1, the default,
runs them in this process too), and the pod configs (``pod``,
``pbspro``, ``slurm``) on fabric workers, one file a task; every worker
gets the poison pill at the end.

    python -m distllm_tpu_torch.distributed_generation --config generate.yaml [--device cpu]

Without ``--device`` an engine generator runs on CUDA (or on its
config's ``device``) and the run fails without a GPU.
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

from distllm_tpu_torch.distributed_embedding import log
from distllm_tpu_torch.parallel.launcher import get_compute_config, map_with_teardown
from distllm_tpu_torch.timer import Timer
from distllm_tpu_torch.utils import BaseConfig, canonical_function


def generate_worker(
    file: str,
    output_dir: str,
    reader_kwargs: dict[str, Any],
    prompt_kwargs: dict[str, Any],
    generator_kwargs: dict[str, Any],
    writer_kwargs: dict[str, Any],
    device: 'str | torch.device | None' = None,
) -> str:
    """Generate responses for one input file into a fresh UUID output
    shard; returns the shard's path."""
    from distllm_tpu_torch.generate import (
        get_generator,
        get_prompt_template,
        get_reader,
        get_writer,
    )

    file_tag = Path(file).name
    with Timer('loaded-generator', file_tag):
        generator = get_generator(generator_kwargs, register=True, device=device)
    reader = get_reader(reader_kwargs)
    prompt = get_prompt_template(prompt_kwargs)
    writer = get_writer(writer_kwargs)

    with Timer('read-input', file_tag):
        texts, paths = reader.read(file)
    with Timer('generated-responses', file_tag):
        prompts = prompt.preprocess(texts)
        raw = generator.generate(prompts)
        responses = prompt.postprocess(raw)
    kept = [(p, t, r) for p, t, r in zip(paths, texts, responses) if r]
    paths = [k[0] for k in kept]
    texts = [k[1] for k in kept]
    responses = [k[2] for k in kept]
    shard_dir = Path(output_dir) / uuid.uuid4().hex
    with Timer('wrote-responses', file_tag):
        writer.write(shard_dir, paths, texts, responses)
    return str(shard_dir)


@dataclasses.dataclass(kw_only=True)
class Config(BaseConfig):
    """The run's configuration: the JAX ``Config``'s fields."""

    input_dir: Path
    output_dir: Path
    glob_patterns: list[str] = dataclasses.field(default_factory=lambda: ['*'])
    reader_config: dict[str, Any]
    prompt_config: dict[str, Any]
    generator_config: dict[str, Any]
    writer_config: dict[str, Any]
    compute_config: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {'name': 'local'}
    )

    def validate(self) -> None:
        self.input_dir = Path(self.input_dir)
        self.output_dir = Path(self.output_dir)
        get_compute_config(self.compute_config)


def run_generation(
    config: Config, device: 'str | torch.device | None' = None
) -> int:
    """Generate over every file matching ``config.glob_patterns`` under
    ``config.input_dir`` into ``output_dir/generations/<uuid>/`` on the
    compute config's executor. Returns 0, or 1 when ``output_dir`` already
    exists or no file matched."""
    if config.output_dir.exists():
        log(f'Output directory {config.output_dir} already exists; refusing '
            'to overwrite a finished run.')
        return 1
    generation_dir = config.output_dir / 'generations'
    generation_dir.mkdir(parents=True)
    # Audit copy, written as JSON: JSON is valid YAML, so either package's
    # Config.from_yaml reads it back.
    (config.output_dir / 'config.yaml').write_text(
        json.dumps(config.to_dict(), indent=2) + '\n'
    )

    files: list[str] = []
    for pattern in config.glob_patterns:
        files.extend(str(p) for p in sorted(config.input_dir.glob(pattern)))
    if not files:
        log(f'No input files matched {config.glob_patterns} in {config.input_dir}')
        return 1
    log(f'Generating over {len(files)} files -> {generation_dir}')
    worker_fn = functools.partial(
        # Run as `python -m`, this module is __main__: a fabric worker
        # unpickles the function by its importable path.
        canonical_function(generate_worker, 'distllm_tpu_torch.distributed_generation'),
        output_dir=str(generation_dir),
        reader_kwargs=config.reader_config,
        prompt_kwargs=config.prompt_config,
        generator_kwargs=config.generator_config,
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
        help="device of an engine generator (default: cuda; 'cpu' only when asked)",
    )
    args = parser.parse_args(argv)
    return run_generation(Config.from_yaml(args.config), device=args.device)


if __name__ == '__main__':
    raise SystemExit(main())
