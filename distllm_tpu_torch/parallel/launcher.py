"""Compute-platform configs: how the embedding entry point's per-file work is
run (counterpart of ``distllm_tpu.parallel.launcher``). ``get_executor``
returns an object with ``.map(fn, items)``:

- :class:`LocalConfig` — the files in this process, one after another;
- :class:`WorkstationConfig` — a spawn process pool on one machine. One
  process should own the GPU, so ``max_workers`` defaults to 1 (the files
  then run in this process); raise it only for pipelines that are bound
  by the host.

The JAX package's pod configs (``pod``, ``pbspro``, ``slurm``) drive its
ZMQ fabric, which is not ported yet: :func:`get_compute_config` refuses
them, naming ROADMAP A11b.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
from pathlib import Path
from typing import Any, Callable, Iterable

from distllm_tpu_torch.utils import BaseConfig

# The JAX package's compute configs that need the fabric (ROADMAP A11b).
FABRIC_CONFIGS = ('pod', 'pbspro', 'slurm')


class SerialExecutor:
    """Run tasks inline: the local platform."""

    def map(self, fn: Callable, items: Iterable[Any]) -> list[Any]:
        return [fn(item) for item in items]


class ProcessPoolMapExecutor:
    """Spawn-based process pool for per-file work bound by the host; one
    worker (or one item) runs inline."""

    def __init__(self, max_workers: int) -> None:
        self.max_workers = max_workers

    def map(self, fn: Callable, items: Iterable[Any]) -> list[Any]:
        items = list(items)
        if self.max_workers <= 1 or len(items) <= 1:
            return [fn(item) for item in items]
        with mp.get_context('spawn').Pool(processes=self.max_workers) as pool:
            return pool.map(fn, items)


@dataclasses.dataclass
class LocalConfig(BaseConfig):
    """One in-process worker."""

    name: str = 'local'

    def get_executor(self, run_dir: 'str | Path') -> SerialExecutor:
        Path(run_dir).mkdir(parents=True, exist_ok=True)
        return SerialExecutor()


@dataclasses.dataclass
class WorkstationConfig(BaseConfig):
    """One machine, an optional process pool."""

    name: str = 'workstation'
    # Worker processes: keep 1 when the work runs on the GPU.
    max_workers: int = 1

    def get_executor(self, run_dir: 'str | Path') -> ProcessPoolMapExecutor:
        Path(run_dir).mkdir(parents=True, exist_ok=True)
        return ProcessPoolMapExecutor(self.max_workers)


ComputeConfigs = LocalConfig | WorkstationConfig


def get_compute_config(kwargs: dict[str, Any]) -> ComputeConfigs:
    """The compute config named by ``kwargs['name']`` (default ``local``)."""
    name = kwargs.get('name', 'local')
    if name in FABRIC_CONFIGS:
        raise NotImplementedError(
            f'compute_config {name!r} needs the ZMQ fabric, which is not ported '
            "to distllm_tpu_torch yet (ROADMAP A11b); use 'local' or 'workstation'"
        )
    for cls in (LocalConfig, WorkstationConfig):
        if name == cls.name:
            return cls(**kwargs)
    raise ValueError(f'Unknown compute config name: {name!r}')
