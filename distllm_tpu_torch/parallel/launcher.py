"""Compute-platform configs: how the entry points' per-file work is run
(counterpart of ``distllm_tpu.parallel.launcher``, field for field).
``get_executor`` returns an object with ``.map(fn, items)``:

- :class:`LocalConfig` — the files in this process, one after another;
- :class:`WorkstationConfig` — a spawn process pool on one machine. One
  process should own the GPU, so ``max_workers`` defaults to 1 (the files
  then run in this process); raise it only for pipelines that are bound
  by the host.
- :class:`PodConfig` — the ZMQ fabric's coordinator
  (``parallel.fabric``) bound in this process; each host runs ``python -m
  distllm_tpu_torch.parallel.worker --coordinator tcp://host:port``.
- :class:`TpuPodPbsConfig` (``pbspro``, the Polaris analogue) and
  :class:`TpuPodSlurmConfig` (``slurm``, the Leonardo analogue) — the
  coordinator in this process, and a PBS / Slurm job script, rendered into
  the run directory and submitted (``submit=False`` renders only), that
  starts one worker per host dialing back to it. The script is the JAX
  package's, line for line, with the worker module renamed.

The entry points reach a pool only through :func:`map_with_teardown`, so
pod workers always get the poison pill. A pod worker serves its tasks on
one card of its host (``cuda``), as the JAX worker embeds on its host's
default device: nothing in either package calls ``Encoder.shard`` on a
worker's encoder. To use every card of a host, start one worker a card.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import subprocess
from pathlib import Path
from typing import Any, Callable, Iterable

from distllm_tpu_torch.observability.instruments import log_event
from distllm_tpu_torch.utils import BaseConfig, lax_bool, lax_float, lax_int, lax_str

WORKER_MODULE = 'distllm_tpu_torch.parallel.worker'


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


def map_with_teardown(executor, fn: Callable, items: Iterable[Any]) -> list[Any]:
    """``executor.map`` that always shuts the pool down afterwards (the JAX
    ``fabric.map_with_teardown``): pod workers get the poison pill even
    when a task exhausts its retries and ``map`` raises, so a failed run
    does not leave the worker job holding its allocation. In-process
    executors have no ``shutdown`` and pass through."""
    try:
        return executor.map(fn, items)
    finally:
        getattr(executor, 'shutdown', lambda: None)()


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


def _coordinator(bind: str, retries: int, heartbeat_threshold: float, advertise_host):
    from distllm_tpu_torch.parallel.fabric import Coordinator

    coordinator = Coordinator(
        bind=bind, retries=retries, heartbeat_threshold=heartbeat_threshold,
        advertise_host=advertise_host,
    )
    log_event(f'[fabric] coordinator at {coordinator.endpoint}', component='fabric')
    return coordinator


@dataclasses.dataclass
class PodConfig(BaseConfig):
    """Several hosts over the ZMQ fabric. The coordinator binds
    ``bind_address`` and advertises ``tcp://<advertise_host>:<port>`` (this
    hostname by default), which workers on other hosts dial. ``retries``
    and ``heartbeat_threshold`` are the reference's Parsl retry and
    heartbeat settings (``parsl.py:197,216-217``)."""

    name: str = 'pod'
    bind_address: str = 'tcp://*:5555'
    # Routable address workers should dial; None = this hostname.
    advertise_host: str | None = None
    retries: int = 1
    heartbeat_threshold: float = 120.0

    def validate(self) -> None:
        self.bind_address = lax_str('bind_address', self.bind_address)
        if self.advertise_host is not None:
            self.advertise_host = lax_str('advertise_host', self.advertise_host)
        self.retries = lax_int('retries', self.retries)
        self.heartbeat_threshold = lax_float('heartbeat_threshold', self.heartbeat_threshold)

    def get_executor(self, run_dir: 'str | Path'):
        from distllm_tpu_torch.parallel.fabric import ZmqPoolExecutor

        Path(run_dir).mkdir(parents=True, exist_ok=True)
        return ZmqPoolExecutor(_coordinator(
            self.bind_address, self.retries, self.heartbeat_threshold, self.advertise_host,
        ))


@dataclasses.dataclass(kw_only=True)
class _BatchSchedulerConfig(BaseConfig):
    """The knobs of a scheduler-submitted pod (the reference's PBSPro and
    Slurm providers, ``distllm/parsl.py:106-252``).

    ``get_executor`` starts the coordinator in this process (the
    reference's interchange also stays on the login node), renders a job
    script that boots one ``distllm_tpu_torch.parallel.worker`` per host
    dialing back to it, writes it into the run directory and submits it.
    ``submit=False`` renders without submitting (dry runs, CI)."""

    account: str
    queue: str
    walltime: str = '01:00:00'
    num_nodes: int = 1
    # Shell run on each host before the worker starts (module loads, venv
    # activation, environment variables).
    worker_init: str = ''
    # Extra verbatim #PBS / #SBATCH directive lines.
    scheduler_options: str = ''
    coordinator_port: int = 5555
    advertise_host: str | None = None
    retries: int = 1
    heartbeat_threshold: float = 120.0
    submit: bool = True
    # Join every host into one torch.distributed world: the script exports
    # DISTLLM_JAX_* and the worker calls parallel.multihost.init_multihost
    # (the JAX field name, so one YAML drives either package).
    jax_distributed: bool = False
    # Port the first host serves the world's rendezvous on.
    jax_coordinator_port: int = 8476

    def validate(self) -> None:
        for key in ('account', 'queue', 'walltime', 'worker_init', 'scheduler_options'):
            setattr(self, key, lax_str(key, getattr(self, key)))
        for key in ('num_nodes', 'coordinator_port', 'retries', 'jax_coordinator_port'):
            setattr(self, key, lax_int(key, getattr(self, key)))
        if self.advertise_host is not None:
            self.advertise_host = lax_str('advertise_host', self.advertise_host)
        self.heartbeat_threshold = lax_float('heartbeat_threshold', self.heartbeat_threshold)
        self.submit = lax_bool('submit', self.submit)
        self.jax_distributed = lax_bool('jax_distributed', self.jax_distributed)

    def _worker_command(self, endpoint: str) -> str:
        cmd = f'python -m {WORKER_MODULE} --coordinator {endpoint}'
        if self.jax_distributed:
            cmd += ' --jax-distributed'
        return cmd

    def render_script(self, endpoint: str, run_dir: Path) -> str:
        raise NotImplementedError

    def _submit_command(self, script_path: Path) -> list[str]:
        raise NotImplementedError

    @property
    def _script_name(self) -> str:
        raise NotImplementedError

    def get_executor(self, run_dir: 'str | Path'):
        from distllm_tpu_torch.parallel.fabric import ZmqPoolExecutor

        run_dir = Path(run_dir)
        run_dir.mkdir(parents=True, exist_ok=True)
        coordinator = _coordinator(
            f'tcp://*:{self.coordinator_port}', self.retries, self.heartbeat_threshold,
            self.advertise_host,
        )
        script_path = run_dir / self._script_name
        script_path.write_text(self.render_script(coordinator.endpoint, run_dir))
        if self.submit:
            proc = subprocess.run(
                self._submit_command(script_path), capture_output=True, text=True,
            )
            if proc.returncode != 0:
                coordinator.close()
                raise RuntimeError(
                    f'job submission failed ({proc.returncode}): '
                    f'{proc.stderr.strip()[-500:]}'
                )
            log_event(f'[fabric] submitted job: {proc.stdout.strip()}', component='fabric')
        return ZmqPoolExecutor(coordinator)


@dataclasses.dataclass(kw_only=True)
class TpuPodPbsConfig(_BatchSchedulerConfig):
    """A PBSPro-submitted pod (the Polaris analogue, ref ``parsl.py:106-
    180``): one fabric worker per host through mpiexec."""

    name: str = 'pbspro'
    # Extra -l select resource suffix; rendered select=<num_nodes><select>.
    select: str = ''

    def validate(self) -> None:
        super().validate()
        self.select = lax_str('select', self.select)

    @property
    def _script_name(self) -> str:
        return 'submit.pbs'

    def _submit_command(self, script_path: Path) -> list[str]:
        return ['qsub', str(script_path)]

    def render_script(self, endpoint: str, run_dir: Path) -> str:
        lines = [
            '#!/bin/bash',
            f'#PBS -A {self.account}',
            f'#PBS -q {self.queue}',
            f'#PBS -l walltime={self.walltime}',
            f'#PBS -l select={self.num_nodes}{self.select}',
            f'#PBS -o {run_dir}/pbs.out',
            f'#PBS -e {run_dir}/pbs.err',
        ]
        if self.scheduler_options:
            lines.extend(self.scheduler_options.splitlines())
        lines += ['', self.worker_init, '']
        if self.jax_distributed:
            lines += [
                '# Global JAX runtime: first pod host runs the coordination',
                '# service; per-rank process id comes from PMI_RANK/',
                '# PALS_RANKID (read by parallel/multihost.py).',
                'export DISTLLM_JAX_COORDINATOR='
                f'"$(head -n1 "$PBS_NODEFILE"):{self.jax_coordinator_port}"',
                f'export DISTLLM_JAX_NUM_PROCESSES={self.num_nodes}',
                '',
            ]
        lines += [
            '# One fabric worker per pod host, dialing the coordinator.',
            f'mpiexec -n {self.num_nodes} --ppn 1 --envall '
            + self._worker_command(endpoint),
            '',
        ]
        return '\n'.join(lines)


@dataclasses.dataclass(kw_only=True)
class TpuPodSlurmConfig(_BatchSchedulerConfig):
    """A Slurm-submitted pod (the Leonardo analogue, ref ``parsl.py:183-
    252``): one fabric worker per host through srun."""

    name: str = 'slurm'
    # Slurm partition (the queue when empty).
    partition: str = ''
    qos: str = ''

    def validate(self) -> None:
        super().validate()
        self.partition = lax_str('partition', self.partition)
        self.qos = lax_str('qos', self.qos)

    @property
    def _script_name(self) -> str:
        return 'submit.sbatch'

    def _submit_command(self, script_path: Path) -> list[str]:
        return ['sbatch', str(script_path)]

    def render_script(self, endpoint: str, run_dir: Path) -> str:
        lines = [
            '#!/bin/bash',
            f'#SBATCH --account={self.account}',
            f'#SBATCH --partition={self.partition or self.queue}',
            f'#SBATCH --time={self.walltime}',
            f'#SBATCH --nodes={self.num_nodes}',
            '#SBATCH --ntasks-per-node=1',
            f'#SBATCH --output={run_dir}/slurm.out',
            f'#SBATCH --error={run_dir}/slurm.err',
        ]
        if self.qos:
            lines.append(f'#SBATCH --qos={self.qos}')
        if self.scheduler_options:
            lines.extend(self.scheduler_options.splitlines())
        lines += ['', self.worker_init, '']
        if self.jax_distributed:
            lines += [
                '# Global JAX runtime: first pod host runs the coordination',
                '# service; per-rank process id comes from SLURM_PROCID',
                '# (read by parallel/multihost.py).',
                'export DISTLLM_JAX_COORDINATOR='
                '"$(scontrol show hostnames "$SLURM_JOB_NODELIST" '
                f'| head -n1):{self.jax_coordinator_port}"',
                f'export DISTLLM_JAX_NUM_PROCESSES={self.num_nodes}',
                '',
            ]
        lines += [
            '# One fabric worker per pod host, dialing the coordinator.',
            f'srun --ntasks={self.num_nodes} --ntasks-per-node=1 '
            + self._worker_command(endpoint),
            '',
        ]
        return '\n'.join(lines)


ComputeConfigs = (
    LocalConfig | WorkstationConfig | PodConfig | TpuPodPbsConfig | TpuPodSlurmConfig
)
_CONFIGS = (LocalConfig, WorkstationConfig, PodConfig, TpuPodPbsConfig, TpuPodSlurmConfig)


def get_compute_config(kwargs: dict[str, Any]) -> ComputeConfigs:
    """The compute config named by ``kwargs['name']`` (default ``local``);
    an unknown name, an unknown key or a missing required one (``account``
    and ``queue`` of the scheduler configs) is a ``ValueError``."""
    name = kwargs.get('name', 'local')
    for cls in _CONFIGS:
        if name == cls.name:
            return cls.from_dict(dict(kwargs))
    raise ValueError(f'Unknown compute config name: {name!r}')
