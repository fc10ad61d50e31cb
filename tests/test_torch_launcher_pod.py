"""The port's pod configs (``distllm_tpu_torch.parallel.launcher``) against
the JAX package's: the same fields and defaults, rendered ``pbspro`` and
``slurm`` scripts equal to JAX's ``render_script`` but for the worker
module's name over a grid of fields, the ``submit=False`` dry run writing
that script, ``submit=True`` running a fake ``qsub`` / ``sbatch`` put on
``PATH`` (and raising on its non-zero exit), and the worker's
``--jax-distributed`` joining a gloo world of one, as
``tests/test_multihost.py`` runs the JAX worker.
"""

from __future__ import annotations

import dataclasses
import itertools
import os

import pytest

pytest.importorskip('zmq')

from distllm_tpu.parallel import launcher as jax_launcher  # noqa: E402
from distllm_tpu_torch.parallel import launcher  # noqa: E402
from distllm_tpu_torch.parallel.multihost import free_port  # noqa: E402
from test_torch_fabric import map_bounded, reap, start_worker_process  # noqa: E402
from test_torch_fabric_tasks import world_report  # noqa: E402

JAX_WORKER = 'distllm_tpu.parallel.worker'
PORT_WORKER = 'distllm_tpu_torch.parallel.worker'
ENDPOINT = 'tcp://login-node:5555'

GRID = list(itertools.product(
    (False, True),  # jax_distributed
    ('', '#PBS -l filesystems=home:eagle\n#SBATCH --exclusive'),  # scheduler_options
    ('', ':ngpus=4'),  # select (pbspro) / qos (slurm)
    ('', 'booster'),  # partition (slurm)
))


def _fields(jax_distributed, options):
    return dict(account='proj', queue='prod', walltime='02:30:00', num_nodes=4,
                worker_init='module load conda; conda activate distllm',
                scheduler_options=options, jax_distributed=jax_distributed,
                jax_coordinator_port=9123, submit=False)


@pytest.mark.parametrize('jax_distributed,options,extra,partition', GRID)
@pytest.mark.parametrize('name', ['pbspro', 'slurm'])
def test_rendered_script_equals_jax(tmp_path, name, jax_distributed, options, extra, partition):
    fields = _fields(jax_distributed, options)
    if name == 'pbspro':
        fields['select'] = extra
        ref = jax_launcher.TpuPodPbsConfig(**fields)
    else:
        fields.update(qos=extra.strip(':'), partition=partition)
        ref = jax_launcher.TpuPodSlurmConfig(**fields)
    port = launcher.get_compute_config({'name': name, **fields})
    want = ref.render_script(ENDPOINT, tmp_path)
    got = port.render_script(ENDPOINT, tmp_path)
    assert JAX_WORKER in want and PORT_WORKER in got
    assert got == want.replace(JAX_WORKER, PORT_WORKER)
    assert ('--jax-distributed' in got) == jax_distributed


@pytest.mark.parametrize('name', ['pod', 'pbspro', 'slurm'])
def test_configs_have_jax_fields_and_defaults(name):
    required = {} if name == 'pod' else {'account': 'a', 'queue': 'q'}
    port = launcher.get_compute_config({'name': name, **required})
    ref = jax_launcher.get_compute_config({'name': name, **required})
    assert port.to_dict() == ref.model_dump()
    # The JAX configs' lax types: numbers and booleans from YAML strings.
    lax = {'retries': '3', 'heartbeat_threshold': '7.5'}
    if name != 'pod':
        lax.update(num_nodes='2', submit='false', jax_distributed='yes')
    assert (launcher.get_compute_config({'name': name, **required, **lax}).to_dict()
            == jax_launcher.get_compute_config({'name': name, **required, **lax}).model_dump())


def test_dry_run_writes_the_script(tmp_path):
    """``submit=False``: the coordinator binds, the script lands in the run
    directory, nothing is submitted; the same file as JAX's but for the
    module name and the two endpoints."""
    written = {}
    for side, module in (('jax', jax_launcher), ('port', launcher)):
        config = module.get_compute_config({
            'name': 'slurm', 'account': 'a', 'queue': 'q', 'submit': False,
            'coordinator_port': free_port(), 'advertise_host': '127.0.0.1',
        })
        executor = config.get_executor(tmp_path / side)
        try:
            text = (tmp_path / side / 'submit.sbatch').read_text()
            written[side] = (text.replace(executor.coordinator.endpoint, 'ENDPOINT')
                             .replace(str(tmp_path / side), 'RUN'))
        finally:
            executor.coordinator.close()
    assert written['port'] == written['jax'].replace(JAX_WORKER, PORT_WORKER)


@pytest.mark.parametrize('name,tool,script', [
    ('pbspro', 'qsub', 'submit.pbs'), ('slurm', 'sbatch', 'submit.sbatch'),
])
def test_submit_runs_the_scheduler_and_raises_on_failure(tmp_path, monkeypatch, name, tool, script):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    fake = bin_dir / tool
    fake.write_text('#!/bin/sh\necho "$@" > "$(dirname "$0")/called"\n'
                    'if [ -n "$FAIL_SUBMIT" ]; then echo "queue closed" >&2; exit 3; fi\n'
                    'echo 4242.server\n')
    fake.chmod(0o755)
    monkeypatch.setenv('PATH', f'{bin_dir}{os.pathsep}{os.environ["PATH"]}')
    fields = {'name': name, 'account': 'a', 'queue': 'q', 'advertise_host': '127.0.0.1'}
    config = launcher.get_compute_config({**fields, 'coordinator_port': free_port()})
    executor = config.get_executor(tmp_path / 'run')
    executor.coordinator.close()
    assert (bin_dir / 'called').read_text().strip() == str(tmp_path / 'run' / script)
    monkeypatch.setenv('FAIL_SUBMIT', '1')
    config = launcher.get_compute_config({**fields, 'coordinator_port': free_port()})
    with pytest.raises(RuntimeError, match=r'job submission failed \(3\): queue closed'):
        config.get_executor(tmp_path / 'run2')


def test_worker_joins_a_gloo_world_of_one(tmp_path):
    """``--jax-distributed`` with the ``DISTLLM_JAX_*`` variables a rendered
    script exports: the worker joins a world of one (gloo on the CPU)
    before serving, and a task reads its rank and all-reduces over it; the
    poison pill then ends it."""
    from distllm_tpu_torch.parallel.fabric import Coordinator, ZmqPoolExecutor

    coordinator = Coordinator(bind='tcp://*:0', advertise_host='127.0.0.1')
    proc = start_worker_process(
        coordinator.endpoint, '--jax-distributed', '--distributed-backend', 'gloo',
        '--heartbeat-interval', '0.5', log=tmp_path / 'worker.log',
        DISTLLM_JAX_COORDINATOR=f'127.0.0.1:{free_port()}',
        DISTLLM_JAX_NUM_PROCESSES='1', DISTLLM_JAX_PROCESS_ID='0',
    )
    try:
        executor = ZmqPoolExecutor(coordinator)
        result = map_bounded(executor, world_report, [[1.0, 2.0]])
        assert result == [(0, 1, 'gloo', [1.0, 2.0])]
        coordinator.shutdown_workers(drain_seconds=0.5)
        assert reap([proc]) == [0]
    finally:
        reap([proc], timeout=1)
        coordinator.close()
    log = (tmp_path / 'worker.log').read_text()
    assert 'torch.distributed rank 0/1 (gloo)' in log


def test_worker_without_a_topology_raises(monkeypatch):
    """No ``DISTLLM_JAX_*``, scheduler rank or torchrun variables: the
    worker refuses to guess a world before it dials the coordinator."""
    from distllm_tpu_torch.parallel import worker

    for key in list(os.environ):
        if key.startswith(('DISTLLM_JAX_', 'SLURM_', 'PMI_', 'PALS_')) or key in (
                'MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
            monkeypatch.delenv(key)
    with pytest.raises(ValueError, match='init_multihost cannot tell'):
        worker.main(['--coordinator', 'tcp://127.0.0.1:1', '--jax-distributed',
                     '--distributed-backend', 'gloo'])


def test_pod_config_fields_round_trip():
    pod = launcher.PodConfig(bind_address='tcp://*:6000', advertise_host='h', retries=2)
    assert dataclasses.replace(pod, retries=3).retries == 3
    with pytest.raises(ValueError):
        launcher.get_compute_config({'name': 'pod', 'nodes': 2})
