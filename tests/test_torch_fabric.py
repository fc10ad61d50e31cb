"""The port's ZMQ fabric (``distllm_tpu_torch.parallel.fabric``) against the
JAX package's, as ``tests/test_orchestration.py`` pins the JAX fabric:
round trips (each package's coordinator with the other's workers too, the
wire frames being the same), error propagation, heartbeats while idle and
while a long task runs, idle self-destruct, the poison pill, a worker
process killed mid-task and its task requeued; the KV block exchange
between a port and a JAX ``KVBlockServer`` / ``KVBlockClient`` in both
directions, byte for byte; and a ``pod`` ``run_embedding`` over two CPU
worker processes equal to the ``local`` run.

Every wait on a process, socket or thread has its own timeout.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

zmq = pytest.importorskip('zmq')

from distllm_tpu.parallel import fabric as jax_fabric  # noqa: E402
from distllm_tpu_torch.generate.engine import kv_cache  # noqa: E402
from distllm_tpu_torch.parallel import fabric  # noqa: E402
from distllm_tpu_torch.parallel.multihost import free_port  # noqa: E402
from test_torch_fabric_tasks import marked_task  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MAP_TIMEOUT_S = 60.0


def _work(x):
    if x == 'boom':
        raise ValueError('boom')
    return f'done-{x}'


def _slow_task(x):
    time.sleep(1.2)
    return x + 1


def map_bounded(executor, fn, items, timeout=MAP_TIMEOUT_S):
    """``executor.map`` on a thread joined with a timeout: a wedged fabric
    fails the test instead of hanging the run."""
    box: dict = {}

    def run():
        try:
            box['result'] = executor.map(fn, items)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box['error'] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout)
    assert not thread.is_alive(), f'map did not finish in {timeout} s'
    if 'error' in box:
        raise box['error']
    return box['result']


def _thread_workers(module, endpoint, n, **kw):
    workers = [module.FabricWorker(endpoint, **kw) for _ in range(n)]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for t in threads:
        t.start()
    return workers, threads


def _stop(workers, threads):
    for w in workers:
        w.stop()
    for t in threads:
        t.join(timeout=5)


def worker_env(**extra) -> dict:
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join([str(REPO), str(REPO / 'tests')])
    env.update(extra)
    return env


def start_worker_process(endpoint: str, *args: str, log: Path, **env) -> subprocess.Popen:
    """``python -m distllm_tpu_torch.parallel.worker`` in its own process."""
    return subprocess.Popen(
        [sys.executable, '-m', 'distllm_tpu_torch.parallel.worker',
         '--coordinator', endpoint, *args],
        env=worker_env(**env), cwd=REPO, stdout=log.open('w'), stderr=subprocess.STDOUT,
    )


def reap(procs, timeout=20.0) -> list[int]:
    """Wait for each process (killing it past ``timeout``); exit codes."""
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes.append(proc.wait(timeout=10))
    return codes


# ------------------------------------------------------------ the fabric
@pytest.mark.parametrize('coordinator_side,worker_side', [
    ('port', 'port'), ('port', 'jax'), ('jax', 'port'),
])
def test_roundtrip_across_packages(coordinator_side, worker_side):
    coord_mod = fabric if coordinator_side == 'port' else jax_fabric
    worker_mod = fabric if worker_side == 'port' else jax_fabric
    coordinator = coord_mod.Coordinator(bind='tcp://*:0', retries=0,
                                        advertise_host='127.0.0.1')
    workers, threads = _thread_workers(worker_mod, coordinator.endpoint, 2)
    try:
        items = ['a', 'b', 'c', 'd']
        got = map_bounded(coord_mod.ZmqPoolExecutor(coordinator), _work, items)
        assert got == [_work(x) for x in items]
    finally:
        _stop(workers, threads)
        coordinator.close()


def test_errors_propagate_as_jax():
    results = {}
    for name, module in (('port', fabric), ('jax', jax_fabric)):
        coordinator = module.Coordinator(bind='tcp://*:0', retries=0,
                                         advertise_host='127.0.0.1')
        workers, threads = _thread_workers(module, coordinator.endpoint, 1)
        try:
            with pytest.raises(RuntimeError, match='boom') as info:
                map_bounded(module.ZmqPoolExecutor(coordinator), _work, ['a', 'boom'])
            results[name] = str(info.value)
        finally:
            _stop(workers, threads)
            coordinator.close()
    assert results['port'] == results['jax']


def test_retries_rerun_a_failed_task():
    """A failing task goes out again up to ``retries`` times, then its
    error is the result."""
    coordinator = fabric.Coordinator(bind='tcp://*:0', retries=2, advertise_host='127.0.0.1')
    workers, threads = _thread_workers(fabric, coordinator.endpoint, 1)
    try:
        tasks = [fabric._Task(b'boom', pickle.dumps((_work, ('boom',), {})))]
        box: dict = {}
        thread = threading.Thread(target=lambda: box.update(r=coordinator.run(tasks)),
                                  daemon=True)
        thread.start()
        thread.join(MAP_TIMEOUT_S)
        assert not thread.is_alive()
        assert isinstance(box['r'][b'boom'], RuntimeError)
        assert tasks[0].tries == 3
    finally:
        _stop(workers, threads)
        coordinator.close()


def test_idle_worker_heartbeats_survive_a_starved_heartbeat_thread():
    """The idle poll loop sends heartbeats itself (the unfair lock can
    starve the thread); worst case simulated: the thread never sends."""
    router = zmq.Context.instance().socket(zmq.ROUTER)
    port = router.bind_to_random_port('tcp://127.0.0.1')
    worker = fabric.FabricWorker(f'tcp://127.0.0.1:{port}', heartbeat_interval=0.1)
    worker._heartbeat_loop = lambda: None
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    try:
        heartbeats = 0
        deadline = time.monotonic() + 10
        while heartbeats < 2 and time.monotonic() < deadline:
            if router.poll(timeout=200):
                heartbeats += router.recv_multipart()[-1] == fabric._HEARTBEAT
        assert heartbeats >= 2, 'idle worker sent no heartbeats'
    finally:
        worker.stop()
        thread.join(timeout=5)
        router.close(linger=0)


def test_long_tasks_survive_the_heartbeat_threshold():
    """A task 4x the threshold is not reaped: the background thread
    heartbeats while it runs."""
    coordinator = fabric.Coordinator(bind='tcp://*:0', retries=0, heartbeat_threshold=0.3,
                                     advertise_host='127.0.0.1')
    workers, threads = _thread_workers(fabric, coordinator.endpoint, 1, heartbeat_interval=0.05)
    try:
        assert map_bounded(fabric.ZmqPoolExecutor(coordinator), _slow_task, [1]) == [2]
        assert coordinator.requeued == 0
    finally:
        _stop(workers, threads)
        coordinator.close()


@pytest.mark.parametrize('side', ['port', 'jax'])
def test_idle_self_destruct(side):
    module = fabric if side == 'port' else jax_fabric
    worker = module.FabricWorker('tcp://127.0.0.1:1', heartbeat_interval=0.2, idle_timeout=0.6)
    thread = threading.Thread(target=worker.run, daemon=True)
    start = time.monotonic()
    thread.start()
    thread.join(timeout=15)
    assert not thread.is_alive(), 'worker did not self-destruct'
    assert time.monotonic() - start >= 0.6


def test_poison_pill_and_heartbeat_acks():
    """The pill ends a worker without signals, and the coordinator's acks
    keep a live worker's idle clock fresh while it waits for it."""
    coordinator = fabric.Coordinator(bind='tcp://*:0', retries=0, advertise_host='127.0.0.1')
    worker = fabric.FabricWorker(coordinator.endpoint, heartbeat_interval=0.2, idle_timeout=2.0)
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    try:
        executor = fabric.ZmqPoolExecutor(coordinator)
        assert map_bounded(executor, _work, ['x']) == ['done-x']
        coordinator.shutdown_workers(drain_seconds=0.3)
        thread.join(timeout=10)
        assert not thread.is_alive(), 'poison pill did not stop the worker'
    finally:
        worker.stop()
        coordinator.close()


def test_map_with_teardown_pills_workers_when_map_raises():
    coordinator = fabric.Coordinator(bind='tcp://*:0', retries=0, advertise_host='127.0.0.1')
    workers, threads = _thread_workers(fabric, coordinator.endpoint, 1, heartbeat_interval=0.2)
    try:
        box: dict = {}

        executor = fabric.ZmqPoolExecutor(coordinator)
        executor.shutdown = lambda: coordinator.shutdown_workers(drain_seconds=0.3)

        def run():
            try:
                fabric.map_with_teardown(executor, _work, ['boom'])
            except RuntimeError as exc:
                box['error'] = exc

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        thread.join(MAP_TIMEOUT_S)
        assert 'boom' in str(box['error'])
        for worker_thread in threads:
            worker_thread.join(timeout=10)
        assert not any(t.is_alive() for t in threads), 'the pill did not reach the worker'
    finally:
        _stop(workers, threads)
        coordinator.close()


def test_killed_worker_task_is_requeued(tmp_path):
    """Two worker processes; the one that takes the first task is killed
    (SIGKILL) while it runs: the coordinator reaps it past the threshold,
    requeues the task, and the survivor finishes every task once."""
    coordinator = fabric.Coordinator(bind='tcp://*:0', retries=0, heartbeat_threshold=1.0,
                                     advertise_host='127.0.0.1')
    markers = tmp_path / 'markers'
    markers.mkdir()
    procs = [start_worker_process(coordinator.endpoint, '--heartbeat-interval', '0.2',
                                  '--idle-timeout', '60', log=tmp_path / f'w{i}.log')
             for i in range(2)]
    try:
        executor = fabric.ZmqPoolExecutor(coordinator)
        items = [(str(markers), 'victim', 3.0), (str(markers), 'b', 0.1),
                 (str(markers), 'c', 0.1)]
        box: dict = {}
        thread = threading.Thread(
            target=lambda: box.update(r=executor.map(marked_task, items)), daemon=True)
        thread.start()
        deadline = time.monotonic() + 60
        victim = None
        while victim is None and time.monotonic() < deadline:
            found = [p.name for p in markers.iterdir() if p.name.endswith('-victim')]
            victim = int(found[0].split('-')[0]) if found else None
            time.sleep(0.05)
        assert victim is not None, 'no worker started the first task'
        os.kill(victim, signal.SIGKILL)
        thread.join(MAP_TIMEOUT_S)
        assert not thread.is_alive(), 'the run did not finish after the kill'
        results = box['r']
        assert [name for name, _ in results] == ['victim', 'b', 'c']
        assert all(pid != victim for _, pid in results)
        assert coordinator.requeued == 1
        starts = sorted(p.name.split('-', 1)[1] for p in markers.iterdir())
        assert starts == ['b', 'c', 'victim', 'victim']  # the victim task ran twice
        coordinator.shutdown_workers(drain_seconds=0.5)
        codes = reap(procs)
        assert sorted(codes) == [-signal.SIGKILL, 0]
    finally:
        reap(procs, timeout=1)
        coordinator.close()


# ------------------------------------------------------- KV block exchange
def _block_payloads():
    gen = torch.Generator().manual_seed(5)
    k = torch.randn(2, 4, 2, 8, generator=gen)
    v = torch.randn(2, 4, 2, 8, generator=gen)
    kq = torch.randint(-127, 128, (2, 4, 2, 8), generator=gen, dtype=torch.int8)
    scales = torch.rand(2, 2, generator=gen), torch.rand(2, 2, generator=gen)
    return {
        b'\x01' * 32: kv_cache.encode_kvblock(k, v),
        b'\x02' * 32: kv_cache.encode_kvblock(k.bfloat16(), v.bfloat16()),
        b'\x03' * 32: kv_cache.encode_kvblock(kq, kq, *scales),
    }


@pytest.mark.parametrize('server_side,client_side', [('port', 'jax'), ('jax', 'port')])
def test_kvblock_exchange_is_byte_equal(server_side, client_side):
    payloads = _block_payloads()

    def get(digest):
        if digest == b'\xee' * 32:
            raise RuntimeError('handler fault')
        return payloads.get(digest)

    server_mod = fabric if server_side == 'port' else jax_fabric
    client_mod = fabric if client_side == 'port' else jax_fabric
    server = server_mod.KVBlockServer(lambda d: d in payloads, get).start()
    client = client_mod.KVBlockClient(timeout_ms=2000)
    try:
        for digest, payload in payloads.items():
            assert client.request(server.endpoint, b'HAS', digest) == (fabric.KV_HIT, b'')
            status, got = client.request(server.endpoint, b'GET', digest)
            assert status == fabric.KV_HIT and got == payload
            arrays = kv_cache.decode_kvblock(got)
            assert kv_cache.encode_kvblock(*arrays) == payload
        assert client.request(server.endpoint, b'HAS', b'\x09' * 32) == (fabric.KV_MISS, b'')
        assert client.request(server.endpoint, b'GET', b'\x09' * 32) == (fabric.KV_MISS, b'')
        assert client.request(server.endpoint, b'GET', b'\xee' * 32) == (fabric.KV_ERR, b'')
        assert client.request(server.endpoint, b'BAD', b'\x01' * 32) == (fabric.KV_ERR, b'')
        assert server.served_blocks == 3
        assert server.served_bytes == sum(len(p) for p in payloads.values())
    finally:
        client.close()
        server.close()


def test_kvblock_client_times_out_and_recovers():
    """A dead endpoint answers None within the timeout; the client makes a
    fresh socket and the next request to a live server succeeds."""
    client = fabric.KVBlockClient(timeout_ms=200)
    dead = f'tcp://127.0.0.1:{free_port()}'
    start = time.monotonic()
    assert client.request(dead, b'HAS', b'\x01' * 32) is None
    assert time.monotonic() - start < 5
    server = fabric.KVBlockServer(lambda d: True, lambda d: b'x').start()
    try:
        assert client.request(server.endpoint, b'GET', b'\x01' * 32) == (fabric.KV_HIT, b'x')
    finally:
        client.close()
        server.close()


# --------------------------------------------- pod run_embedding on the CPU
def _write_corpus(root: Path) -> None:
    root.mkdir()
    for i in range(4):
        with open(root / f'part{i}.jsonl', 'w') as fh:
            for j in range(3):
                fh.write(json.dumps({'text': f'document {i} chunk {j} words here',
                                     'path': f'doc{i}'}) + '\n')


def _shard_rows(out: Path):
    from datasets import load_from_disk

    rows = []
    for shard in sorted((out / 'embeddings').iterdir()):
        ds = load_from_disk(str(shard))
        rows.extend((r['path'], r['text'], np.asarray(r['embeddings'], np.float32).tobytes())
                    for r in ds)
    return sorted(rows)


def test_pod_run_embedding_equals_local(tmp_path):
    from distllm_tpu_torch import distributed_embedding
    _write_corpus(tmp_path / 'in')
    port = free_port()

    def config(out, compute):
        return distributed_embedding.Config(
            input_dir=tmp_path / 'in', output_dir=out, glob_patterns=['*.jsonl'],
            dataset_config={'name': 'jsonl', 'batch_size': 2},
            encoder_config={'name': 'fake', 'embedding_size': 16},
            pooler_config={'name': 'mean'}, embedder_config={'name': 'full_sequence'},
            writer_config={'name': 'huggingface'}, compute_config=compute,
        )

    # The workers start first (they dial until the pod run binds its
    # coordinator), so their start-up overlaps the local run.
    endpoint = f'tcp://127.0.0.1:{port}'
    procs = [start_worker_process(endpoint, '--heartbeat-interval', '0.5', '--idle-timeout', '60',
                                  log=tmp_path / f'w{i}.log') for i in range(2)]
    try:
        assert distributed_embedding.run_embedding(
            config(tmp_path / 'local', {'name': 'local'}), device='cpu') == 0
        pod = config(tmp_path / 'pod', {'name': 'pod', 'bind_address': endpoint,
                                        'heartbeat_threshold': 30})
        box: dict = {}
        thread = threading.Thread(
            target=lambda: box.update(rc=distributed_embedding.run_embedding(pod, device='cpu')),
            daemon=True)
        thread.start()
        thread.join(MAP_TIMEOUT_S)
        assert not thread.is_alive(), 'the pod run did not finish'
        assert box['rc'] == 0
        # map_with_teardown pilled both workers: they exit 0 on their own.
        assert reap(procs) == [0, 0]
    finally:
        reap(procs, timeout=1)
    assert len(list((tmp_path / 'pod' / 'embeddings').iterdir())) == 4
    assert _shard_rows(tmp_path / 'pod') == _shard_rows(tmp_path / 'local')
