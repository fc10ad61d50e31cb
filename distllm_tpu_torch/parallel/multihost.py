"""Joining ranks into one ``torch.distributed`` world (counterpart of
``distllm_tpu.parallel.multihost``).

:func:`init_multihost` wraps ``torch.distributed.init_process_group``,
as the JAX module wraps ``jax.distributed.initialize``. Topology sources,
in precedence order:

1. Explicit arguments (tests, the generator's own ranks).
2. ``DISTLLM_JAX_COORDINATOR`` / ``DISTLLM_JAX_NUM_PROCESSES`` /
   ``DISTLLM_JAX_PROCESS_ID`` — what the rendered PBS/Slurm pod scripts
   export per host (the process id falls back to the scheduler rank:
   ``SLURM_PROCID``, ``PMI_RANK``, ``PALS_RANKID``).
3. torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
   ``WORLD_SIZE``.

The backend is the caller's (``'nccl'`` or ``'gloo'``), never guessed.

:class:`RankGroup` starts the other ranks of a world from the calling
process, which is rank 0: ``N - 1`` spawned processes, each joined to the
world and handed one end of a pipe, over which rank 0 sends them work
(the tensor-parallel engine's dispatches) and at the end a stop. A pipe
has no timeout, so a rank idles in it as long as rank 0 serves nothing;
the collectives carry the process group's ``timeout``, so a rank that
dies mid-dispatch fails its peers in that time rather than hanging them.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import socket
import traceback

_ENV_COORD = 'DISTLLM_JAX_COORDINATOR'
_ENV_NPROC = 'DISTLLM_JAX_NUM_PROCESSES'
_ENV_PID = 'DISTLLM_JAX_PROCESS_ID'
# Scheduler ranks, in the order the pod launchers start workers.
_RANK_ENVS = (_ENV_PID, 'SLURM_PROCID', 'PMI_RANK', 'PALS_RANKID')
# Seconds a collective may wait for a peer before it fails.
DEFAULT_TIMEOUT_S = 600.0


def _env_rank() -> int | None:
    for var in _RANK_ENVS:
        value = os.environ.get(var)
        if value is not None:
            return int(value)
    return None


def resolve_topology(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[str, int, int]:
    """``(init_method, world_size, rank)`` from the arguments, then the
    ``DISTLLM_JAX_*`` variables and the scheduler ranks, then torchrun's;
    raises ``ValueError`` naming what is missing."""
    env = os.environ
    coordinator_address = coordinator_address or env.get(_ENV_COORD)
    if num_processes is None and env.get(_ENV_NPROC):
        num_processes = int(env[_ENV_NPROC])
    if process_id is None:
        process_id = _env_rank()
    if coordinator_address is None and env.get('MASTER_ADDR'):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and env.get('WORLD_SIZE'):
        num_processes = int(env['WORLD_SIZE'])
    if process_id is None and env.get('RANK'):
        process_id = int(env['RANK'])
    missing = [
        name for name, value in (
            ('coordinator_address', coordinator_address),
            ('num_processes', num_processes), ('process_id', process_id),
        ) if value is None
    ]
    if missing:
        raise ValueError(
            f'init_multihost cannot tell {missing}: pass them, or set '
            f'{_ENV_COORD} / {_ENV_NPROC} / {_ENV_PID} (or a scheduler rank, '
            "or torchrun's MASTER_ADDR / WORLD_SIZE / RANK)"
        )
    # torch wants tcp://host:port; tolerate the bare host:port form.
    address = coordinator_address.removeprefix('tcp://')
    return f'tcp://{address}', int(num_processes), int(process_id)


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> tuple[int, int]:
    """Join this process to the ``torch.distributed`` world; returns
    ``(rank, size)``.

    Idempotent: a second call returns the existing topology instead of
    re-initializing. ``backend`` ('nccl': one rank a CUDA device; 'gloo':
    the CPU, or ranks sharing a card) must be given for a new world."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if backend not in ('nccl', 'gloo'):
        raise ValueError(
            "init_multihost needs backend='nccl' (one rank a CUDA device) or "
            f"'gloo' (the CPU, or ranks sharing a card), got {backend!r}"
        )
    init_method, world, rank = resolve_topology(
        coordinator_address, num_processes, process_id
    )
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dist.get_rank(), dist.get_world_size()


def process_rank() -> tuple[int, int]:
    """(rank, world size) of the current world; ``(0, 1)`` outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _rank_main(rank, world, address, backend, timeout_s, target, args, conn) -> None:
    """A spawned rank: join the world, run ``target(conn, *args)``, and
    send what it returns (or the error) back over the pipe."""
    import torch.distributed as dist

    try:
        init_multihost(address, world, rank, backend=backend, timeout_s=timeout_s)
        reply = ('ok', target(conn, *args))
    except BaseException as exc:  # noqa: BLE001 - reported to rank 0
        reply = ('error', f'rank {rank}: {exc!r}\n{traceback.format_exc()}')
    try:
        conn.send(reply)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


class RankGroup:
    """Ranks ``1..world-1`` of a new world, spawned by the calling process,
    which joins it as rank 0. Each spawned rank runs ``target(conn,
    *args)`` (a module-level function: it is pickled by name) after
    joining; :meth:`send` reaches every one of them (:meth:`send_each`
    each with its own message), :meth:`close` sends
    ``stop`` and returns each rank's reply, joins them within ``join_s``
    (terminating any that outlive it) and leaves the world."""

    def __init__(
        self,
        world: int,
        target,
        args: tuple = (),
        *,
        backend: str,
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            raise RuntimeError(
                'this process already belongs to a torch.distributed world: '
                'a RankGroup starts its own (close the other first)'
            )
        address = f'tcp://localhost:{free_port()}'
        ctx = mp.get_context('spawn')
        self.conns, self.procs = [], []
        for rank in range(1, world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main,
                args=(rank, world, address, backend, timeout_s, target, args, child),
                daemon=True,
            )
            proc.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(proc)
        self.world = world
        try:
            init_multihost(address, world, 0, backend=backend, timeout_s=timeout_s)
        except BaseException:
            self._reap(0.0)
            raise

    def send(self, message) -> None:
        for conn in self.conns:
            conn.send(message)

    def send_each(self, messages) -> None:
        """One message to each spawned rank: ``messages[i]`` to rank
        ``i + 1``."""
        if len(messages) != len(self.conns):
            raise ValueError(f'{len(messages)} messages for {len(self.conns)} ranks')
        for conn, message in zip(self.conns, messages):
            conn.send(message)

    def errors(self) -> list[str]:
        """Errors the spawned ranks reported so far (without waiting)."""
        out = []
        for conn in self.conns:
            try:
                if conn.poll():
                    kind, value = conn.recv()
                    if kind == 'error':
                        out.append(value)
            except (EOFError, OSError):
                out.append('a rank closed its pipe')
        return out

    def close(self, join_s: float = 60.0) -> list:
        """Stop every rank; their replies (``target``'s return values) in
        rank order. Raises if a rank reported an error."""
        import torch.distributed as dist

        replies, errors = [], []
        for conn in self.conns:
            try:
                conn.send(('stop', ()))
            except (BrokenPipeError, OSError):
                pass  # the rank is gone: its reply (if any) is read below
        for conn in self.conns:
            try:
                if not conn.poll(join_s):
                    errors.append(f'a rank sent no reply within {join_s} s')
                    continue
                kind, value = conn.recv()
            except (EOFError, OSError) as exc:
                errors.append(f'a rank closed its pipe: {exc!r}')
                continue
            (errors if kind == 'error' else replies).append(value)
        self._reap(join_s)
        if dist.is_initialized():
            dist.destroy_process_group()
        if errors:
            raise RuntimeError('tensor-parallel ranks failed:\n' + '\n'.join(errors))
        return replies

    def _reap(self, join_s: float) -> None:
        for proc in self.procs:
            proc.join(join_s)
            if proc.is_alive():
                proc.terminate()
                proc.join(5.0)
        for conn in self.conns:
            conn.close()
        self.procs, self.conns = [], []
