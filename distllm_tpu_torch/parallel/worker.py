"""The per-host fabric worker (counterpart of ``distllm_tpu.parallel.worker``).

Started once per host by the scheduler's job script (the rendered PBS /
Slurm script of ``parallel.launcher``) or by hand, as Parsl's
``process_worker_pool`` is started per node::

    python -m distllm_tpu_torch.parallel.worker --coordinator tcp://login-node:5555

Each task's function is resolved by its import path when the payload is
unpickled, so the entry points' workers (``embedding_worker``,
``generate_worker``, ...) run here unchanged; they serve on ``cuda``, one
card of the host, unless the task names the CPU.

``--jax-distributed`` (the JAX flag's name, so a JAX YAML and a rendered
script mean the same thing) first joins this process to a
``torch.distributed`` world through ``parallel.multihost.init_multihost``,
whose topology comes from the ``DISTLLM_JAX_*`` variables the script
exports and the scheduler's rank. ``--distributed-backend`` (default
``nccl``; ``gloo`` for the CPU) is the one flag the JAX worker lacks:
``init_multihost`` never guesses a backend.
"""

from __future__ import annotations

import argparse

from distllm_tpu_torch.observability.instruments import log_event


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description='distllm-tpu-torch fabric worker')
    parser.add_argument('--coordinator', required=True, help='tcp://host:port')
    parser.add_argument('--heartbeat-interval', type=float, default=5.0)
    parser.add_argument(
        '--idle-timeout', type=float, default=900.0,
        help='Exit after this many seconds without coordinator contact '
        '(self-destruct for stragglers that outlive their job).',
    )
    parser.add_argument(
        '--jax-distributed', action='store_true',
        help='Join the torch.distributed world (DISTLLM_JAX_* and the '
        'scheduler rank) before serving.',
    )
    parser.add_argument(
        '--distributed-backend', choices=('nccl', 'gloo'), default='nccl',
        help="backend of the --jax-distributed world (default nccl; gloo on the CPU)",
    )
    args = parser.parse_args(argv)

    if args.jax_distributed:
        from distllm_tpu_torch.parallel.multihost import init_multihost

        rank, size = init_multihost(backend=args.distributed_backend)
        log_event(
            f'[worker] torch.distributed rank {rank}/{size} ({args.distributed_backend})',
            component='worker',
        )

    from distllm_tpu_torch.parallel.fabric import FabricWorker

    worker = FabricWorker(
        args.coordinator,
        heartbeat_interval=args.heartbeat_interval,
        idle_timeout=args.idle_timeout,
    )
    log_event(f'[worker] connected to {args.coordinator}', component='worker')
    worker.run()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
