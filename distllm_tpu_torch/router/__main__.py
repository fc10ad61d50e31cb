"""The multi-replica router's command line (the flags of the JAX package's
``scripts/router.py``).

    # two replicas, prefix-affinity routing (the default policy)
    python -m distllm_tpu_torch.router --replica http://127.0.0.1:8001 \\
        --replica http://127.0.0.1:8002 --port 8000

    # the round-robin baseline
    python -m distllm_tpu_torch.router --replica http://127.0.0.1:8001 \\
        --replica http://127.0.0.1:8002 --policy round_robin

    # everything from a YAML RouterConfig
    python -m distllm_tpu_torch.router --config router.yaml

The router keeps no state across restarts: the affinity maps re-learn from
the replicas' ``X-Distllm-Prefix-Digest`` headers.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from distllm_tpu_torch.observability import instruments
from distllm_tpu_torch.router.app import POLICIES, RouterConfig, RouterServer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config', type=str, default=None,
                        help='YAML RouterConfig (replicas, policy, knobs)')
    parser.add_argument('--replica', action='append', default=None, metavar='URL',
                        help='replica base URL (repeatable); replaces the '
                             "config file's list when given")
    parser.add_argument('--policy', type=str, default=None, choices=POLICIES)
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--port', type=int, default=8000,
                        help='0 binds a free port, logged on start')
    args = parser.parse_args(argv)

    config = RouterConfig.from_yaml(args.config) if args.config else RouterConfig()
    if args.replica:
        config = dataclasses.replace(config, replicas=tuple(args.replica))
    if args.policy:
        config = dataclasses.replace(config, policy=args.policy)
    if not config.replicas:
        parser.error('at least one --replica (or a config with replicas) is required')
    server = RouterServer(config, host=args.host, port=args.port).start()
    # With --port 0 this line is where a caller reads the port bound.
    instruments.log_event(f'[router] listening on http://{args.host}:{server.port}',
                          component='router')
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
