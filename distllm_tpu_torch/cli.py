"""Command-line interface of the port (counterpart of ``distllm_tpu.cli``,
the reference's ``distllm`` CLI): the subcommands ``version``, ``embed``,
``merge``, ``generate``, ``tokenize`` and ``chunk_fasta_file`` with the JAX
CLI's arguments and defaults, registered by :mod:`distllm_tpu_torch.cli_commands`
(heavy imports happen when a subcommand runs). ``embed`` and ``generate``
also take ``--device`` (default: cuda; 'cpu' only when asked).

    python -m distllm_tpu_torch.cli <subcommand> ...
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable

_SUBCOMMANDS: dict[str, Callable[[argparse.ArgumentParser], None]] = {}
_RUNNERS: dict[str, Callable[[argparse.Namespace], int | None]] = {}


def subcommand(name: str, help_text: str = ''):
    """Register a CLI subcommand: decorate its parser setup, which returns
    the runner."""

    def deco(setup: Callable[[argparse.ArgumentParser], Callable]):
        def register_parser(sub: argparse.ArgumentParser) -> None:
            _RUNNERS[name] = setup(sub)

        register_parser.help_text = help_text
        _SUBCOMMANDS[name] = register_parser
        return setup

    return deco


def build_parser() -> argparse.ArgumentParser:
    from distllm_tpu_torch import cli_commands  # noqa: F401  (registers them)

    parser = argparse.ArgumentParser(
        prog='distllm-tpu-torch',
        description='The PyTorch / CUDA port of the distllm toolkit.',
    )
    subparsers = parser.add_subparsers(dest='command')
    for name, register_parser in sorted(_SUBCOMMANDS.items()):
        sub = subparsers.add_parser(name, help=getattr(register_parser, 'help_text', ''))
        register_parser(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 2
    return int(_RUNNERS[args.command](args) or 0)


if __name__ == '__main__':
    # Run as `python -m`, this file is __main__: delegate to the importable
    # module so the subcommands register into the same tables.
    from distllm_tpu_torch.cli import main as _canonical_main

    sys.exit(_canonical_main())
