"""CLI root of the port: ``python -m accelerate_tpu_torch <command> [<args>]``, the
counterpart of ``accelerate_tpu/commands/accelerate_cli.py``.

It registers the ported commands: ``capsule-report``, ``config``, ``env``, ``launch``,
``merge-weights``, ``metrics-dump``, ``serve-bench`` and ``trace-report``.
"""

from __future__ import annotations

import argparse

from .capsule_report import capsule_report_command_parser
from .config import config_command_parser
from .env import env_command_parser
from .launch import launch_command_parser
from .merge import merge_command_parser
from .metrics_dump import metrics_dump_command_parser
from .serve_bench import serve_bench_command_parser
from .trace_report import trace_report_command_parser

__all__ = ["main", "get_parser"]


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "python -m accelerate_tpu_torch",
        usage="python -m accelerate_tpu_torch <command> [<args>]",
        allow_abbrev=False,
    )
    subparsers = parser.add_subparsers(help="accelerate_tpu_torch command helpers",
                                       dest="command")
    capsule_report_command_parser(subparsers=subparsers)
    config_command_parser(subparsers=subparsers)
    env_command_parser(subparsers=subparsers)
    launch_command_parser(subparsers=subparsers)
    merge_command_parser(subparsers=subparsers)
    metrics_dump_command_parser(subparsers=subparsers)
    serve_bench_command_parser(subparsers=subparsers)
    trace_report_command_parser(subparsers=subparsers)
    return parser


def main(argv=None) -> int:
    parser = get_parser()
    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return 1
    result = args.func(args)
    return result if isinstance(result, int) else 0


if __name__ == "__main__":
    raise SystemExit(main())
