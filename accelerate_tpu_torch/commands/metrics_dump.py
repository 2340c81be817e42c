"""``metrics-dump``: pull-less scraping of a recorded run, the port's copy of
``accelerate_tpu/commands/metrics_dump.py``.

The Prometheus endpoint (``telemetry.exporter``) is for live processes; batch jobs,
bench runs and post-mortems have only the JSONL record stream. This command replays a
recorded stream (files, gzip, rotated sets or a whole telemetry run directory) through
the same :class:`~..telemetry.metrics.MetricsPlane` the live plane uses and prints the
result: Prometheus exposition text by default, or the ``stats()`` JSON.

Offline runs have no live clock: records replay on an ordinal clock (record index) and
the window defaults to the whole stream. ``--window N`` keeps only the trailing N
records' observations.

``--smoke`` runs a miniature gateway workload over the port's ``ContinuousBatcher``
(the ``tiny`` config at fp32 on ``--device``, telemetry to a temp dir, the metrics plane
and the stock alert rules armed), dumps the recorded stream through the offline path,
and exits non-zero unless the aggregates reconcile with the gateway's own accounting and
the clean run fired no alert. Run it as
``python -m accelerate_tpu_torch.commands.metrics_dump <run dir> | --smoke``.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

__all__ = ["metrics_dump_command", "metrics_dump_command_parser",
           "aggregate_records", "run_metrics_smoke"]


def metrics_dump_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = (
        "Aggregate a recorded telemetry JSONL stream through the live metrics "
        "plane and print Prometheus text (or --format json): pull-less "
        "scraping for batch jobs and post-hoc analysis."
    )
    if subparsers is not None:
        parser = subparsers.add_parser("metrics-dump", description=description)
    else:
        parser = argparse.ArgumentParser(
            "python -m accelerate_tpu_torch.commands.metrics_dump",
            description=description
        )
    parser.add_argument(
        "jsonl", nargs="*",
        help="telemetry JSONL input(s): files (.jsonl/.jsonl.gz, rotated sets "
             "welcome) or a telemetry run directory",
    )
    parser.add_argument("--format", choices=("prometheus", "json"),
                        default="prometheus", help="output format")
    parser.add_argument("--window", type=int, default=0, metavar="N",
                        help="sliding-window horizon in records (0 = whole run)")
    parser.add_argument("--smoke", action="store_true",
                        help="self-contained end-to-end smoke: run a tiny "
                             "workload, dump it, verify the aggregates")
    parser.add_argument("--device", default=None,
                        help="the --smoke workload's device (default: the CUDA card; "
                             "'cpu' to run it on the CPU)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable mode: print ONE JSON document "
                             "and nothing else (equivalent to --format json; "
                             "with --smoke, the verdict + plane stats as JSON "
                             "instead of prometheus text + trailer lines)")
    if subparsers is not None:
        parser.set_defaults(func=metrics_dump_command)
    return parser


def aggregate_records(records: List[dict], window: int = 0):
    """A :class:`MetricsPlane` fed the recorded stream on an ordinal clock
    (one tick per record). ``window`` bounds the sliding windows in records;
    0 covers the whole stream."""
    from ..telemetry.metrics import MetricsPlane

    tick = [0.0]
    horizon = float(window) if window else float(len(records) + 1)
    plane = MetricsPlane(enabled=True, clock=lambda: tick[0], window_s=horizon)
    for record in records:
        tick[0] += 1.0
        plane.consume(record)
    return plane


def run_metrics_smoke(verbose: bool = True, as_json: bool = False, device=None) -> int:
    """The ``--smoke`` body: tiny clean gateway workload with the plane and
    stock alert rules armed → record → offline re-aggregation → reconcile.
    Returns a process exit code (non-zero on any broken invariant)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from ..models import llama
    from ..serving import ContinuousBatcher
    from ..serving_gateway import ServingGateway
    from ..telemetry import Telemetry
    from ..telemetry.alerts import AlertEngine, default_alert_rules
    from ..telemetry.exporter import prometheus_text
    from ..telemetry.metrics import M_REQUESTS_TOTAL
    from ..telemetry.schemas import validate_record
    from ..utils.dataclasses import GatewayConfig, TelemetryConfig
    from ..utils.device import resolve_device
    from .trace_report import load_records

    cfg = dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32)
    params = llama.init_params(cfg, device=resolve_device(device))
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as jsonl_dir:
        tel = Telemetry(TelemetryConfig(
            enabled=True, jsonl_dir=jsonl_dir, compile_events=False,
            memory_stats=False, rotate_bytes=8192,
        ))
        gw = ServingGateway(
            ContinuousBatcher(params, cfg, max_slots=2, max_len=64,
                              prompt_bucket=16, telemetry=tel, page_size=8),
            GatewayConfig(enabled=True, metrics=True),
            telemetry=tel,
        )
        alert_engine = AlertEngine(
            gw.metrics, default_alert_rules(objective=0.9, burn_threshold=3.0),
            eval_interval_s=0.0,
        )
        n_requests = 6
        for _ in range(n_requests):
            gw.submit(rng.integers(1, cfg.vocab_size, 6).astype(np.int32),
                      max_new_tokens=4)
        gw.run(report_slo=True)
        live = gw.metrics.stats()
        offline = aggregate_records(load_records(jsonl_dir))

        failures = []
        done_key = f'{M_REQUESTS_TOTAL}{{status="done"}}'
        for name, plane_stats in (("live", live), ("offline", offline.stats())):
            got = plane_stats["counters"].get(done_key, 0)
            if got != n_requests:
                failures.append(
                    f"{name} plane counted {got} done requests, "
                    f"submitted {n_requests}"
                )
        if alert_engine.fired:
            failures.append(f"clean run fired alerts: {alert_engine.fired}")
        bad = [validate_record(r) for r in tel.records]
        bad = [b for b in bad if b]
        if bad:
            failures.append(f"invalid records on the stream: {bad[:3]}")
        text = prometheus_text(offline)
        if done_key not in text:
            failures.append("prometheus dump lacks the done-requests series")
        if as_json:
            # Pure machine mode: verdict + plane state as ONE document —
            # the failures ride inside it, never as bare trailer lines.
            print(json.dumps({
                "ok": not failures,
                "records_consumed": offline.records_consumed,
                "requests": n_requests,
                "alerts_fired": len(alert_engine.fired),
                "failures": failures,
                "stats": offline.stats(),
            }, indent=2, default=float))
            return 1 if failures else 0
        if verbose:
            print(text)
            print(f"metrics-dump --smoke: {offline.records_consumed} records, "
                  f"{n_requests} requests, alerts fired: "
                  f"{len(alert_engine.fired)}")
        for failure in failures:
            print(f"SMOKE FAILURE: {failure}")
        return 1 if failures else 0


def metrics_dump_command(args) -> int:
    import sys

    as_json = getattr(args, "json", False)
    if args.smoke:
        return run_metrics_smoke(as_json=as_json, device=args.device)
    if not args.jsonl:
        print("metrics-dump: provide JSONL input(s) or --smoke",
              file=sys.stderr)
        return 1
    from ..telemetry.exporter import prometheus_text
    from .trace_report import load_records

    records = load_records(args.jsonl)
    if not records:
        print(f"metrics-dump: no records in {args.jsonl}", file=sys.stderr)
        return 1
    plane = aggregate_records(records, window=args.window)
    if as_json or args.format == "json":
        print(json.dumps(plane.stats(), indent=2, default=float))
    else:
        sys.stdout.write(prometheus_text(plane))
    return 0


def main(argv=None) -> int:
    """``python -m accelerate_tpu_torch.commands.metrics_dump``."""
    return metrics_dump_command(metrics_dump_command_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
