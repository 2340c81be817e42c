"""``trace-report``: per-request timelines from trace spans, the port's copy of
``accelerate_tpu/commands/trace_report.py`` (host-only Python).

Reads telemetry JSONL (a file, a gzip file, a rotated set or a run directory), keeps
the ``trace.span/v1`` records, groups them by ``trace_id`` and decomposes each request's
latency into ``queue_s``, ``prefill_s``, ``handoff_s`` (disaggregated serving's KV page
handoff, with the stall split per role), ``decode_s``, ``host_s`` (the measured
inter-dispatch gap the decode spans carry), ``stall_s`` (lane-holding time outside its
own spans) and ``retry_s``; TTFT is reconstructed from spans alone
(``first_token.t1 − queue.t0``). The report aggregates p50/p95/p99 of each component
over terminal requests, a critical-path share per component and terminal counts.
``train_report`` is the training twin over the MPMD record streams.

The library functions and ``trace_report_command(args)`` (with
``trace_report_command_parser``) are ported; the ``accelerate-tpu`` CLI entry point
that dispatches to them is not yet. Run it as
``python -m accelerate_tpu_torch.commands.trace_report <telemetry.jsonl | run dir>``.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from typing import Dict, Iterable, List

__all__ = ["trace_report", "train_report", "load_spans", "load_records",
           "trace_report_command", "trace_report_command_parser"]

#: The MPMD pipeline's record ids ``train_report`` reads (the JAX package's; nothing
#: in the port emits them until its pipeline-parallel slice).
MPMD_TRANSFER_SCHEMA = "accelerate_tpu.telemetry.mpmd.transfer/v1"
MPMD_BARRIER_SCHEMA = "accelerate_tpu.telemetry.mpmd.barrier/v1"
MPMD_STAGE_STEP_SCHEMA = "accelerate_tpu.telemetry.mpmd.stage_step/v1"


def trace_report_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = (
        "Reconstruct per-request timelines and a critical-path latency breakdown "
        "(queue / prefill / decode / host / stall / retry) from trace.span/v1 records — "
        "or, with --train, per-step MPMD pipeline timelines (stage busy vs "
        "bubble, straggler attribution, crash/replay history) from the "
        "mpmd.stage_step/transfer/barrier record streams."
    )
    if subparsers is not None:
        parser = subparsers.add_parser("trace-report", description=description)
    else:
        parser = argparse.ArgumentParser(
            "accelerate-tpu trace-report", description=description
        )
    parser.add_argument(
        "jsonl", nargs="+",
        help="telemetry JSONL input(s): files (.jsonl or .jsonl.gz, rotated "
             "sets welcome) or a telemetry run directory",
    )
    parser.add_argument("--train", action="store_true",
                        help="training mode: MPMD pipeline timeline report")
    parser.add_argument("--uid", type=int, default=None,
                        help="print one request's full span timeline")
    parser.add_argument("--timelines", type=int, default=0, metavar="N",
                        help="also print the N slowest requests' (or, with "
                             "--train, steps') timelines")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable mode: print ONE JSON document "
                             "(the full report — per-trace/per-step rows "
                             "included) and nothing else; with --uid, that "
                             "request's reconstruction with its raw spans")
    if subparsers is not None:
        parser.set_defaults(func=trace_report_command)
    return parser


def _expand_inputs(paths: Iterable[str]) -> List[str]:
    """Files to read, in chronological order. A directory expands to its
    rotated telemetry set: ``telemetry.<n>.jsonl`` ascending (zero-padded —
    lexical order IS chronological), the active ``telemetry.jsonl`` last."""
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            rolled = sorted(
                glob.glob(os.path.join(path, "telemetry.*.jsonl"))
                + glob.glob(os.path.join(path, "telemetry.*.jsonl.gz"))
            )
            out.extend(rolled)
            active = os.path.join(path, "telemetry.jsonl")
            if os.path.exists(active):
                out.append(active)
        else:
            out.append(path)
    return out


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def load_records(paths, schemas=None) -> List[dict]:
    """Records from one or many JSONL inputs (plain or gzip, file or run
    directory), optionally filtered to a schema-id set. Order is file order —
    rotated sets expand chronologically."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    if schemas is not None:
        schemas = frozenset(schemas)
    records = []
    for path in _expand_inputs(paths):
        with _open_text(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if schemas is None or rec.get("schema") in schemas:
                    records.append(rec)
    return records


def load_spans(path) -> List[dict]:
    """The trace.span/v1 records of one (or many) JSONL input(s) — other
    records are skipped; a telemetry run directory mixes streams by design."""
    from ..telemetry.schemas import TRACE_SPAN_SCHEMA

    return load_records(path, schemas={TRACE_SPAN_SCHEMA})


def _reconstruct(spans: List[dict]) -> dict:
    """One trace's component breakdown from its span set (times relative to the
    trace's first queue-span start)."""
    spans = sorted(spans, key=lambda s: (s["t0"], s["t1"]))
    t_submit = min(s["t0"] for s in spans)
    by_kind: Dict[str, List[dict]] = {}
    for s in spans:
        by_kind.setdefault(s["span"], []).append(s)

    queue_first = [s for s in by_kind.get("queue", ()) if s.get("attempt", 0) == 0]
    queue_retry = [s for s in by_kind.get("queue", ()) if s.get("attempt", 0) > 0]
    prefill = by_kind.get("prefill", ())
    decode = by_kind.get("decode", ())
    handoff = by_kind.get("handoff", ())
    first_token = by_kind.get("first_token", ())
    terminal = by_kind.get("terminal", ())
    admits = by_kind.get("admit", ())

    queue_s = sum(s["dur_s"] for s in queue_first)
    retry_s = sum(s["dur_s"] for s in queue_retry)
    prefill_s = sum(s["dur_s"] for s in prefill)
    decode_s = sum(s["dur_s"] for s in decode)
    handoff_s = sum(s["dur_s"] for s in handoff)
    # TTFT from spans ALONE: first token instant minus submit instant.
    ttft_s = (first_token[0]["t1"] - t_submit) if first_token else None
    t_done = terminal[-1]["t1"] if terminal else max(s["t1"] for s in spans)
    status = terminal[-1].get("status") if terminal else None
    n_tokens = terminal[-1].get("n_tokens") if terminal else None
    # Stall: lane-holding time not inside this request's own prefill/decode/
    # handoff spans — the host loop was admitting/prefilling OTHER requests.
    # Host: the slice of that out-of-span time MEASURED as inter-dispatch gap
    # by the decode spans' ``host_s`` attribute (previous dispatch end → this
    # dispatch start — pure host dead time between HBM-bound dispatches, the
    # component multi-step decode drives toward zero). host_s is CARVED OUT of
    # the stall so host + stall equals the old stall and component shares
    # still sum to 1; the clip to the available stall keeps overlapping-lane
    # accounting honest (every active lane's spans carry the same gap, but a
    # request only owns the part of it not already attributed elsewhere).
    stall_s = host_s = None
    stall_prefill_s = stall_decode_s = None
    host_raw = sum(s.get("host_s") or 0.0 for s in decode)
    if admits:
        running = t_done - admits[0]["t0"] - retry_s
        stall_raw = running - prefill_s - decode_s - handoff_s
        host_s = min(host_raw, max(stall_raw, 0.0))
        stall_s = max(0.0, stall_raw - host_s)
        if handoff:
            # Disaggregated request: the handoff span splits its residency —
            # prefill-replica stall is lane time before the first handoff not
            # inside prefill spans, decode-replica stall is lane time after
            # the last handoff not inside decode spans — so the per-role STALL
            # claim is readable from spans alone (docs/disaggregated_serving.md).
            # Only spans INSIDE each window are subtracted: a re-adoption or
            # src-dead replay puts an earlier stint's prefill/decode spans
            # between the handoffs, and subtracting the request TOTALS would
            # double-count them against the wrong window.
            stall_prefill_s = max(
                0.0,
                (handoff[0]["t0"] - admits[0]["t0"])
                - sum(s["dur_s"] for s in prefill
                      if s["t0"] < handoff[0]["t0"]),
            )
            stall_decode_s = max(
                0.0,
                (t_done - handoff[-1]["t1"])
                - sum(s["dur_s"] for s in decode
                      if s["t0"] >= handoff[-1]["t1"]),
            )
    tpot_s = None
    if first_token and decode and n_tokens and n_tokens > 1:
        tpot_s = max(0.0, decode[-1]["t1"] - first_token[0]["t1"]) / (n_tokens - 1)
    out = {
        "uid": spans[0]["uid"],
        "trace_id": spans[0]["trace_id"],
        "tenant": spans[0].get("tenant"),
        "status": status,
        "reason": terminal[-1].get("reason") if terminal else None,
        "n_tokens": n_tokens,
        "total_s": t_done - t_submit,
        "queue_s": queue_s,
        "retry_s": retry_s,
        "prefill_s": prefill_s,
        "handoff_s": handoff_s,
        "decode_s": decode_s,
        "host_s": host_s,
        "stall_s": stall_s,
        "stall_prefill_s": stall_prefill_s,
        "stall_decode_s": stall_decode_s,
        "handoffs": len(handoff),
        "ttft_s": ttft_s,
        "tpot_s": tpot_s,
        "retries": max((s.get("attempt", 0) for s in by_kind.get("queue", ())),
                       default=0),
        "spans": spans,
    }
    return out


def trace_report(records: List[dict]) -> dict:
    """Aggregate report over span records: per-component p50/p95/p99, critical-
    path shares, terminal counts — plus the per-trace breakdowns under
    ``"traces"`` (span lists stripped; use :func:`_reconstruct` for one trace's
    raw timeline)."""
    from ..telemetry.slo import latency_summary

    by_trace: Dict[str, List[dict]] = {}
    for rec in records:
        tid = rec.get("trace_id")
        if tid is not None:
            by_trace.setdefault(tid, []).append(rec)
    traces = [_reconstruct(spans) for spans in by_trace.values()]
    traces.sort(key=lambda t: t["uid"])

    done = [t for t in traces if t["status"] == "done"]
    components = ("queue_s", "retry_s", "prefill_s", "handoff_s", "decode_s",
                  "host_s", "stall_s")
    breakdown = {
        c: latency_summary([t[c] for t in done]) for c in components
    }
    totals = {c: sum(t[c] or 0.0 for t in done) for c in components}
    grand = sum(totals.values())
    by_status: Dict[str, int] = {}
    for t in traces:
        key = t["status"] or "unknown"
        by_status[key] = by_status.get(key, 0) + 1
    # Per-role stall (disaggregated traces only — requests with a handoff
    # span): where the remaining lane-held-but-idle time lives, prefill
    # replica vs decode replica. The decode share is the number the
    # disaggregation exists to drive down.
    split = [t for t in done if t["stall_prefill_s"] is not None]
    stall_by_role = {
        "n_requests": len(split),
        "prefill_s": round(sum(t["stall_prefill_s"] for t in split), 6),
        "decode_s": round(sum(t["stall_decode_s"] for t in split), 6),
        "prefill_share": (
            round(sum(t["stall_prefill_s"] for t in split) / grand, 4)
            if split and grand > 0 else None
        ),
        "decode_share": (
            round(sum(t["stall_decode_s"] for t in split) / grand, 4)
            if split and grand > 0 else None
        ),
    }
    return {
        "n_traces": len(traces),
        "by_status": by_status,
        "ttft": latency_summary([t["ttft_s"] for t in done]),
        "tpot": latency_summary([t["tpot_s"] for t in done]),
        "breakdown": breakdown,
        "critical_path_share": {
            c: round(totals[c] / grand, 4) if grand > 0 else None
            for c in components
        },
        "stall_by_role": stall_by_role,
        "traces": [
            {k: v for k, v in t.items() if k != "spans"} for t in traces
        ],
    }


# ------------------------------------------------------------------ train mode
def train_report(records: List[dict]) -> dict:
    """The MPMD pipeline timeline report, from records alone.

    Per training step, the per-stage ``mpmd.stage_step/v1`` records decompose
    the step's wall span (first ``t0`` → last ``t1`` across stages) into BUSY
    (fenced fwd/bwd/apply compute, as measured by the stage itself) and
    BUBBLE (span minus busy — the stage held its devices but ran nothing:
    pipeline fill/drain, waiting on a peer's microbatch, a straggler's
    backward). Per stage, ``busy_share + bubble_share == 1`` by construction.

    Straggler attribution follows the multi-slice tuning playbook: the
    straggler is the stage with the highest p95 busy time, reported against
    the fleet median busy time (``straggler_p95_vs_fleet_median``) — >1 means
    that stage bounds the pipeline.

    A step re-executed after crash recovery appears twice in the stream; the
    LAST record per (step, stage) — the surviving lineage — wins, and the
    overwritten attempts are counted as ``replayed_cells``. The recovery
    timeline itself (which gang crashed at which step, who held, where the
    replay restored to) is rebuilt from the ``mpmd.barrier/v1`` +
    ``pipeline_replay`` recovery + ``elastic.restart/v1`` records.
    """
    from ..telemetry.schemas import ELASTIC_RESTART_SCHEMA, RECOVERY_SCHEMA
    from ..telemetry.slo import latency_summary, percentile

    cells: Dict[tuple, dict] = {}       # (step, stage) → last record
    replayed_cells = 0
    transfers: List[dict] = []
    barriers: List[dict] = []
    restarts: List[dict] = []
    replays: List[dict] = []
    for rec in records:
        schema = rec.get("schema")
        if schema == MPMD_STAGE_STEP_SCHEMA:
            key = (rec["step"], rec["stage"])
            if key in cells:
                replayed_cells += 1
            cells[key] = rec
        elif schema == MPMD_TRANSFER_SCHEMA:
            transfers.append(rec)
        elif schema == MPMD_BARRIER_SCHEMA:
            barriers.append(rec)
        elif schema == ELASTIC_RESTART_SCHEMA:
            restarts.append(rec)
        elif schema == RECOVERY_SCHEMA and rec.get("action") == "pipeline_replay":
            replays.append(rec)

    stages = sorted({stage for _, stage in cells})
    steps = sorted({step for step, _ in cells})
    # Per-step spans and per-stage busy/bubble decomposition.
    per_step: List[dict] = []
    busy_by_stage: Dict[int, List[float]] = {s: [] for s in stages}
    bubble_by_stage: Dict[int, float] = {s: 0.0 for s in stages}
    for step in steps:
        row = {s: cells[(step, s)] for s in stages if (step, s) in cells}
        t0 = min(r["t0"] for r in row.values())
        t1 = max(r["t1"] for r in row.values())
        span = max(t1 - t0, 0.0)
        stage_rows = {}
        for s, r in row.items():
            busy = min(r["busy_s"], span) if span > 0 else r["busy_s"]
            busy_by_stage[s].append(r["busy_s"])
            bubble_by_stage[s] += max(span - busy, 0.0)
            stage_rows[s] = {
                "busy_s": round(r["busy_s"], 9),
                "bubble_s": round(max(span - busy, 0.0), 9),
                "fwd_s": r.get("fwd_s"),
                "bwd_s": r.get("bwd_s"),
                "apply_s": r.get("apply_s"),
            }
        per_step.append({
            "step": step,
            "span_s": round(span, 9),
            "stages": stage_rows,
        })

    stage_summary = {}
    all_busy: List[float] = []
    for s in stages:
        busy_total = sum(busy_by_stage[s])
        bubble_total = bubble_by_stage[s]
        held = busy_total + bubble_total
        all_busy.extend(busy_by_stage[s])
        stage_summary[s] = {
            "steps": len(busy_by_stage[s]),
            "busy_s": round(busy_total, 9),
            "bubble_s": round(bubble_total, 9),
            # The per-stage decomposition: these two sum to 1 by construction
            # (busy + bubble IS the stage's held span).
            "busy_share": round(busy_total / held, 6) if held > 0 else None,
            "bubble_share": round(bubble_total / held, 6) if held > 0 else None,
            "busy": latency_summary(busy_by_stage[s]),
        }
    total_busy = sum(sum(v) for v in busy_by_stage.values())
    total_bubble = sum(bubble_by_stage.values())
    total_held = total_busy + total_bubble

    straggler = None
    if stages and all_busy:
        p95_by_stage = {
            s: percentile(busy_by_stage[s], 95)
            for s in stages if busy_by_stage[s]
        }
        worst = max(p95_by_stage, key=p95_by_stage.get)
        fleet_median = percentile(all_busy, 50)
        straggler = {
            "stage": worst,
            "p95_busy_s": round(p95_by_stage[worst], 9),
            "fleet_median_busy_s": round(fleet_median, 9),
            "straggler_p95_vs_fleet_median": (
                round(p95_by_stage[worst] / fleet_median, 4)
                if fleet_median > 0 else None
            ),
        }

    # DCN accounting by direction.
    dcn = {}
    for direction in ("fwd", "bwd"):
        mine = [t for t in transfers if t.get("direction") == direction]
        dcn[direction] = {
            "transfers": len(mine),
            "bytes": sum(int(t.get("nbytes") or 0) for t in mine),
            "latency": latency_summary([t.get("dur_s") for t in mine]),
        }

    # Recovery timeline, in record order: a hold set (holding gangs + the
    # crashed peer + crash step), the replay that resolved it, the restart
    # accounting per gang.
    timeline: List[dict] = []
    hold_open: Dict[tuple, dict] = {}
    for rec in barriers:
        key = (rec["peer"], rec["step"]) if rec["action"] == "hold" else None
        if rec["action"] == "hold":
            event = hold_open.get(key)
            if event is None:
                event = {
                    "event": "hold", "crashed": rec["peer"],
                    "step": rec["step"], "holders": [],
                }
                hold_open[key] = event
                timeline.append(event)
            event["holders"].append(rec["gang_id"])
        else:
            timeline.append({
                "event": "release", "crashed": rec["peer"],
                "restored_step": rec["step"],
                "holders": [rec["gang_id"]],
            })
    for rec in replays:
        timeline.append({
            "event": "replay", "gang": rec.get("gang_id"),
            "crashed_at": rec.get("crashed_at"),
            "restored_step": rec.get("restored_step"),
        })
    restarts_by_gang: Dict[str, int] = {}
    for rec in restarts:
        gang = rec.get("gang_id")
        restarts_by_gang[gang] = restarts_by_gang.get(gang, 0) + 1

    return {
        "n_steps": len(steps),
        "n_stages": len(stages),
        "replayed_cells": replayed_cells,
        "step_span": latency_summary([row["span_s"] for row in per_step]),
        "pipeline": {
            "busy_s": round(total_busy, 9),
            "bubble_s": round(total_bubble, 9),
            # Whole-pipeline decomposition over every (step, stage) cell —
            # the two shares sum to 1 (the acceptance contract).
            "busy_share": (round(total_busy / total_held, 6)
                           if total_held > 0 else None),
            "bubble_share": (round(total_bubble / total_held, 6)
                             if total_held > 0 else None),
        },
        "stages": stage_summary,
        "straggler": straggler,
        "dcn": dcn,
        "recovery": {
            "stage_crashes": len(replays),
            "restarts_by_gang": restarts_by_gang,
            "timeline": timeline,
        },
        "steps": per_step,
    }


def _print_step_timeline(row: dict, out) -> None:
    print(f"-- step={row['step']} span={row['span_s']:.6f}s", file=out)
    for stage, cell in sorted(row["stages"].items()):
        print(f"   stage {stage}: busy {cell['busy_s']:.6f}s "
              f"(fwd {cell['fwd_s']:.6f} / bwd {cell['bwd_s']:.6f} / "
              f"apply {cell['apply_s']:.6f})  bubble {cell['bubble_s']:.6f}s",
              file=out)


def _print_timeline(trace: dict, out) -> None:
    t0 = min(s["t0"] for s in trace["spans"])
    print(f"-- uid={trace['uid']} trace={trace['trace_id']} "
          f"status={trace['status']} tokens={trace['n_tokens']}", file=out)
    for s in trace["spans"]:
        attrs = {k: v for k, v in s.items()
                 if k not in ("schema", "trace_id", "uid", "tenant", "span",
                              "t0", "t1", "dur_s")}
        print(f"  {s['t0'] - t0:10.4f}s +{s['dur_s']:.4f}s "
              f"{s['span']:<12} {attrs}", file=out)


def trace_report_command(args) -> int:
    import sys

    as_json = getattr(args, "json", False)
    if args.train:
        records = load_records(args.jsonl)
        report = train_report(records)
        if report["n_steps"] == 0:
            print(f"trace-report --train: no mpmd.stage_step/v1 records in "
                  f"{args.jsonl}", file=sys.stderr)
            return 1
        if as_json:
            # Pure machine mode: the FULL report (per-step rows included),
            # one document, no human timelines interleaved before it.
            print(json.dumps(report, indent=2, default=float))
            return 0
        if args.timelines:
            slowest = sorted(report["steps"],
                             key=lambda r: -r["span_s"])[: args.timelines]
            for row in slowest:
                _print_step_timeline(row, sys.stdout)
        summary = {k: v for k, v in report.items() if k != "steps"}
        print(json.dumps(summary, indent=2))
        return 0

    spans = load_spans(args.jsonl)
    if not spans:
        print(f"trace-report: no trace.span/v1 records in {args.jsonl}",
              file=sys.stderr)
        return 1
    report = trace_report(spans)
    if args.uid is not None:
        mine = [s for s in spans if s["uid"] == args.uid]
        if not mine:
            print(f"trace-report: no spans for uid {args.uid}", file=sys.stderr)
            return 1
        if as_json:
            print(json.dumps(_reconstruct(mine), indent=2, default=float))
            return 0
        _print_timeline(_reconstruct(mine), sys.stdout)
        return 0
    if as_json:
        print(json.dumps(report, indent=2, default=float))
        return 0
    if args.timelines:
        slowest = sorted(
            (t for t in report["traces"] if t["status"] == "done"),
            key=lambda t: -(t["total_s"] or 0.0),
        )[: args.timelines]
        by_trace: Dict[str, List[dict]] = {}
        for s in spans:
            by_trace.setdefault(s["trace_id"], []).append(s)
        for t in slowest:
            _print_timeline(_reconstruct(by_trace[t["trace_id"]]), sys.stdout)
    summary = {k: v for k, v in report.items() if k != "traces"}
    print(json.dumps(summary, indent=2))
    return 0


def main(argv=None) -> int:
    """``python -m accelerate_tpu_torch.commands.trace_report``."""
    return trace_report_command(trace_report_command_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
