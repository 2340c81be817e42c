"""``capsule-report``: an incident reconstructed from a flight-recorder capsule alone, the
port's copy of ``accelerate_tpu/commands/capsule_report.py`` (stdlib only).

A flight-recorder capsule (``telemetry/recorder.py``, ``capsule/v1``) is the
self-contained post-mortem artifact: the in-memory ring at capture time, every
registered state provider's snapshot, and provenance — no live process, no
JSONL directory, no torch. This command answers the 3am questions from that
directory alone:

- **What tripped it?** The manifest trigger plus the incident timeline —
  every alert transition, fault, recovery action and gang restart in the
  ring, in emission (= chronological) order.
- **What was failing?** Fault sites/kinds (ring ``fault/v1`` records,
  cross-checked against the fault-plan firing log in the gateway state
  snapshot) and the alert rules that reached ``firing``.
- **What changed?** Before/after deltas of every counter/gauge between the
  first and last ``metrics.snapshot/v1`` records the ring holds.
- **Where did the worst request's time go?** Tail-promoted traces (spans the
  recorder replayed for requests that ended badly) are reconstructed with the
  same component math as ``trace-report``; the slowest one's critical path is
  reported, and its full span timeline printed in human mode.

``--json`` emits ONE machine-readable JSON document and nothing else (the
bench harnesses and CI parse it); default output is a human summary per
capsule. The input may be one capsule directory or a capsule root — every
capsule under a root is reported in capture order. Run it as
``python -m accelerate_tpu_torch.commands.capsule_report <capsule dir | root>``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

__all__ = ["capsule_report", "capsule_report_command",
           "capsule_report_command_parser"]


def capsule_report_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = (
        "Reconstruct an incident from a flight-recorder capsule directory "
        "alone: trigger, alert/fault/recovery timeline, before/after "
        "counter+gauge deltas between the ring's metrics snapshots, and the "
        "critical path of the worst tail-promoted request. Accepts one "
        "capsule dir or a capsule root (reports every capsule under it)."
    )
    if subparsers is not None:
        parser = subparsers.add_parser("capsule-report", description=description)
    else:
        parser = argparse.ArgumentParser(
            "python -m accelerate_tpu_torch.commands.capsule_report",
            description=description
        )
    parser.add_argument(
        "capsule",
        help="a capsule directory (contains manifest.json) or a capsule root",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable mode: print ONE JSON document "
             '({"capsules": [...]}) and nothing else',
    )
    parser.add_argument(
        "--timeline", type=int, default=12, metavar="N",
        help="incident-timeline rows to print per capsule (human mode; "
             "default 12, 0 disables)",
    )
    if subparsers is not None:
        parser.set_defaults(func=capsule_report_command)
    return parser


def _numeric_deltas(before: Dict, after: Dict) -> Dict[str, dict]:
    """Changed numeric series between two snapshot blocks, keyed by series
    name: ``{"before", "after", "delta"}`` (new series appear with before=0)."""
    out: Dict[str, dict] = {}
    for key in sorted(set(before) | set(after)):
        b, a = before.get(key, 0), after.get(key, 0)
        if not isinstance(b, (int, float)) or not isinstance(a, (int, float)):
            continue
        if a != b:
            out[key] = {"before": b, "after": a, "delta": round(a - b, 9)}
    return out


def capsule_report(capsule: dict) -> dict:
    """The incident reconstruction for one loaded capsule
    (:func:`~..telemetry.recorder.load_capsule` output)."""
    from ..telemetry.schemas import (
        ALERT_SCHEMA,
        CAPSULE_SCHEMA,
        ELASTIC_RESTART_SCHEMA,
        FAULT_SCHEMA,
        METRICS_SNAPSHOT_SCHEMA,
        RECOVERY_SCHEMA,
        TRACE_SPAN_SCHEMA,
    )
    from .trace_report import _reconstruct

    manifest = capsule["manifest"]
    ring: List[dict] = capsule["ring"]
    state: Dict = capsule.get("state", {})

    # Incident timeline: ring order IS emission order (chronological by
    # construction), so no timestamp sort — fault records need no ``t``.
    timeline: List[dict] = []
    alerts_fired: List[str] = []
    fault_sites: Dict[str, int] = {}
    fault_kinds: Dict[str, int] = {}
    snapshots: List[dict] = []
    promoted: Dict[str, List[dict]] = {}
    for rec in ring:
        schema = rec.get("schema")
        if schema == ALERT_SCHEMA:
            timeline.append({
                "event": "alert", "rule": rec.get("rule"),
                "state": rec.get("state"), "severity": rec.get("severity"),
                "value": rec.get("value"), "t": rec.get("t"),
            })
            if rec.get("state") == "firing" and rec.get("rule") not in alerts_fired:
                alerts_fired.append(rec.get("rule"))
        elif schema == FAULT_SCHEMA:
            site, kind = rec.get("site"), rec.get("kind")
            timeline.append({"event": "fault", "site": site, "kind": kind,
                             "uid": rec.get("uid"), "t": rec.get("t")})
            fault_sites[site] = fault_sites.get(site, 0) + 1
            fault_kinds[kind] = fault_kinds.get(kind, 0) + 1
        elif schema == RECOVERY_SCHEMA:
            timeline.append({"event": "recovery", "action": rec.get("action"),
                             "reason": rec.get("reason"), "t": rec.get("t")})
        elif schema == ELASTIC_RESTART_SCHEMA:
            timeline.append({"event": "restart", "gang_id": rec.get("gang_id"),
                             "attempt": rec.get("attempt"), "t": rec.get("t")})
        elif schema == CAPSULE_SCHEMA:
            timeline.append({"event": "capsule", "trigger": rec.get("trigger"),
                             "t": rec.get("t")})
        elif schema == METRICS_SNAPSHOT_SCHEMA:
            snapshots.append(rec)
        elif schema == TRACE_SPAN_SCHEMA and rec.get("promoted"):
            promoted.setdefault(rec.get("trace_id"), []).append(rec)

    # The fault-plan firing log in the state snapshot corroborates (and, when
    # the ring rolled past the faults, replaces) the ring-derived fault set.
    for snap in state.values():
        fired = (snap or {}).get("faults", {}).get("fired") \
            if isinstance(snap, dict) else None
        if fired:
            for f in fired:
                site, kind = f.get("site"), f.get("kind")
                if site is not None and fault_sites.get(site, 0) == 0:
                    fault_sites[site] = fault_sites.get(site, 0) + 1
                if kind is not None and fault_kinds.get(kind, 0) == 0:
                    fault_kinds[kind] = fault_kinds.get(kind, 0) + 1

    deltas = None
    if len(snapshots) >= 2:
        first, last = snapshots[0], snapshots[-1]
        deltas = {
            "window_s": round((last.get("t") or 0) - (first.get("t") or 0), 6),
            "counters": _numeric_deltas(first.get("counters", {}),
                                        last.get("counters", {})),
            "gauges": _numeric_deltas(first.get("gauges", {}),
                                      last.get("gauges", {})),
        }

    worst = None
    if promoted:
        traces = [_reconstruct(spans) for spans in promoted.values()]
        worst = max(traces, key=lambda t: t["total_s"] or 0.0)

    return {
        "path": capsule.get("path"),
        "trigger": manifest.get("trigger"),
        "t": manifest.get("t"),
        "reason": manifest.get("reason"),
        "ring_records": manifest.get("ring_records"),
        "ring_dropped": manifest.get("ring_dropped"),
        "provenance": manifest.get("provenance"),
        "state_keys": manifest.get("state_keys"),
        "alerts_fired": alerts_fired,
        "fault_sites": fault_sites,
        "fault_kinds": fault_kinds,
        "timeline": timeline,
        "snapshots": len(snapshots),
        "deltas": deltas,
        "promoted_traces": len(promoted),
        "worst_promoted": worst,
    }


def _print_report(report: dict, out) -> None:
    from .trace_report import _print_timeline

    print(f"== capsule {report['path']}", file=out)
    print(f"trigger: {report['trigger']}  t={report['t']}", file=out)
    prov = report.get("provenance") or {}
    print("provenance: " + " ".join(f"{k}={v}" for k, v in prov.items()),
          file=out)
    print(f"ring: {report['ring_records']} records "
          f"({report['ring_dropped']} dropped before capture); "
          f"state: {', '.join(report['state_keys'] or []) or '-'}", file=out)
    print("alerts fired: " + (", ".join(report["alerts_fired"]) or "-"),
          file=out)
    sites = ", ".join(f"{s} x{n}" for s, n in
                      sorted(report["fault_sites"].items()))
    kinds = ", ".join(f"{k} x{n}" for k, n in
                      sorted(report["fault_kinds"].items()))
    print(f"faults: sites [{sites or '-'}]  kinds [{kinds or '-'}]", file=out)
    rows = report["timeline"]
    if report.get("_timeline_rows"):
        shown = rows[-report["_timeline_rows"]:]
        print(f"incident timeline (last {len(shown)}/{len(rows)} events):",
              file=out)
        for ev in shown:
            attrs = {k: v for k, v in ev.items() if k != "event" and v is not None}
            print(f"  {ev['event']:<9} {attrs}", file=out)
    deltas = report.get("deltas")
    if deltas:
        print(f"metric deltas over {deltas['window_s']}s "
              f"({report['snapshots']} snapshots in ring):", file=out)
        for block in ("counters", "gauges"):
            for name, d in deltas[block].items():
                print(f"  {name}: {d['before']} -> {d['after']} "
                      f"({d['delta']:+g})", file=out)
    worst = report.get("worst_promoted")
    if worst is not None:
        print(f"worst promoted request: uid={worst['uid']} "
              f"status={worst['status']} reason={worst['reason']} "
              f"total={worst['total_s']:.4f}s (queue {worst['queue_s']:.4f} / "
              f"prefill {worst['prefill_s']:.4f} / decode "
              f"{worst['decode_s']:.4f})", file=out)
        _print_timeline(worst, out)


def capsule_report_command(args) -> int:
    import sys

    from ..telemetry.recorder import list_capsules, load_capsule

    paths = list_capsules(args.capsule)
    if not paths:
        print(f"capsule-report: no capsules under {args.capsule}",
              file=sys.stderr)
        return 1
    reports = [capsule_report(load_capsule(p)) for p in paths]
    if args.json:
        # Pure machine mode: one document, nothing else — the span lists of
        # the worst promoted traces ride along (they ARE the evidence).
        print(json.dumps({"capsules": reports}, indent=2, default=float))
        return 0
    for report in reports:
        report["_timeline_rows"] = args.timeline
        _print_report(report, sys.stdout)
        report.pop("_timeline_rows", None)
    return 0


def main(argv=None) -> int:
    """``python -m accelerate_tpu_torch.commands.capsule_report``."""
    return capsule_report_command(capsule_report_command_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
