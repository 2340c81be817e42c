"""The flight recorder of the port, a copy of ``accelerate_tpu/telemetry/recorder.py``:
an always-on in-memory black box + incident capsules.

The stack's two existing observability modes are both wrong for an incident at
scale: the full JSONL firehose is unaffordable per-request, and with telemetry
off a 3am failure leaves nothing to debug. :class:`FlightRecorder` is the tier
between them — a ``Telemetry`` **sink** (zero new emit sites) holding a bounded
in-memory ring of the most recent records, periodic metrics-plane snapshots,
and the span buffer tail-sampled tracing promotes from:

- **Ring**: every record the pipeline emits lands in a ``deque(maxlen=ring_size)``;
  evictions are counted (``dropped``) and surfaced through the registered
  ``accelerate_tpu_recorder_dropped_total`` metric when a plane is bound.
- **Tail sampling buffer**: a :class:`~.tracing.Tracer` with head sampling
  armed routes unsampled traces' spans here (:meth:`buffer`) instead of the
  JSONL pipeline — they exist ONLY as ring entries until :meth:`promote`
  replays them through ``Telemetry.emit`` (a request that ended badly becomes
  a full trace after the fact; span records are re-emitted verbatim, so
  reconstructed TTFT is exact).
- **Incident capsules**: on a trigger record (alert firing, fault, breaker
  open, quarantine, replica death, gang restart) — or an explicit
  :meth:`capture` call — the ring + every registered state provider's snapshot
  + provenance are dumped atomically into a self-contained gzip capsule
  directory (``capsule/v1`` manifest, :data:`~.schemas.CAPSULE_SCHEMA`).
  Per-trigger cooldown/dedupe keeps an alert storm at one capsule, not
  hundreds.

Overhead contract (same as ``Telemetry``/``Tracer``/``MetricsPlane``):
**disabled = two attribute reads, zero clock calls** — construction over a
disabled ``Telemetry`` never registers the sink and every public method is a
guarded no-op. The clock is injectable (virtual-clock replays hand the
workload clock in, so cooldowns and snapshot timestamps live in the same time
domain as the spans).

Stdlib-only by design: capsules must be writable from the serving loop and
readable from stripped CLI contexts (``capsule-report``) without torch.
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import re
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional

from .clocks import resolve_clock
from .metrics import M_RECORDER_DROPPED_TOTAL
from .schemas import (
    ALERT_SCHEMA,
    CAPSULE_SCHEMA,
    ELASTIC_RESTART_SCHEMA,
    FAULT_SCHEMA,
    RECOVERY_SCHEMA,
    TRACE_SPAN_SCHEMA,
)

__all__ = ["FlightRecorder", "load_capsule", "list_capsules"]

#: Recovery actions that mark an incident (quarantine, breaker open, replica
#: death). Routine recovery bookkeeping (bisect rounds, rebuilds, breaker
#: close/half-open, replays) must NOT cut capsules — a clean replay of a
#: faulted trace performs none of these, so clean arms stay at zero.
_RECOVERY_TRIGGERS = frozenset({"circuit_open", "quarantine", "replica_died"})

#: Capsule directory names: ``capsule-<seq>-<trigger slug>``.
_SLUG_RE = re.compile(r"[^A-Za-z0-9_.-]+")


class FlightRecorder:
    """Bounded in-memory record ring + tail-sampling buffer + capsule writer.

    ``telemetry`` supplies both the enable flag and the sink registration;
    ``metrics`` (a :class:`~.metrics.MetricsPlane`, bindable later via
    :meth:`bind_metrics`) powers the drop counter and the periodic snapshots;
    ``capsule_dir`` arms capsule capture (None = ring-only recorder).
    """

    def __init__(self, telemetry=None, clock: Optional[Callable[[], float]] = None,
                 ring_size: int = 2048, snapshot_every: int = 256,
                 capsule_dir: Optional[str] = None,
                 capsule_cooldown_s: float = 30.0,
                 metrics=None, enabled: Optional[bool] = None):
        self.telemetry = telemetry
        #: The ONE flag every public method guards on (the Telemetry contract).
        self.enabled = bool(enabled) if enabled is not None else (
            telemetry is not None and getattr(telemetry, "enabled", False)
        )
        # Inherit the bound plane's time domain when no clock is injected:
        # capsule cooldowns and manifest timestamps must live in the same
        # (possibly virtual) time as the snapshots the plane stamps.
        self._clock_injected = clock is not None
        self._clock = resolve_clock(clock, getattr(metrics, "_clock", None))
        self.ring: deque = deque(maxlen=int(ring_size))
        self.snapshot_every = int(snapshot_every)
        self.capsule_dir = capsule_dir
        self.capsule_cooldown_s = float(capsule_cooldown_s)
        self.metrics = metrics
        self.records_seen = 0
        self.dropped = 0
        self.promoted_traces = 0
        self.capsules_written = 0
        self.capsules_suppressed = 0
        #: Written capsule manifests (each carries its ``path``), in order.
        self.capsules: List[dict] = []
        self._last_capture: Dict[str, float] = {}   # trigger → last capture t
        self._capsule_seq = itertools.count()
        self._state_providers: Dict[str, Callable[[], dict]] = {}
        #: True while a promotion/capture replays records through telemetry —
        #: the recorder's own sink must not re-ingest its own flush.
        self._replaying = False
        if self.enabled and telemetry is not None:
            telemetry.sinks.append(self._consume)

    # ------------------------------------------------------------------- intake
    def _consume(self, record: Mapping) -> None:
        """The sink entry point: ring every record, snapshot periodically,
        trigger capsule capture on incident records."""
        if self._replaying:
            return
        self.records_seen += 1
        self._append(record)
        if (self.snapshot_every and self.metrics is not None
                and self.records_seen % self.snapshot_every == 0):
            # The plane stamps (and window-trims) with ITS OWN clock — never
            # this recorder's: mixing time domains would purge a virtual-clock
            # plane's sliding windows with wall-clock timestamps.
            self._append(self.metrics.snapshot_record())
        trigger = self._trigger_for(record)
        if trigger is not None:
            self.capture(trigger, record=record)

    def _append(self, record: Mapping) -> None:
        ring = self.ring
        if ring.maxlen is not None and len(ring) == ring.maxlen:
            self.dropped += 1
            if self.metrics is not None:
                self.metrics.inc(M_RECORDER_DROPPED_TOTAL)
        ring.append(record)

    def buffer(self, record: Mapping) -> None:
        """Hold an UNSAMPLED trace's span as a ring entry only — no JSONL, no
        sinks, no per-trace side table (the zero-overhead contract for the
        happy path). :meth:`promote` replays it if the request ends badly."""
        if not self.enabled:
            return
        self.records_seen += 1
        self._append(record)

    def bind_metrics(self, plane) -> None:
        """Late-bind the metrics plane (the gateway builds its plane after the
        recorder exists); powers drop accounting and periodic snapshots."""
        if not self.enabled:
            return
        if plane is not None and getattr(plane, "enabled", False):
            self.metrics = plane
            # Late-bound plane: adopt its time domain unless a clock was
            # explicitly injected (same coherence contract as construction).
            if not self._clock_injected:
                self._clock = resolve_clock(None, getattr(plane, "_clock", None))

    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Late-bind the time domain (the gateway hands its own clock in, so
        capsule cooldowns and manifest timestamps live in the same — possibly
        virtual — time as the records they frame)."""
        if not self.enabled:
            return
        if clock is not None:
            self._clock = clock
            self._clock_injected = True

    # ---------------------------------------------------------- tail promotion
    def promote(self, trace_id: str) -> int:
        """Replay one trace's ring-buffered spans through ``Telemetry.emit``
        (in ring = chronological order), turning a sampled-out request into a
        full trace. Each span is re-emitted VERBATIM plus a ``promoted`` mark,
        so a reconstruction from the promoted stream matches full tracing to
        the digit. Returns the number of spans promoted; idempotent (a span
        promotes once)."""
        if not self.enabled or self.telemetry is None:
            return 0
        spans = [r for r in self.ring
                 if r.get("schema") == TRACE_SPAN_SCHEMA
                 and r.get("trace_id") == trace_id
                 and not r.get("promoted")]
        if not spans:
            return 0
        self.promoted_traces += 1
        self._replaying = True
        try:
            for rec in spans:
                rec["promoted"] = True
                self.telemetry.emit(rec)
        finally:
            self._replaying = False
        return len(spans)

    # --------------------------------------------------------------- capsules
    def add_state_provider(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a zero-arg callable whose dict snapshot rides every capsule
        (gateway stats, engine lane table, fault-plan fire history...). A
        provider that raises at capture time is recorded as an error string,
        never aborts the dump."""
        if not self.enabled:
            return
        self._state_providers[name] = fn

    def _trigger_for(self, record: Mapping) -> Optional[str]:
        """The capsule trigger/dedupe key for an incident record, or None for
        routine traffic."""
        schema = record.get("schema")
        if schema == ALERT_SCHEMA and record.get("state") == "firing":
            return f"alert:{record.get('rule')}"
        if schema == FAULT_SCHEMA:
            return f"fault:{record.get('site')}"
        if schema == RECOVERY_SCHEMA and record.get("action") in _RECOVERY_TRIGGERS:
            return f"recovery:{record.get('action')}"
        if schema == ELASTIC_RESTART_SCHEMA:
            return f"restart:{record.get('gang_id')}"
        return None

    def capture(self, trigger: str, record: Optional[Mapping] = None,
                now: Optional[float] = None, force: bool = False) -> Optional[str]:
        """Dump ring + state + provenance into one capsule dir, unless the same
        ``trigger`` captured within the cooldown (an alert storm writes ONE
        capsule). Returns the capsule path, or None when unarmed/suppressed."""
        if not self.enabled or self.capsule_dir is None:
            return None
        now = self._clock() if now is None else now
        last = self._last_capture.get(trigger)
        if not force and last is not None and now - last < self.capsule_cooldown_s:
            self.capsules_suppressed += 1
            return None
        self._last_capture[trigger] = now
        return self._write_capsule(trigger, record, now)

    def _state_snapshot(self) -> dict:
        state = {}
        for name, fn in self._state_providers.items():
            try:
                state[name] = fn()
            except Exception as exc:  # a broken provider must not lose the dump
                state[name] = {"error": f"{type(exc).__name__}: {exc}"}
        return state

    def _provenance(self) -> dict:
        """Capture-time provenance (``provenance.runtime_facts``): the git commit
        and, where torch imports, its version, CUDA version and device name in place
        of JAX's ``jax``/``backend``."""
        from .provenance import git_commit, runtime_facts

        return {"git_commit": git_commit(), **runtime_facts()}

    def _write_capsule(self, trigger: str, record: Optional[Mapping],
                       now: float) -> str:
        ring_records = list(self.ring)
        state = self._state_snapshot()
        manifest = {
            "schema": CAPSULE_SCHEMA,
            "trigger": trigger,
            "t": round(now, 9),
            "reason": dict(record) if record is not None else None,
            "ring_records": len(ring_records),
            "ring_dropped": self.dropped,
            "records_seen": self.records_seen,
            "promoted_traces": self.promoted_traces,
            "state_keys": sorted(state),
            "provenance": self._provenance(),
        }
        slug = _SLUG_RE.sub("-", trigger).strip("-") or "capture"
        name = f"capsule-{next(self._capsule_seq):04d}-{slug}"
        final = os.path.join(self.capsule_dir, name)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "manifest.json"), "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=2)
        with gzip.open(os.path.join(tmp, "ring.jsonl.gz"), "wt",
                       encoding="utf-8") as f:
            for rec in ring_records:
                f.write(json.dumps(rec) + "\n")
        with gzip.open(os.path.join(tmp, "state.json.gz"), "wt",
                       encoding="utf-8") as f:
            json.dump(state, f, indent=2)
        # The rename IS the commit: a reader never sees a half-written capsule.
        os.replace(tmp, final)
        self.capsules_written += 1
        self.capsules.append({**manifest, "path": final})
        if self.telemetry is not None:
            # Note the cut on the record stream itself (guarded: the manifest
            # must not re-enter the ring and trigger another capture).
            self._replaying = True
            try:
                self.telemetry.emit(manifest)
            finally:
                self._replaying = False
        return final

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "ring_size": self.ring.maxlen,
            "ring_len": len(self.ring),
            "records_seen": self.records_seen,
            "dropped": self.dropped,
            "promoted_traces": self.promoted_traces,
            "capsules_written": self.capsules_written,
            "capsules_suppressed": self.capsules_suppressed,
        }

    def __repr__(self) -> str:
        return (
            f"FlightRecorder(enabled={self.enabled}, ring={len(self.ring)}/"
            f"{self.ring.maxlen}, dropped={self.dropped}, "
            f"capsules={self.capsules_written})"
        )


# ------------------------------------------------------------------ capsule IO
def load_capsule(path: str) -> dict:
    """Read one capsule directory back: ``{"manifest", "ring", "state"}`` —
    everything ``capsule-report`` reconstructs from, with no live process."""
    with open(os.path.join(path, "manifest.json"), "r", encoding="utf-8") as f:
        manifest = json.load(f)
    ring: List[dict] = []
    ring_path = os.path.join(path, "ring.jsonl.gz")
    if os.path.exists(ring_path):
        with gzip.open(ring_path, "rt", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    ring.append(json.loads(line))
    state = {}
    state_path = os.path.join(path, "state.json.gz")
    if os.path.exists(state_path):
        with gzip.open(state_path, "rt", encoding="utf-8") as f:
            state = json.load(f)
    return {"manifest": manifest, "ring": ring, "state": state, "path": path}


def list_capsules(root: str) -> List[str]:
    """Capsule directories under ``root``, in capture order (a capsule dir
    itself passes through as a one-element list)."""
    if os.path.isfile(os.path.join(root, "manifest.json")):
        return [root]
    out = []
    try:
        entries = sorted(os.listdir(root))
    except FileNotFoundError:
        return []
    for entry in entries:
        full = os.path.join(root, entry)
        if os.path.isfile(os.path.join(full, "manifest.json")):
            out.append(full)
    return out
