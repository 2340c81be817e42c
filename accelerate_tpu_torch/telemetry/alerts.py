"""Alerting over the live metrics plane of the port, a copy of
``accelerate_tpu/telemetry/alerts.py``: burn-rate and threshold rules.

The :class:`~.metrics.MetricsPlane` answers "what is the system doing right
now"; this module answers "is that OK". An :class:`AlertEngine` evaluates a
set of :class:`AlertRule`\\ s against the plane's aggregates and emits one
``accelerate_tpu.telemetry.alert/v1`` record per state TRANSITION
(``firing``/``resolved``) through the normal telemetry pipeline — the exact
trigger surface the SLO-driven autoscaler subscribes to (a sink
filtering on the alert schema sees every transition live, with the rule name
and the aggregate value that crossed).

Three rule kinds:

- ``threshold`` — a bound on one registered metric. Gauges compare their
  current value (labeled gauges reduce with the WORST label: max for ``>``
  rules, min for ``<``); counters compare their **windowed increase** (``K
  step failures inside window_s``), which is the rate-style read operators
  actually alert on — a cumulative counter crossing N forever is not a
  condition, it is history.
- ``burn_rate`` — the multiwindow SLO burn idiom (SRE workbook): burn rate =
  error_rate / error_budget where budget = 1 - objective. The rule fires only
  when BOTH the fast and the slow window exceed ``burn_threshold`` — the fast
  window makes detection quick, the slow window keeps a brief blip from
  paging — and resolves when the fast window recovers (the standard
  asymmetry: page fast, un-page fast, let the slow window keep the budget
  accounting honest). No traffic in a window means no verdict (skip), never
  a fire: silence is not an outage.
- ``sustained_low`` — the scale-DOWN shape: fires only after the metric has
  stayed below ``threshold`` for the FULL ``window_s`` (one high sample
  re-arms the timer), and resolves only once the value climbs back to
  ``clear_threshold`` (distinct from — at or above — the fire threshold).
  The asymmetric pair is hysteresis: without it the autoscaler would retire
  a replica on the same bound that immediately re-fires when the survivors
  absorb its load. Labeled gauges reduce per ``reduce`` (``max``/``min``/
  ``sum`` — ``sum`` turns per-replica active-lane gauges into a fleet-wide
  idleness signal).

Rules fire on *observations*, so the engine is evaluated by the plane itself
after every consumed record (:meth:`poll`, throttled by ``eval_interval_s``
of plane-clock time) — no background thread, deterministic under virtual
clocks, and exactly as live as the record stream feeding the plane.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .metrics import (
    M_BREAKER_CLOSED,
    M_FAULTS_TOTAL,
    M_PAGE_OCCUPANCY,
    M_QUEUE_DEPTH,
    M_RECOVERY_ACTIONS_TOTAL,
    M_REPLICA_HEALTH,
    METRIC_REGISTRY,
    MetricsPlane,
)
from .schemas import ALERT_SCHEMA

__all__ = ["AlertRule", "AlertEngine", "default_alert_rules", "ALERT_SCHEMA"]

_KINDS = ("threshold", "burn_rate", "sustained_low")
_OPS = (">", "<")
_REDUCES = ("max", "min", "sum")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative alerting condition over plane aggregates.

    ``threshold`` rules need ``metric`` + ``threshold`` (+ ``op``, and
    ``window_s`` for counters); ``burn_rate`` rules need ``objective`` +
    ``burn_threshold`` + the two windows; ``sustained_low`` rules need
    ``metric`` + ``threshold`` + ``window_s`` (the fire dwell) and usually a
    ``clear_threshold`` above the fire bound (the hysteresis gap). ``labels``
    restricts a labeled metric to one series; without it, labeled gauges
    reduce to their worst series (or per ``reduce`` for ``sustained_low``)
    and labeled counters sum across series."""

    name: str
    kind: str = "threshold"
    severity: str = "ticket"            # page | ticket — consumer routing hint
    # threshold rules
    metric: Optional[str] = None
    op: str = ">"
    threshold: float = 0.0
    window_s: float = 60.0              # counter-increase / sustained-low window
    labels: Optional[dict] = None
    # sustained-low rules
    clear_threshold: Optional[float] = None  # resolve bound; defaults to threshold
    reduce: str = "max"                 # labeled-gauge reduction: max | min | sum
    # burn-rate rules
    objective: float = 0.99             # SLO target fraction of good events
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 14.4        # the classic 2%-budget-in-1h fast page

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind={self.kind!r} must be one of {_KINDS}")
        if self.kind == "threshold":
            if self.metric is None:
                raise ValueError(f"rule {self.name!r}: threshold rules name a metric")
            if self.metric not in METRIC_REGISTRY:
                raise ValueError(
                    f"rule {self.name!r}: unregistered metric {self.metric!r}"
                )
            if METRIC_REGISTRY[self.metric].kind == "histogram":
                raise ValueError(
                    f"rule {self.name!r}: threshold rules read gauges/counters; "
                    f"{self.metric} is a histogram (alert on a derived gauge)"
                )
            if self.op not in _OPS:
                raise ValueError(f"rule {self.name!r}: op={self.op!r} must be one of {_OPS}")
        elif self.kind == "sustained_low":
            if self.metric is None:
                raise ValueError(
                    f"rule {self.name!r}: sustained_low rules name a metric"
                )
            if self.metric not in METRIC_REGISTRY:
                raise ValueError(
                    f"rule {self.name!r}: unregistered metric {self.metric!r}"
                )
            if METRIC_REGISTRY[self.metric].kind == "histogram":
                raise ValueError(
                    f"rule {self.name!r}: sustained_low rules read gauges/"
                    f"counters; {self.metric} is a histogram"
                )
            if self.window_s <= 0:
                raise ValueError(
                    f"rule {self.name!r}: window_s={self.window_s} must be > 0 "
                    "(the dwell that makes the low SUSTAINED)"
                )
            if self.clear_threshold is not None and self.clear_threshold < self.threshold:
                raise ValueError(
                    f"rule {self.name!r}: clear_threshold={self.clear_threshold} "
                    f"must be >= threshold={self.threshold} (hysteresis clears "
                    "ABOVE where it fires, or it flaps)"
                )
            if self.reduce not in _REDUCES:
                raise ValueError(
                    f"rule {self.name!r}: reduce={self.reduce!r} must be one "
                    f"of {_REDUCES}"
                )
        else:
            if not 0.0 < self.objective < 1.0:
                raise ValueError(
                    f"rule {self.name!r}: objective={self.objective} must be in (0, 1)"
                )
            if self.fast_window_s >= self.slow_window_s:
                raise ValueError(
                    f"rule {self.name!r}: fast_window_s={self.fast_window_s} must be "
                    f"< slow_window_s={self.slow_window_s} (the multiwindow idiom)"
                )
            if self.burn_threshold <= 0:
                raise ValueError(
                    f"rule {self.name!r}: burn_threshold={self.burn_threshold} must be > 0"
                )


class AlertEngine:
    """Evaluates rules against one plane; emits ``alert/v1`` transitions.

    Registers itself with the plane so :meth:`poll` runs after every consumed
    record (throttled to one evaluation per ``eval_interval_s`` of plane-clock
    time; 0 evaluates every record). ``telemetry`` defaults to the plane's —
    transition records ride the same pipeline as everything else."""

    def __init__(self, plane: MetricsPlane, rules: List[AlertRule],
                 telemetry=None, eval_interval_s: float = 1.0):
        names = [r.name for r in rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate alert rule names: {sorted(dupes)}")
        for rule in rules:
            widest = (rule.slow_window_s if rule.kind == "burn_rate"
                      else rule.window_s)
            if widest > plane.window_s:
                raise ValueError(
                    f"rule {rule.name!r}: window {widest}s exceeds the "
                    f"plane's horizon ({plane.window_s}s) — events would age "
                    "out before the rule could see them (widen the plane or "
                    "narrow the rule)"
                )
        self.plane = plane
        self.rules = list(rules)
        self.telemetry = telemetry if telemetry is not None else plane.telemetry
        self.eval_interval_s = float(eval_interval_s)
        #: rule name → "ok" | "firing" (every rule starts ok).
        self.states: Dict[str, str] = {r.name: "ok" for r in self.rules}
        #: Every transition record emitted, in order (the bench/test surface).
        self.fired: List[dict] = []
        #: sustained_low dwell state: rule name → plane time the value first
        #: dipped below the fire threshold (None = not currently below).
        self._below_since: Dict[str, Optional[float]] = {
            r.name: None for r in self.rules
        }
        self._last_eval: Optional[float] = None
        if plane.enabled:
            plane.alert_engines.append(self)

    # ------------------------------------------------------------------ evaluation
    def poll(self, now: Optional[float] = None) -> None:
        """Throttled evaluate — the plane calls this after every record."""
        now = self.plane._clock() if now is None else now
        if (self._last_eval is not None
                and now - self._last_eval < self.eval_interval_s):
            return
        self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> List[str]:
        """Evaluate every rule; emit transitions; return firing rule names."""
        now = self.plane._clock() if now is None else now
        self._last_eval = now
        for rule in self.rules:
            if rule.kind == "threshold":
                verdict, value, bound = self._eval_threshold(rule, now)
            elif rule.kind == "sustained_low":
                verdict, value, bound = self._eval_sustained_low(rule, now)
            else:
                verdict, value, bound = self._eval_burn(rule, now)
            state = self.states[rule.name]
            if verdict is None:
                continue  # no data — hold the current state, never flap on silence
            if verdict and state == "ok":
                self._transition(rule, "firing", value, bound, now)
            elif not verdict and state == "firing":
                self._transition(rule, "resolved", value, bound, now)
        return self.active()

    def active(self) -> List[str]:
        """Currently-firing rule names, in rule order."""
        return [r.name for r in self.rules if self.states[r.name] == "firing"]

    def _eval_threshold(self, rule: AlertRule, now: float):
        spec = METRIC_REGISTRY[rule.metric]
        labels = rule.labels or {}
        if spec.kind == "counter":
            value = self.plane.window_increase(
                rule.metric, rule.window_s, now=now, **labels
            )
        else:
            value = self.plane.gauge_value(rule.metric, **labels)
            if isinstance(value, dict):
                if not value:
                    return None, None, rule.threshold
                # Worst series decides: the bound is a limit, so the series
                # closest to violating it is the one the rule is about.
                value = max(value.values()) if rule.op == ">" else min(value.values())
            if value is None:
                return None, None, rule.threshold
        verdict = value > rule.threshold if rule.op == ">" else value < rule.threshold
        return verdict, value, rule.threshold

    def _eval_sustained_low(self, rule: AlertRule, now: float):
        spec = METRIC_REGISTRY[rule.metric]
        labels = rule.labels or {}
        if spec.kind == "counter":
            value = self.plane.window_increase(
                rule.metric, rule.window_s, now=now, **labels
            )
        else:
            value = self.plane.gauge_value(rule.metric, **labels)
            if isinstance(value, dict):
                if not value:
                    return None, None, rule.threshold
                vals = value.values()
                value = (sum(vals) if rule.reduce == "sum"
                         else min(vals) if rule.reduce == "min" else max(vals))
            if value is None:
                return None, None, rule.threshold
        clear = (rule.clear_threshold if rule.clear_threshold is not None
                 else rule.threshold)
        if self.states[rule.name] == "firing":
            # Hysteresis: resolve only at/above the CLEAR bound, and re-arm
            # the dwell so a refire needs a fresh full window below.
            if value >= clear:
                self._below_since[rule.name] = None
                return False, value, clear
            return True, value, clear
        if value < rule.threshold:
            if self._below_since[rule.name] is None:
                self._below_since[rule.name] = now
            if now - self._below_since[rule.name] >= rule.window_s:
                return True, value, rule.threshold
            return None, value, rule.threshold  # dwelling — hold state
        self._below_since[rule.name] = None
        return False, value, rule.threshold

    def _eval_burn(self, rule: AlertRule, now: float):
        budget = 1.0 - rule.objective
        fast = self.plane.error_rate(rule.fast_window_s, now=now)
        slow = self.plane.error_rate(rule.slow_window_s, now=now)
        if fast is None or slow is None:
            return None, None, rule.burn_threshold
        fast_burn = fast / budget
        slow_burn = slow / budget
        state = self.states[rule.name]
        if state == "ok":
            verdict = (fast_burn > rule.burn_threshold
                       and slow_burn > rule.burn_threshold)
        else:
            # Resolve on the fast window alone: once the error stream is
            # clean the page clears, even while the slow window still
            # remembers the episode.
            verdict = fast_burn > rule.burn_threshold
        return verdict, round(max(fast_burn, slow_burn), 6), rule.burn_threshold

    # ------------------------------------------------------------------ emission
    def _transition(self, rule: AlertRule, state: str, value, bound,
                    now: float) -> None:
        self.states[rule.name] = "firing" if state == "firing" else "ok"
        record = {
            "schema": ALERT_SCHEMA,
            "rule": rule.name,
            "state": state,
            "severity": rule.severity,
            "kind": rule.kind,
            "metric": rule.metric,
            "value": value,
            "threshold": bound,
            "t": round(now, 6),
        }
        self.fired.append(record)
        if self.telemetry is not None:
            self.telemetry.emit(record)

    def summary(self) -> dict:
        """Transition history + current state, the block bench arms stamp."""
        return {
            "rules": [r.name for r in self.rules],
            "active": self.active(),
            "transitions": len(self.fired),
            "fired": [
                {k: r[k] for k in ("rule", "state", "severity", "value", "t")}
                for r in self.fired
            ],
        }

    def __repr__(self) -> str:
        return (f"AlertEngine(rules={len(self.rules)}, "
                f"active={self.active()}, transitions={len(self.fired)})")


def default_alert_rules(
    objective: float = 0.95,
    fast_window_s: float = 60.0,
    slow_window_s: float = 300.0,
    burn_threshold: float = 2.0,
    queue_depth_limit: float = 0.0,
    page_pressure_limit: float = 0.95,
    replica_health_floor: float = 0.5,
    fault_window_s: float = 60.0,
) -> List[AlertRule]:
    """The stock rule set the serving benches arm (and a deployment can start
    from): SLO burn rate over the gateway's terminal stream, fault/breaker
    activity, page-pool pressure, replica health, and (opt-in,
    ``queue_depth_limit > 0``) queue depth."""
    rules = [
        AlertRule("slo-burn-rate", kind="burn_rate", severity="page",
                  objective=objective, fast_window_s=fast_window_s,
                  slow_window_s=slow_window_s, burn_threshold=burn_threshold),
        AlertRule("step-failure-burst", metric=M_FAULTS_TOTAL,
                  threshold=0.0, window_s=fault_window_s, severity="ticket"),
        AlertRule("breaker-open", metric=M_RECOVERY_ACTIONS_TOTAL,
                  labels={"action": "circuit_open"}, threshold=0.0,
                  window_s=fault_window_s, severity="page"),
        AlertRule("replica-died", metric=M_RECOVERY_ACTIONS_TOTAL,
                  labels={"action": "replica_died"}, threshold=0.0,
                  window_s=fault_window_s, severity="page"),
        AlertRule("page-pool-pressure", metric=M_PAGE_OCCUPANCY,
                  threshold=page_pressure_limit, severity="ticket"),
        AlertRule("replica-unhealthy", metric=M_REPLICA_HEALTH, op="<",
                  threshold=replica_health_floor, severity="ticket"),
        AlertRule("breaker-isolated", metric=M_BREAKER_CLOSED, op="<",
                  threshold=0.5, severity="ticket"),
    ]
    if queue_depth_limit > 0:
        rules.append(AlertRule("queue-depth", metric=M_QUEUE_DEPTH,
                               threshold=queue_depth_limit, severity="ticket"))
    return rules
