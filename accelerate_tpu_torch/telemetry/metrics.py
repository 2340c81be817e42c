"""The live metrics plane of the port, a copy of ``accelerate_tpu/telemetry/metrics.py``:
the record stream folded into queryable aggregates.

:class:`MetricsPlane` is a ``Telemetry`` **sink**: it consumes the records the engine,
gateway, fleet and fault boundaries already emit and keeps counters, gauges and bounded
sliding-window histograms while the workload runs (serving queue and pool occupancy,
per-status request totals and TTFT/TPOT/queue-wait windows, the SLO good/bad event
window the burn-rate alerts read, per-replica health, routing, fault, recovery, restart,
alert and scale counters, the train-step window). It is read three ways:
:meth:`MetricsPlane.stats` (the dict the autoscaler polls), the Prometheus text of
``telemetry.exporter`` and ``commands/metrics_dump.py`` (the same snapshot rebuilt
offline from a JSONL run directory).

Metric names are minted here (:data:`METRIC_REGISTRY`, the JAX package's names, so one
scraper reads both); ``inc``/``set_gauge``/``observe`` reject unregistered names. The
plane also folds the MPMD transfer and stage-step records of a JAX run directory; the
port emits none yet.

Disabled (the default) the plane never registers as a sink and every public method is a
guarded no-op: no clock read, no dict write. Stdlib-only: importable without torch.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from .clocks import resolve_clock
from .schemas import (
    ALERT_SCHEMA,
    ELASTIC_RESTART_SCHEMA,
    FAULT_SCHEMA,
    FLEET_ROUTE_SCHEMA,
    FLEET_SCALE_SCHEMA,
    GATEWAY_REQUEST_SCHEMA,
    GATEWAY_SLO_SCHEMA,
    METRICS_SNAPSHOT_SCHEMA,
    RECOVERY_SCHEMA,
    REPLICA_HEALTH_SCHEMA,
    SERVING_HANDOFF_SCHEMA,
    SERVING_KV_SCHEMA,
    SERVING_SCHEMA,
    SERVING_SPEC_SCHEMA,
    STEP_RECORD_SCHEMA,
)
from .slo import latency_summary

# The MPMD records' ids (JAX's ``telemetry/schemas.py``): the port emits none yet, but
# the plane folds them from a JAX run directory as JAX's plane does.
MPMD_TRANSFER_SCHEMA = "accelerate_tpu.telemetry.mpmd.transfer/v1"
MPMD_STAGE_STEP_SCHEMA = "accelerate_tpu.telemetry.mpmd.stage_step/v1"

__all__ = [
    "MetricSpec",
    "METRIC_REGISTRY",
    "MetricsPlane",
    "registered_metrics",
    "metric_table_markdown",
    # counters
    "M_REQUESTS_TOTAL",
    "M_TENANT_REQUESTS_TOTAL",
    "M_TENANT_SLO_GOOD_TOTAL",
    "M_TENANT_SLO_BAD_TOTAL",
    "M_TOKENS_TOTAL",
    "M_FAULTS_TOTAL",
    "M_RECOVERY_ACTIONS_TOTAL",
    "M_GANG_RESTARTS_TOTAL",
    "M_ROUTE_DECISIONS_TOTAL",
    "M_DCN_BYTES_TOTAL",
    "M_HANDOFF_BYTES_TOTAL",
    "M_ALERTS_TOTAL",
    "M_FLEET_SCALE_EVENTS_TOTAL",
    "M_FLEET_REPLICA_HOURS_TOTAL",
    "M_RECORDER_DROPPED_TOTAL",
    "M_EXPORTER_SCRAPES_TOTAL",
    # gauges
    "M_QUEUE_DEPTH",
    "M_FLEET_REPLICAS_ACTIVE",
    "M_SLOT_OCCUPANCY",
    "M_PAGE_OCCUPANCY",
    "M_KV_BYTES_IN_USE",
    "M_SPEC_ACCEPT_RATE",
    "M_REPLICA_HEALTH",
    "M_REPLICA_ACTIVE_SLOTS",
    "M_REPLICA_QUEUED",
    "M_BREAKER_CLOSED",
    "M_GANG_RESTART_BUDGET_REMAINING",
    "M_SLO_ATTAINMENT",
    "M_SLO_WINDOW_GOOD",
    "M_SLO_WINDOW_BAD",
    "M_TOKENS_PER_SECOND",
    # histograms (sliding windows)
    "M_TTFT_SECONDS",
    "M_TPOT_SECONDS",
    "M_QUEUE_WAIT_SECONDS",
    "M_TRAIN_STEP_SECONDS",
    "M_STAGE_STEP_SECONDS",
    "M_DCN_TRANSFER_SECONDS",
]

# ------------------------------------------------------------------ metric names
# Prometheus naming: one ``accelerate_tpu_`` namespace, unit-suffixed where the
# unit is not obvious, ``_total`` suffix on counters. These constants are the
# ONLY place the names are spelled .

M_REQUESTS_TOTAL = "accelerate_tpu_gateway_requests_total"
M_TENANT_REQUESTS_TOTAL = "accelerate_tpu_gateway_tenant_requests_total"
M_TENANT_SLO_GOOD_TOTAL = "accelerate_tpu_gateway_tenant_slo_good_total"
M_TENANT_SLO_BAD_TOTAL = "accelerate_tpu_gateway_tenant_slo_bad_total"
M_TOKENS_TOTAL = "accelerate_tpu_serving_tokens_total"
M_FAULTS_TOTAL = "accelerate_tpu_faults_total"
M_RECOVERY_ACTIONS_TOTAL = "accelerate_tpu_recovery_actions_total"
M_GANG_RESTARTS_TOTAL = "accelerate_tpu_gang_restarts_total"
M_ROUTE_DECISIONS_TOTAL = "accelerate_tpu_fleet_route_decisions_total"
M_DCN_BYTES_TOTAL = "accelerate_tpu_mpmd_dcn_bytes_total"
M_HANDOFF_BYTES_TOTAL = "accelerate_tpu_kv_handoff_bytes_total"
M_ALERTS_TOTAL = "accelerate_tpu_alerts_total"
M_FLEET_SCALE_EVENTS_TOTAL = "accelerate_tpu_fleet_scale_events_total"
M_FLEET_REPLICA_HOURS_TOTAL = "accelerate_tpu_fleet_replica_hours_total"
M_RECORDER_DROPPED_TOTAL = "accelerate_tpu_recorder_dropped_total"
M_EXPORTER_SCRAPES_TOTAL = "accelerate_tpu_exporter_scrapes_total"

M_QUEUE_DEPTH = "accelerate_tpu_serving_queue_depth"
M_FLEET_REPLICAS_ACTIVE = "accelerate_tpu_fleet_replicas_active"
M_SLOT_OCCUPANCY = "accelerate_tpu_serving_slot_occupancy"
M_PAGE_OCCUPANCY = "accelerate_tpu_kv_page_occupancy"
M_KV_BYTES_IN_USE = "accelerate_tpu_kv_bytes_in_use"
M_SPEC_ACCEPT_RATE = "accelerate_tpu_spec_accept_rate"
M_REPLICA_HEALTH = "accelerate_tpu_replica_health"
M_REPLICA_ACTIVE_SLOTS = "accelerate_tpu_replica_active_slots"
M_REPLICA_QUEUED = "accelerate_tpu_replica_queued"
M_BREAKER_CLOSED = "accelerate_tpu_breaker_closed"
M_GANG_RESTART_BUDGET_REMAINING = "accelerate_tpu_gang_restart_budget_remaining"
M_SLO_ATTAINMENT = "accelerate_tpu_slo_attainment"
M_SLO_WINDOW_GOOD = "accelerate_tpu_slo_window_good"
M_SLO_WINDOW_BAD = "accelerate_tpu_slo_window_bad"
M_TOKENS_PER_SECOND = "accelerate_tpu_serving_tokens_per_second"

M_TTFT_SECONDS = "accelerate_tpu_gateway_ttft_seconds"
M_TPOT_SECONDS = "accelerate_tpu_gateway_tpot_seconds"
M_QUEUE_WAIT_SECONDS = "accelerate_tpu_gateway_queue_wait_seconds"
M_TRAIN_STEP_SECONDS = "accelerate_tpu_train_step_seconds"
M_STAGE_STEP_SECONDS = "accelerate_tpu_mpmd_stage_step_seconds"
M_DCN_TRANSFER_SECONDS = "accelerate_tpu_mpmd_dcn_transfer_seconds"


# ------------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One registered metric: name, kind, label keys it may carry, which
    record schema feeds it (``derived`` for values computed at snapshot
    time), and what it means."""

    name: str
    kind: str                       # counter | gauge | histogram
    labels: Tuple[str, ...]
    source: str                     # feeding schema id, or "derived"
    description: str


def _m(name: str, kind: str, labels, source: str, description: str) -> MetricSpec:
    return MetricSpec(name, kind, tuple(labels), source, description)


#: Every metric the plane maintains, keyed by name — the single source of
#: truth call sites, the docs catalog, alert rules and the exporter share.
METRIC_REGISTRY: Dict[str, MetricSpec] = {
    s.name: s
    for s in (
        _m(M_REQUESTS_TOTAL, "counter", ("status",), GATEWAY_REQUEST_SCHEMA,
           "terminal gateway requests by status"),
        _m(M_TENANT_REQUESTS_TOTAL, "counter", ("tenant", "status"),
           GATEWAY_REQUEST_SCHEMA,
           "terminal gateway requests by tenant and status"),
        _m(M_TENANT_SLO_GOOD_TOTAL, "counter", ("tenant",),
           GATEWAY_REQUEST_SCHEMA,
           "per-tenant terminal requests that met the SLO"),
        _m(M_TENANT_SLO_BAD_TOTAL, "counter", ("tenant",),
           GATEWAY_REQUEST_SCHEMA,
           "per-tenant terminal requests that violated the SLO"),
        _m(M_TOKENS_TOTAL, "counter", (), GATEWAY_REQUEST_SCHEMA,
           "tokens delivered by terminal requests"),
        _m(M_FAULTS_TOTAL, "counter", ("site",), FAULT_SCHEMA,
           "faults observed at recovery boundaries (injected or real)"),
        _m(M_RECOVERY_ACTIONS_TOTAL, "counter", ("action",), RECOVERY_SCHEMA,
           "recovery actions (quarantine/rebuild/circuit transitions/...)"),
        _m(M_GANG_RESTARTS_TOTAL, "counter", ("gang",), ELASTIC_RESTART_SCHEMA,
           "gang restart attempts"),
        _m(M_ROUTE_DECISIONS_TOTAL, "counter", ("reason",), FLEET_ROUTE_SCHEMA,
           "fleet routing decisions (dispatch/probe/migrate/handoff)"),
        _m(M_DCN_BYTES_TOTAL, "counter", ("direction",), MPMD_TRANSFER_SCHEMA,
           "inter-stage DCN payload bytes (fwd activations / bwd cotangents)"),
        _m(M_HANDOFF_BYTES_TOTAL, "counter", (), SERVING_HANDOFF_SCHEMA,
           "cross-engine KV page handoff wire bytes"),
        _m(M_ALERTS_TOTAL, "counter", ("rule", "state"), ALERT_SCHEMA,
           "alert-state transitions seen on the record stream"),
        _m(M_FLEET_SCALE_EVENTS_TOTAL, "counter", ("action",),
           FLEET_SCALE_SCHEMA,
           "autoscaler decisions (scale_up/scale_down/rebalance)"),
        _m(M_FLEET_REPLICA_HOURS_TOTAL, "counter", (), FLEET_SCALE_SCHEMA,
           "cumulative replica-hours accrued by the fleet (the cost axis of "
           "attainment-per-replica-hour)"),
        _m(M_RECORDER_DROPPED_TOTAL, "counter", (), "derived",
           "flight-ring records evicted before any capsule captured them"),
        _m(M_EXPORTER_SCRAPES_TOTAL, "counter", ("endpoint",), "derived",
           "HTTP scrapes served by the Prometheus exporter"),
        _m(M_QUEUE_DEPTH, "gauge", (), SERVING_SCHEMA,
           "engine-internal queued requests (last decode step)"),
        _m(M_FLEET_REPLICAS_ACTIVE, "gauge", ("role",), FLEET_SCALE_SCHEMA,
           "live (non-retired, non-draining-out) replicas per role after the "
           "latest autoscaler decision"),
        _m(M_SLOT_OCCUPANCY, "gauge", (), SERVING_SCHEMA,
           "decode-lane occupancy in [0,1] (last decode step)"),
        _m(M_PAGE_OCCUPANCY, "gauge", (), SERVING_KV_SCHEMA,
           "KV page-pool occupancy in [0,1] — the admission-pressure signal"),
        _m(M_KV_BYTES_IN_USE, "gauge", (), SERVING_KV_SCHEMA,
           "KV pool bytes currently allocated"),
        _m(M_SPEC_ACCEPT_RATE, "gauge", (), SERVING_SPEC_SCHEMA,
           "cumulative speculative acceptance rate"),
        _m(M_REPLICA_HEALTH, "gauge", ("replica",), REPLICA_HEALTH_SCHEMA,
           "per-replica health score in [0,1]"),
        _m(M_REPLICA_ACTIVE_SLOTS, "gauge", ("replica",), REPLICA_HEALTH_SCHEMA,
           "per-replica active decode lanes"),
        _m(M_REPLICA_QUEUED, "gauge", ("replica",), REPLICA_HEALTH_SCHEMA,
           "per-replica engine-internal queue depth"),
        _m(M_BREAKER_CLOSED, "gauge", ("replica",), REPLICA_HEALTH_SCHEMA,
           "1 when the (replica's) circuit breaker is closed, else 0"),
        _m(M_GANG_RESTART_BUDGET_REMAINING, "gauge", ("gang",),
           ELASTIC_RESTART_SCHEMA,
           "restart attempts left before the gang's budget exhausts"),
        _m(M_SLO_ATTAINMENT, "gauge", (), "derived",
           "good/(good+bad) over the SLO event window (None with no events)"),
        _m(M_SLO_WINDOW_GOOD, "gauge", (), "derived",
           "terminal requests meeting the SLO inside the window"),
        _m(M_SLO_WINDOW_BAD, "gauge", (), "derived",
           "terminal requests violating the SLO inside the window"),
        _m(M_TOKENS_PER_SECOND, "gauge", (), "derived",
           "windowed token delivery rate (terminal-request tokens / window)"),
        _m(M_TTFT_SECONDS, "histogram", (), GATEWAY_REQUEST_SCHEMA,
           "time to first token, sliding window"),
        _m(M_TPOT_SECONDS, "histogram", (), GATEWAY_REQUEST_SCHEMA,
           "mean inter-token gap, sliding window"),
        _m(M_QUEUE_WAIT_SECONDS, "histogram", (), GATEWAY_REQUEST_SCHEMA,
           "scheduler queue wait, sliding window"),
        _m(M_TRAIN_STEP_SECONDS, "histogram", (), STEP_RECORD_SCHEMA,
           "fenced train-step wall seconds, sliding window"),
        _m(M_STAGE_STEP_SECONDS, "histogram", ("stage",),
           MPMD_STAGE_STEP_SCHEMA,
           "per-MPMD-stage busy seconds per train step, sliding window"),
        _m(M_DCN_TRANSFER_SECONDS, "histogram", (), MPMD_TRANSFER_SCHEMA,
           "inter-stage DCN transfer latency, sliding window"),
    )
}


def registered_metrics() -> List[str]:
    """Every registered metric name, sorted."""
    return sorted(METRIC_REGISTRY)


LabelSet = Tuple[Tuple[str, str], ...]

#: Sentinel distinguishing "not a derived gauge" from a derived gauge whose
#: live value is legitimately None (no traffic in the window).
_NO_DERIVED = object()


def _label_key(labels: Mapping[str, object]) -> LabelSet:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def render_name(name: str, labels: LabelSet = ()) -> str:
    """``name{key="value",...}`` — the Prometheus series spelling, also used
    as the stable key in :meth:`MetricsPlane.stats` dicts."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsPlane:
    """Live aggregates over the telemetry record stream.

    Construction over an enabled ``Telemetry`` registers the plane as a sink;
    every record the pipeline emits is folded into the aggregate tables by a
    per-schema handler. ``clock`` is injectable (virtual-clock replays hand
    the gateway's clock in, so sliding windows share the workload's time
    domain). ``window_s`` bounds every sliding window in time; ``window_cap``
    bounds it in entries (a hot serving loop must not grow per-event state
    without bound — both bounds always apply).

    The plane never emits on its own: :meth:`snapshot_record` *builds* the
    ``metrics.snapshot/v1`` record and only routes it through telemetry when
    asked (``emit=True``), so consuming and producing stay visibly separate.
    """

    def __init__(self, telemetry=None, clock: Optional[Callable[[], float]] = None,
                 window_s: float = 300.0, window_cap: int = 4096,
                 enabled: Optional[bool] = None):
        self.telemetry = telemetry
        #: The ONE flag every public method guards on (the Telemetry contract).
        self.enabled = bool(enabled) if enabled is not None else (
            telemetry is not None and getattr(telemetry, "enabled", False)
        )
        self._clock = resolve_clock(clock)
        self.window_s = float(window_s)
        self.window_cap = int(window_cap)
        self.records_consumed = 0
        self._counters: Dict[Tuple[str, LabelSet], float] = {}
        #: Per-counter event log (t, delta) — windowed-increase reads for
        #: alert rules ("K step failures in 60 s"), bounded like histograms.
        self._counter_events: Dict[Tuple[str, LabelSet], deque] = {}
        self._gauges: Dict[Tuple[str, LabelSet], float] = {}
        self._hists: Dict[Tuple[str, LabelSet], deque] = {}
        #: SLO event window: (t, good) per terminal request — burn-rate input.
        self._slo_events: deque = deque(maxlen=window_cap)
        #: Token-delivery window: (t, n_tokens) per terminal request.
        self._token_events: deque = deque(maxlen=window_cap)
        #: Alert engines polling this plane (``alerts.AlertEngine`` registers
        #: itself); polled after every consumed record, throttled per engine.
        self.alert_engines: List[object] = []
        self._handlers = {
            SERVING_SCHEMA: self._on_serving,
            SERVING_KV_SCHEMA: self._on_kv,
            SERVING_SPEC_SCHEMA: self._on_spec,
            GATEWAY_REQUEST_SCHEMA: self._on_request,
            REPLICA_HEALTH_SCHEMA: self._on_replica_health,
            FLEET_ROUTE_SCHEMA: self._on_route,
            ELASTIC_RESTART_SCHEMA: self._on_restart,
            MPMD_TRANSFER_SCHEMA: self._on_transfer,
            MPMD_STAGE_STEP_SCHEMA: self._on_stage_step,
            STEP_RECORD_SCHEMA: self._on_train_step,
            SERVING_HANDOFF_SCHEMA: self._on_handoff,
            FAULT_SCHEMA: self._on_fault,
            RECOVERY_SCHEMA: self._on_recovery,
            ALERT_SCHEMA: self._on_alert,
            FLEET_SCALE_SCHEMA: self._on_scale,
        }
        #: Last cumulative replica-hours seen on a ``fleet.scale/v1`` record —
        #: the counter is fed by DELTAS of the record's monotone value.
        self._replica_hours_seen = 0.0
        if self.enabled and telemetry is not None:
            telemetry.sinks.append(self._consume)

    # -------------------------------------------------------------- primitives
    def _check(self, name: str, kind: str) -> None:
        spec = METRIC_REGISTRY.get(name)
        if spec is None:
            raise KeyError(
                f"unregistered metric {name!r} — mint it in "
                "telemetry/metrics.py (METRIC_REGISTRY) first"
            )
        if spec.kind != kind:
            raise ValueError(f"{name} is a {spec.kind}, used as a {kind}")

    def inc(self, name: str, value: float = 1.0, t: Optional[float] = None,
            **labels) -> None:
        """Add ``value`` to counter ``name`` (and its windowed event log)."""
        if not self.enabled:
            return
        self._check(name, "counter")
        key = (name, _label_key(labels))
        self._counters[key] = self._counters.get(key, 0.0) + value
        events = self._counter_events.get(key)
        if events is None:
            events = self._counter_events[key] = deque(maxlen=self.window_cap)
        events.append((self._clock() if t is None else t, value))

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        self._check(name, "gauge")
        self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name: str, value: float, t: Optional[float] = None,
                **labels) -> None:
        """Append one observation to histogram ``name``'s sliding window."""
        if not self.enabled:
            return
        self._check(name, "histogram")
        key = (name, _label_key(labels))
        window = self._hists.get(key)
        if window is None:
            window = self._hists[key] = deque(maxlen=self.window_cap)
        window.append((self._clock() if t is None else t, float(value)))

    def _trim(self, window: deque, now: float, horizon: Optional[float] = None) -> None:
        horizon = self.window_s if horizon is None else horizon
        while window and now - window[0][0] > horizon:
            window.popleft()

    # ----------------------------------------------------------- record intake
    def consume(self, record: Mapping) -> None:
        """Fold one record into the aggregates (the sink entry point; public
        so offline consumers — ``metrics-dump`` — can replay a JSONL file
        through the identical path)."""
        if not self.enabled:
            return
        self._consume(record)

    def _consume(self, record: Mapping) -> None:
        self.records_consumed += 1
        handler = self._handlers.get(record.get("schema"))
        if handler is not None:
            handler(record)
        for engine in self.alert_engines:
            engine.poll()

    def replay(self, records) -> int:
        """Offline intake: feed a recorded stream through :meth:`consume`.
        Returns the number of records consumed."""
        n = 0
        for record in records:
            self.consume(record)
            n += 1
        return n

    # ------------------------------------------------------- per-schema handlers
    def _on_serving(self, r: Mapping) -> None:
        if "queued" in r:
            self.set_gauge(M_QUEUE_DEPTH, r["queued"])
        if "slot_occupancy" in r:
            self.set_gauge(M_SLOT_OCCUPANCY, r["slot_occupancy"])

    def _on_kv(self, r: Mapping) -> None:
        if "page_occupancy" in r:
            self.set_gauge(M_PAGE_OCCUPANCY, r["page_occupancy"])
        if "kv_bytes_in_use" in r:
            self.set_gauge(M_KV_BYTES_IN_USE, r["kv_bytes_in_use"])

    def _on_spec(self, r: Mapping) -> None:
        proposed = r.get("proposed_total") or 0
        if proposed:
            self.set_gauge(M_SPEC_ACCEPT_RATE,
                           (r.get("accepted_total") or 0) / proposed)

    #: Terminal statuses that count AGAINST the SLO (a cancel is the client's
    #: own doing — neither good nor bad).
    _SLO_BAD = frozenset({"failed", "expired", "evicted", "shed", "rejected"})

    def _on_request(self, r: Mapping) -> None:
        now = self._clock()
        status = r.get("status")
        tenant = r.get("tenant") or "default"
        self.inc(M_REQUESTS_TOTAL, t=now, status=status)
        self.inc(M_TENANT_REQUESTS_TOTAL, t=now, tenant=tenant, status=status)
        tokens = r.get("n_tokens") or 0
        if tokens:
            self.inc(M_TOKENS_TOTAL, float(tokens), t=now)
            self._token_events.append((now, float(tokens)))
        for metric, column in ((M_TTFT_SECONDS, "ttft_s"),
                               (M_TPOT_SECONDS, "tpot_s"),
                               (M_QUEUE_WAIT_SECONDS, "queue_wait_s")):
            value = r.get(column)
            if value is not None:
                self.observe(metric, value, t=now)
        if status == "done":
            # deadline_met None = no deadline declared: delivered = good.
            good = r.get("deadline_met") is not False
            self._slo_events.append((now, good))
            self.inc(M_TENANT_SLO_GOOD_TOTAL if good else M_TENANT_SLO_BAD_TOTAL,
                     t=now, tenant=tenant)
        elif status in self._SLO_BAD:
            self._slo_events.append((now, False))
            self.inc(M_TENANT_SLO_BAD_TOTAL, t=now, tenant=tenant)

    def _on_replica_health(self, r: Mapping) -> None:
        rid = r.get("replica")
        self.set_gauge(M_REPLICA_HEALTH, r.get("health") or 0.0, replica=rid)
        self.set_gauge(M_REPLICA_ACTIVE_SLOTS, r.get("active_slots") or 0,
                       replica=rid)
        self.set_gauge(M_REPLICA_QUEUED, r.get("queued") or 0, replica=rid)
        self.set_gauge(M_BREAKER_CLOSED,
                       1.0 if r.get("breaker_state") == "closed" else 0.0,
                       replica=rid)

    def _on_route(self, r: Mapping) -> None:
        self.inc(M_ROUTE_DECISIONS_TOTAL, reason=r.get("reason"))

    def _on_restart(self, r: Mapping) -> None:
        gang = r.get("gang_id")
        self.inc(M_GANG_RESTARTS_TOTAL, gang=gang)
        used = r.get("attempts_used")
        budget = r.get("max_restarts")
        if used is not None and budget is not None:
            self.set_gauge(M_GANG_RESTART_BUDGET_REMAINING,
                           max(0, int(budget) - int(used)), gang=gang)

    def _on_transfer(self, r: Mapping) -> None:
        self.inc(M_DCN_BYTES_TOTAL, float(r.get("nbytes") or 0),
                 direction=r.get("direction"))
        if r.get("dur_s") is not None:
            self.observe(M_DCN_TRANSFER_SECONDS, r["dur_s"])

    def _on_stage_step(self, r: Mapping) -> None:
        if r.get("busy_s") is not None:
            self.observe(M_STAGE_STEP_SECONDS, r["busy_s"], stage=r.get("stage"))

    def _on_train_step(self, r: Mapping) -> None:
        if r.get("wall_s") is not None:
            self.observe(M_TRAIN_STEP_SECONDS, r["wall_s"])

    def _on_handoff(self, r: Mapping) -> None:
        self.inc(M_HANDOFF_BYTES_TOTAL, float(r.get("nbytes") or 0))

    def _on_fault(self, r: Mapping) -> None:
        self.inc(M_FAULTS_TOTAL, site=r.get("site"))

    def _on_recovery(self, r: Mapping) -> None:
        self.inc(M_RECOVERY_ACTIONS_TOTAL, action=r.get("action"))

    def _on_alert(self, r: Mapping) -> None:
        self.inc(M_ALERTS_TOTAL, rule=r.get("rule"), state=r.get("state"))

    def _on_scale(self, r: Mapping) -> None:
        self.inc(M_FLEET_SCALE_EVENTS_TOTAL, action=r.get("action"))
        for role, count in (r.get("replicas_by_role") or {}).items():
            self.set_gauge(M_FLEET_REPLICAS_ACTIVE, count, role=role)
        hours = r.get("replica_hours")
        if hours is not None and float(hours) > self._replica_hours_seen:
            self.inc(M_FLEET_REPLICA_HOURS_TOTAL,
                     float(hours) - self._replica_hours_seen,
                     t=r.get("t"))
            self._replica_hours_seen = float(hours)

    # ------------------------------------------------------------ aggregate reads
    def counter_value(self, name: str, **labels) -> float:
        """Cumulative counter value (0.0 when never incremented). With a
        LABELED counter and no labels given, sums across every label set."""
        if labels or not METRIC_REGISTRY[name].labels:
            return self._counters.get((name, _label_key(labels)), 0.0)
        return sum(v for (n, _), v in self._counters.items() if n == name)

    def _sub_horizon(self, window_s: Optional[float]) -> float:
        """A requested sub-window, capped at the plane horizon. Event logs are
        only ever TRIMMED at ``self.window_s`` — a shorter read must filter,
        never pop, or a fast-window read would destroy the slow window's
        events (the multiwindow burn-rate bug this method exists to prevent)."""
        if window_s is None:
            return self.window_s
        return min(float(window_s), self.window_s)

    def window_increase(self, name: str, window_s: Optional[float] = None,
                        now: Optional[float] = None, **labels) -> float:
        """Counter increase inside the trailing window — the rate-style read
        threshold alert rules use. Labeled counters sum across label sets
        when no labels are given (same convention as :meth:`counter_value`)."""
        now = self._clock() if now is None else now
        cutoff = now - self._sub_horizon(window_s)
        keys = (
            [(name, _label_key(labels))]
            if labels or not METRIC_REGISTRY[name].labels
            else [k for k in self._counter_events if k[0] == name]
        )
        total = 0.0
        for key in keys:
            events = self._counter_events.get(key)
            if events is None:
                continue
            self._trim(events, now)
            total += sum(delta for t, delta in events if t >= cutoff)
        return total

    def gauge_value(self, name: str, now: Optional[float] = None, **labels):
        """Current gauge value — None when never set. With a LABELED gauge and
        no labels given, returns ``{rendered_series: value}`` for every label
        set (alert rules reduce with min/max). DERIVED gauges (attainment,
        tokens/s, the SLO window counts) are computed live here — they never
        land in the stored table, and an alert rule naming one must read the
        real value, not permanent None."""
        derived = self._derived_gauge(name, now)
        if derived is not _NO_DERIVED:
            return derived
        if labels or not METRIC_REGISTRY[name].labels:
            return self._gauges.get((name, _label_key(labels)))
        return {
            render_name(n, lk): v
            for (n, lk), v in self._gauges.items() if n == name
        }

    def _derived_gauge(self, name: str, now: Optional[float] = None):
        """The live value of a ``source == "derived"`` gauge, or
        :data:`_NO_DERIVED` for stored metrics."""
        if name == M_SLO_ATTAINMENT:
            return self.attainment(now=now)
        if name == M_TOKENS_PER_SECOND:
            return self.tokens_per_second(now=now)
        if name == M_SLO_WINDOW_GOOD:
            return float(self.slo_window(now=now)[0])
        if name == M_SLO_WINDOW_BAD:
            return float(self.slo_window(now=now)[1])
        return _NO_DERIVED

    def histogram_summary(self, name: str, now: Optional[float] = None,
                          **labels) -> dict:
        """``latency_summary`` block over the trailing window of ``name``."""
        now = self._clock() if now is None else now
        window = self._hists.get((name, _label_key(labels)))
        if window is None:
            return {"count": 0}
        self._trim(window, now)
        return latency_summary([v for _, v in window])

    def slo_window(self, window_s: Optional[float] = None,
                   now: Optional[float] = None) -> Tuple[int, int]:
        """(good, bad) terminal-request counts inside the trailing window —
        the burn-rate numerator/denominator. Sub-windows filter in place (see
        :meth:`_sub_horizon`) so one event log serves every window."""
        now = self._clock() if now is None else now
        cutoff = now - self._sub_horizon(window_s)
        self._trim(self._slo_events, now)
        good = bad = 0
        for t, ok in self._slo_events:
            if t >= cutoff:
                good, bad = (good + 1, bad) if ok else (good, bad + 1)
        return good, bad

    def error_rate(self, window_s: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """bad/(good+bad) over the window; None when no events landed (no
        traffic is not an outage — burn-rate rules skip, not fire)."""
        good, bad = self.slo_window(window_s, now)
        total = good + bad
        return None if total == 0 else bad / total

    def attainment(self, window_s: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """good/(good+bad) over the window (None with no events)."""
        rate = self.error_rate(window_s, now)
        return None if rate is None else 1.0 - rate

    def tokens_per_second(self, window_s: Optional[float] = None,
                          now: Optional[float] = None) -> float:
        """Windowed token delivery rate (terminal-request tokens / window)."""
        now = self._clock() if now is None else now
        horizon = self._sub_horizon(window_s)
        cutoff = now - horizon
        self._trim(self._token_events, now)
        return (sum(n for t, n in self._token_events if t >= cutoff)
                / max(horizon, 1e-9))

    # ------------------------------------------------------------------ snapshots
    def stats(self, now: Optional[float] = None) -> dict:
        """The whole plane as one dict: cumulative counters, current gauges,
        windowed histogram summaries, the SLO block and derived rates —
        keys are Prometheus series spellings (``name{label="v"}``)."""
        if not self.enabled:
            return {"enabled": False}
        now = self._clock() if now is None else now
        counters = {
            render_name(n, lk): v
            for (n, lk), v in sorted(self._counters.items())
        }
        gauges = {
            render_name(n, lk): v
            for (n, lk), v in sorted(self._gauges.items())
        }
        good, bad = self.slo_window(now=now)
        att = self.attainment(now=now)
        if att is not None:
            gauges[M_SLO_ATTAINMENT] = round(att, 6)
        gauges[M_SLO_WINDOW_GOOD] = good
        gauges[M_SLO_WINDOW_BAD] = bad
        gauges[M_TOKENS_PER_SECOND] = round(self.tokens_per_second(now=now), 6)
        histograms = {
            render_name(n, lk): self.histogram_summary(n, now=now, **dict(lk))
            for (n, lk) in sorted(self._hists)
        }
        return {
            "enabled": True,
            "window_s": self.window_s,
            "records_consumed": self.records_consumed,
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
            "slo": {
                "window_good": good,
                "window_bad": bad,
                "attainment": None if att is None else round(att, 6),
            },
        }

    def snapshot_record(self, now: Optional[float] = None,
                        emit: bool = False) -> dict:
        """The ``metrics.snapshot/v1`` record (bench rows stamp it; with
        ``emit=True`` it also rides the telemetry pipeline)."""
        now = self._clock() if now is None else now
        stats = self.stats(now=now)
        record = {
            "schema": METRICS_SNAPSHOT_SCHEMA,
            "t": round(now, 6),
            "counters": stats.get("counters", {}),
            "gauges": stats.get("gauges", {}),
            "histograms": stats.get("histograms", {}),
            "slo": stats.get("slo", {}),
        }
        if emit and self.telemetry is not None:
            self.telemetry.emit(record)
        return record

    def __repr__(self) -> str:
        return (
            f"MetricsPlane(enabled={self.enabled}, "
            f"records_consumed={self.records_consumed}, "
            f"series={len(self._counters) + len(self._gauges) + len(self._hists)})"
        )


# ------------------------------------------------------------------- catalog
def metric_table_markdown() -> str:
    """The metric catalog as a markdown table."""
    lines = [
        "| metric | kind | labels | fed by | meaning |",
        "|---|---|---|---|---|",
    ]
    for name in registered_metrics():
        spec = METRIC_REGISTRY[name]
        labels = ", ".join(f"`{l}`" for l in spec.labels) or "—"
        source = "derived" if spec.source == "derived" else f"`{spec.source}`"
        lines.append(
            f"| `{spec.name}` | {spec.kind} | {labels} | {source} "
            f"| {spec.description} |"
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    """List the registered metrics: name, kind and the record schema that feeds each."""
    import argparse

    argparse.ArgumentParser("python -m accelerate_tpu_torch.telemetry.metrics",
                            description="List the metric registry.").parse_args(argv)
    for name in registered_metrics():
        spec = METRIC_REGISTRY[name]
        print(f"{name}  [{spec.kind}]  <- {spec.source}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
