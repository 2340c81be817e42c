"""The record schemas that the port emits, each with its required key set: the
constants and :func:`validate_record` of ``accelerate_tpu/telemetry/schemas.py`` for the
step record, the serving engine's counter, page-pool, speculation and throughput
records, trace spans, fault and recovery records, the gateway stack's handoff, route,
health, restart and SLO records, and the control plane's alert, metrics-snapshot,
capsule and autoscaler records (the ids are the JAX package's, so one consumer reads
both). The MPMD and audit records wait for the modules that emit them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

__all__ = [
    "STEP_RECORD_SCHEMA", "SERVING_SCHEMA", "SERVING_THROUGHPUT_SCHEMA", "SERVING_KV_SCHEMA",
    "SERVING_SPEC_SCHEMA", "TRACE_SPAN_SCHEMA", "FAULT_SCHEMA", "SERVING_HANDOFF_SCHEMA", "GATEWAY_REQUEST_SCHEMA", "GATEWAY_SLO_SCHEMA",
    "REPLICA_HEALTH_SCHEMA", "FLEET_ROUTE_SCHEMA", "FLEET_SCALE_SCHEMA",
    "ELASTIC_RESTART_SCHEMA", "RECOVERY_SCHEMA", "ALERT_SCHEMA", "METRICS_SNAPSHOT_SCHEMA",
    "CAPSULE_SCHEMA", "RecordSchema", "SCHEMA_REGISTRY", "registered_schemas",
    "validate_record",
]

#: Per-step training record (``Telemetry._step_end``).
STEP_RECORD_SCHEMA = "accelerate_tpu.telemetry.step/v1"

#: Per-step serving engine counter record (``ContinuousBatcher``).
SERVING_SCHEMA = "accelerate_tpu.telemetry.serving/v1"

#: One aggregate per ``ContinuousBatcher.run(report_throughput=True)`` drain.
SERVING_THROUGHPUT_SCHEMA = "accelerate_tpu.telemetry.serving.throughput/v1"

#: Per-step page-pool record (paged engines only).
SERVING_KV_SCHEMA = "accelerate_tpu.telemetry.serving.kv/v1"

#: Per-dispatch speculative-decoding record (``spec_k > 0`` engines only).
SERVING_SPEC_SCHEMA = "accelerate_tpu.telemetry.serving.spec/v1"

#: One span per request-lifecycle phase (``telemetry.tracing``): queue, admit,
#: prefill, each decode dispatch, handoff, retries, faults, the terminal state; joined
#: to the step/kv/spec records through the engine ``step`` index.
TRACE_SPAN_SCHEMA = "accelerate_tpu.telemetry.trace.span/v1"

#: One record per fault a recovery boundary observed (injected or real): site, kind,
#: the attributed uid (None when attribution needed bisection), the engine step.
FAULT_SCHEMA = "accelerate_tpu.telemetry.fault/v1"

#: One record per cross-engine KV page handoff (``ops.collectives.kv_page_transfer``):
#: source and destination replica, request uid, page count, bytes and transfer time.
SERVING_HANDOFF_SCHEMA = "accelerate_tpu.telemetry.serving.handoff/v1"

#: One record per gateway request reaching a terminal state.
GATEWAY_REQUEST_SCHEMA = "accelerate_tpu.telemetry.gateway.request/v1"

#: Aggregate gateway summary: terminal counts and the p50/p95/p99 blocks.
GATEWAY_SLO_SCHEMA = "accelerate_tpu.telemetry.gateway.slo/v1"

#: One record per fleet replica per router step: health score, state, role, load.
REPLICA_HEALTH_SCHEMA = "accelerate_tpu.telemetry.replica.health/v1"

#: One record per routing decision (dispatch/probe/handoff/migrate).
FLEET_ROUTE_SCHEMA = "accelerate_tpu.telemetry.fleet.route/v1"

#: One record per gang (replica) restart decision of ``elastic.FleetSupervisor``.
ELASTIC_RESTART_SCHEMA = "accelerate_tpu.telemetry.elastic.restart/v1"

#: One record per recovery action (quarantine, rebuild, bisection round, re-admission,
#: circuit-breaker transition, replica death, drain, restart, replay).
RECOVERY_SCHEMA = "accelerate_tpu.telemetry.recovery/v1"

#: One record per autoscaler decision (``serving_gateway.autoscaler.Autoscaler``):
#: ``action`` scale_up/scale_down/rebalance, the rule or forecast behind it, the fleet
#: size after it, the per-role census, replica-hours and the router-clock time.
FLEET_SCALE_SCHEMA = "accelerate_tpu.telemetry.fleet.scale/v1"

#: One record per alert-state transition (``telemetry.alerts.AlertEngine``): the rule,
#: ``firing``/``resolved``, its kind, the observed value and the bound it crossed.
ALERT_SCHEMA = "accelerate_tpu.telemetry.alert/v1"

#: One point-in-time dump of the metrics plane
#: (``telemetry.metrics.MetricsPlane.snapshot_record``).
METRICS_SNAPSHOT_SCHEMA = "accelerate_tpu.telemetry.metrics.snapshot/v1"

#: The manifest of one incident capsule (``telemetry.recorder.FlightRecorder``): the
#: trigger, the triggering record, the time, the ring's captured and dropped counts, the
#: state snapshots that rode along and the provenance stamp.
CAPSULE_SCHEMA = "accelerate_tpu.telemetry.capsule/v1"


@dataclasses.dataclass(frozen=True)
class RecordSchema:
    """One registered record format: id, the keys a consumer may rely on, who emits
    it, and what it is for."""

    schema: str
    required: frozenset
    emitter: str
    description: str


def _reg(schema: str, required, emitter: str, description: str) -> RecordSchema:
    return RecordSchema(schema, frozenset(required) | {"schema"}, emitter, description)


#: Every record format the port emits, keyed by schema id.
SCHEMA_REGISTRY: Dict[str, RecordSchema] = {
    s.schema: s
    for s in (
        _reg(STEP_RECORD_SCHEMA,
             ("telemetry_rev", "step", "wall_s", "dispatch_s", "fence_s", "steady",
              "warmup_steps_detected", "compiles_total", "compile_s_total",
              "compiles_delta"),
             "Telemetry._step_end",
             "fenced per-step timing, steadiness, compile counters"),
        _reg(SERVING_SCHEMA,
             ("telemetry_rev", "queued", "active_slots", "max_slots", "slot_occupancy",
              "admitted", "evicted", "decode_steps", "decode_tokens"),
             "ContinuousBatcher.step",
             "per-decode-step engine counters (queue, lanes, prefix cache)"),
        _reg(SERVING_THROUGHPUT_SCHEMA,
             ("wall_s", "tokens_generated", "requests_finished", "tokens_per_sec"),
             "ContinuousBatcher.run",
             "aggregate tokens/s for one drained workload"),
        _reg(SERVING_KV_SCHEMA,
             ("telemetry_rev", "step", "page_size", "pages_total", "pages_in_use",
              "page_occupancy", "kv_bytes_in_use", "kv_bytes_total", "kv_shared_pages",
              "kv_alloc_count", "kv_free_count", "kv_cow_count", "kv_adopt_count",
              "kv_defer_count"),
             "ContinuousBatcher.step (paged)",
             "page-pool occupancy/bytes/sharing/churn per decode step"),
        _reg(SERVING_SPEC_SCHEMA,
             ("telemetry_rev", "step", "spec_k", "rounds", "active_slots",
              "step_proposed", "step_accepted", "step_tokens", "proposed_total",
              "accepted_total"),
             "ContinuousBatcher._spec_step / _spec_multi",
             "speculative proposal/acceptance per dispatch (rounds=1 host loop; "
             "rounds=N fused super-step)"),
        _reg(TRACE_SPAN_SCHEMA, ("trace_id", "uid", "span", "t0", "t1", "dur_s"),
             "telemetry.tracing.Tracer",
             "request-scoped lifecycle span (queue/admit/prefill/decode/terminal)"),
        _reg(FAULT_SCHEMA, ("site", "kind"),
             "recovery boundaries (serving/training)",
             "one fault observed at a recovery boundary (injected or real)"),
        _reg(SERVING_HANDOFF_SCHEMA,
             ("src_replica", "dst_replica", "uid", "pages", "nbytes", "dur_s"),
             "ops.collectives.kv_page_transfer",
             "one cross-engine KV page handoff (prefill -> decode replica)"),
        _reg(GATEWAY_REQUEST_SCHEMA,
             ("uid", "status", "reason", "tenant", "priority", "n_tokens",
              "retries_used", "queue_wait_s", "ttft_s", "tpot_s", "deadline_met"),
             "ServingGateway._finalize",
             "one record per request reaching a terminal state"),
        _reg(GATEWAY_SLO_SCHEMA,
             ("policy", "submitted", "admitted", "done", "rejected", "shed",
              "cancelled", "expired", "evicted", "retried", "failed", "replayed", "slo"),
             "ServingGateway.emit_slo_record",
             "aggregate SLO percentiles + admission accounting"),
        _reg(REPLICA_HEALTH_SCHEMA,
             ("replica", "state", "role", "health", "breaker_state", "active_slots",
              "queued", "step_failures"),
             "FleetRouter.step",
             "per-replica health score, state, role and load per router step"),
        _reg(FLEET_ROUTE_SCHEMA,
             ("uid", "replica", "reason", "health", "free_lanes"),
             "FleetRouter",
             "one routing decision: request -> replica (dispatch/probe/migrate)"),
        _reg(ELASTIC_RESTART_SCHEMA,
             ("gang_id", "attempt", "attempts_used", "max_restarts", "exit_codes"),
             "FleetSupervisor",
             "one record per gang restart (gang_id names which gang)"),
        _reg(RECOVERY_SCHEMA, ("action",),
             "recovery boundaries (engine/gateway/fleet router)",
             "one recovery action (quarantine/rebuild/bisect/circuit/replay)"),
        _reg(FLEET_SCALE_SCHEMA, ("action", "reason", "replicas", "t"),
             "serving_gateway.autoscaler.Autoscaler",
             "one autoscaler decision (scale_up/scale_down/rebalance) with the "
             "post-action fleet census"),
        _reg(ALERT_SCHEMA, ("rule", "state", "severity", "kind", "t"),
             "telemetry.alerts.AlertEngine",
             "one alert-state transition (firing/resolved) over plane aggregates"),
        _reg(METRICS_SNAPSHOT_SCHEMA, ("t", "counters", "gauges", "histograms", "slo"),
             "telemetry.metrics.MetricsPlane.snapshot_record",
             "one point-in-time dump of every live counter/gauge/histogram"),
        _reg(CAPSULE_SCHEMA,
             ("trigger", "t", "ring_records", "ring_dropped", "state_keys", "provenance"),
             "telemetry.recorder.FlightRecorder",
             "one incident capsule manifest (trigger, ring/state accounting)"),
    )
}


def registered_schemas() -> List[str]:
    """Every registered schema id, sorted."""
    return sorted(SCHEMA_REGISTRY)


def validate_record(record: Mapping) -> List[str]:
    """Problems with one record against its registration (empty = valid): unknown or
    missing schema id, or required keys the record lacks."""
    schema = record.get("schema")
    if schema is None:
        return ["record has no 'schema' key"]
    reg = SCHEMA_REGISTRY.get(schema)
    if reg is None:
        return [f"unregistered schema {schema!r} (register it in telemetry/schemas.py)"]
    missing = sorted(reg.required - set(record))
    return [f"{schema}: missing required keys {missing}"] if missing else []
