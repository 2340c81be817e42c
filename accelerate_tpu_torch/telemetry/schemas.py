"""The record schemas that the port's gateway stack emits, each with its required key
set: the constants and :func:`validate_record` of ``accelerate_tpu/telemetry/schemas.py``
for the handoff, route, health, recovery, restart and SLO records (the ids are the JAX
package's, so one consumer reads both). The rest of the registry (step, serving
counter, trace span, alert, capsule records) waits for the telemetry slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

__all__ = [
    "SERVING_HANDOFF_SCHEMA", "GATEWAY_REQUEST_SCHEMA", "GATEWAY_SLO_SCHEMA",
    "REPLICA_HEALTH_SCHEMA", "FLEET_ROUTE_SCHEMA", "ELASTIC_RESTART_SCHEMA",
    "RECOVERY_SCHEMA", "RecordSchema", "SCHEMA_REGISTRY", "registered_schemas",
    "validate_record",
]

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

#: One record per recovery action (circuit-breaker transition, replica death, drain,
#: restart, replay).
RECOVERY_SCHEMA = "accelerate_tpu.telemetry.recovery/v1"


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
             "gateway / fleet router",
             "one recovery action (circuit transition, replica death, replay)"),
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
