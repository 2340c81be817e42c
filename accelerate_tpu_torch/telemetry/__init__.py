"""Serving telemetry of the port: the clock domain, the SLO summaries and the record
schemas that the gateway stack emits.

Copies of ``accelerate_tpu/telemetry/{clocks,slo,schemas}.py`` (host-only Python, no
device code). Records go to any object with ``enabled`` and ``emit(record)``, duck-typed
as in the JAX package. The ``Telemetry`` pipeline itself, span tracing (``Tracer``),
the metrics plane, alerts and the flight recorder wait for the telemetry slice.
"""

from .clocks import WALL_CLOCK, WALL_SLEEP, resolve_clock, resolve_sleep
from .schemas import (
    ELASTIC_RESTART_SCHEMA,
    FLEET_ROUTE_SCHEMA,
    GATEWAY_REQUEST_SCHEMA,
    GATEWAY_SLO_SCHEMA,
    RECOVERY_SCHEMA,
    REPLICA_HEALTH_SCHEMA,
    SCHEMA_REGISTRY,
    SERVING_HANDOFF_SCHEMA,
    registered_schemas,
    validate_record,
)
from .slo import latency_summary, percentile, slo_attainment, slo_summary

__all__ = [
    "WALL_CLOCK", "WALL_SLEEP", "resolve_clock", "resolve_sleep",
    "ELASTIC_RESTART_SCHEMA", "FLEET_ROUTE_SCHEMA", "GATEWAY_REQUEST_SCHEMA",
    "GATEWAY_SLO_SCHEMA", "RECOVERY_SCHEMA", "REPLICA_HEALTH_SCHEMA", "SCHEMA_REGISTRY",
    "SERVING_HANDOFF_SCHEMA", "registered_schemas", "validate_record",
    "latency_summary", "percentile", "slo_attainment", "slo_summary",
]

