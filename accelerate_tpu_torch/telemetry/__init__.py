"""Telemetry of the port: fenced step records, serving counter records, request spans.

The counterparts of ``accelerate_tpu/telemetry``'s pipeline (host-only Python apart
from the fence and the memory counters, which read ``torch.cuda``):

- :func:`fence` / :class:`StepTimer`: a step timed through a ``torch.cuda.Event``
  recorded after its smallest output (wall/dispatch/fence split); nothing on the CPU.
- :class:`SteadyStateDetector`: warm until steady; transients are labeled, never
  averaged in.
- :class:`CompileMonitor`: CUDA graph captures and first-use kernel builds, counted as
  compiles with their seconds under the active ``compile_label``.
- :func:`device_memory_stats`: live and peak bytes from the CUDA caching allocator.
- :func:`derived_rates` / :data:`PEAK_TFLOPS`: MFU, tokens/s, examples/s.
- :class:`Telemetry`: the aggregate the ``Accelerator`` carries; records flow to JSONL,
  the bounded history and the sinks. Off by default; zero synchronizations when off.
- :class:`Tracer`: request-scoped spans through engine, gateway, fleet and disagg
  router.
- :class:`MetricsPlane`: the record stream folded into live counters, gauges and
  sliding windows; :class:`AlertEngine` (threshold, burn-rate and sustained-low rules)
  over it; :func:`prometheus_text` and :class:`MetricsExporter` (a loopback HTTP
  scrape endpoint, off unless started).
- :class:`FlightRecorder`: the in-memory ring, tail-promoted spans and incident
  capsules (``TelemetryConfig.recorder``); :func:`provenance_stamp`.
- the clocks, the SLO summaries and the record schemas.

Enable with ``Accelerator(telemetry_config=TelemetryConfig(enabled=True, ...))`` or
``ACCELERATE_TELEMETRY=1``. The scheduled profiler is not ported yet.
"""

from .alerts import AlertEngine, AlertRule, default_alert_rules
from .clocks import WALL_CLOCK, WALL_SLEEP, resolve_clock, resolve_sleep
from .compile_monitor import CompileMonitor, compile_label
from .core import REQUIRED_STEP_COLUMNS, STEP_RECORD_SCHEMA, Telemetry
from .derived import PEAK_HBM_TBPS, PEAK_TFLOPS, derived_rates, peak_tflops
from .exporter import MetricsExporter, prometheus_text
from .memory import device_memory_stats
from .metrics import METRIC_REGISTRY, MetricsPlane, registered_metrics
from .provenance import config_fingerprint, git_commit, provenance_stamp
from .recorder import FlightRecorder, list_capsules, load_capsule
from .schemas import (
    ALERT_SCHEMA,
    CAPSULE_SCHEMA,
    ELASTIC_RESTART_SCHEMA,
    FAULT_SCHEMA,
    FLEET_ROUTE_SCHEMA,
    FLEET_SCALE_SCHEMA,
    GATEWAY_REQUEST_SCHEMA,
    GATEWAY_SLO_SCHEMA,
    METRICS_SNAPSHOT_SCHEMA,
    RECOVERY_SCHEMA,
    REPLICA_HEALTH_SCHEMA,
    SCHEMA_REGISTRY,
    SERVING_HANDOFF_SCHEMA,
    SERVING_KV_SCHEMA,
    SERVING_SCHEMA,
    SERVING_SPEC_SCHEMA,
    SERVING_THROUGHPUT_SCHEMA,
    TRACE_SPAN_SCHEMA,
    registered_schemas,
    validate_record,
)
from .slo import latency_summary, percentile, slo_attainment, slo_summary
from .steady import TELEMETRY_REV, SteadyStateDetector
from .timing import StepTimer, StepTiming, fence
from .tracing import TraceHandle, Tracer

__all__ = [
    "AlertEngine", "AlertRule", "default_alert_rules", "MetricsExporter", "prometheus_text",
    "METRIC_REGISTRY", "MetricsPlane", "registered_metrics", "config_fingerprint",
    "git_commit", "provenance_stamp", "FlightRecorder", "list_capsules", "load_capsule",
    "ALERT_SCHEMA", "CAPSULE_SCHEMA", "FLEET_SCALE_SCHEMA", "METRICS_SNAPSHOT_SCHEMA",
    "WALL_CLOCK", "WALL_SLEEP", "resolve_clock", "resolve_sleep",
    "CompileMonitor", "compile_label", "REQUIRED_STEP_COLUMNS", "STEP_RECORD_SCHEMA",
    "Telemetry", "PEAK_HBM_TBPS", "PEAK_TFLOPS", "derived_rates", "peak_tflops",
    "device_memory_stats",
    "ELASTIC_RESTART_SCHEMA", "FAULT_SCHEMA", "FLEET_ROUTE_SCHEMA", "GATEWAY_REQUEST_SCHEMA",
    "GATEWAY_SLO_SCHEMA", "RECOVERY_SCHEMA", "REPLICA_HEALTH_SCHEMA", "SCHEMA_REGISTRY",
    "SERVING_HANDOFF_SCHEMA", "SERVING_KV_SCHEMA", "SERVING_SCHEMA", "SERVING_SPEC_SCHEMA",
    "SERVING_THROUGHPUT_SCHEMA", "TRACE_SPAN_SCHEMA", "registered_schemas",
    "validate_record", "latency_summary", "percentile", "slo_attainment", "slo_summary",
    "TELEMETRY_REV", "SteadyStateDetector", "StepTimer", "StepTiming", "fence",
    "TraceHandle", "Tracer",
]
