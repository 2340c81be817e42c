"""The serving gateway stack of the port: admission control, scheduling, deadlines,
streaming (``gateway.ServingGateway``), a fleet router over engine replicas
(``fleet.FleetRouter``) and disaggregated prefill/decode serving
(``disagg.DisaggRouter``) — the port's counterpart of ``accelerate_tpu/serving_gateway``.

Host-only Python over ``serving.ContinuousBatcher``: every kernel launch happens inside
the engines. Build with::

    gw = ServingGateway(engine, GatewayConfig(enabled=True, policy="edf"))
    router = DisaggRouter([prefill_engine, decode_engine], GatewayConfig(enabled=True),
                          roles=["prefill", "decode"])
    req = router.submit(prompt, max_new_tokens=64, deadline_s=0.5, on_token=print)
    router.run()

or through ``Accelerator.build_serving_gateway``. ``autoscaler.Autoscaler`` sizes a
fleet from alert transitions through ``spawn_replica``/``decommission``;
``workload`` generates, saves and replays traces on a virtual clock.
"""

from .autoscaler import Autoscaler, default_autoscale_rules
from .disagg import DisaggRouter, parse_roles
from .fleet import ACTIVE, DRAINING, RESTARTING, RETIRED, FleetRouter, Replica
from .gateway import (CANCELLED, DONE, EVICTED, EXPIRED, FAILED, QUEUED, REJECTED, RUNNING,
                      SHED, TERMINAL_STATUSES, CircuitBreaker, GatewayRequest, ServingGateway)
from .policies import (POLICIES, EdfPolicy, FifoPolicy, PriorityPolicy, SchedulerPolicy,
                       WfqPolicy, make_policy)
from .workload import (GENERATORS, WORKLOAD_TRACE_SCHEMA, TraceRequest, VirtualClock,
                       generate_workload, load_trace, replay_trace, save_trace, trace_hash)

__all__ = [
    "GENERATORS", "WORKLOAD_TRACE_SCHEMA", "TraceRequest", "VirtualClock",
    "generate_workload", "load_trace", "replay_trace", "save_trace", "trace_hash",
    "Autoscaler", "default_autoscale_rules",
    "ServingGateway", "GatewayRequest", "CircuitBreaker", "DisaggRouter", "parse_roles",
    "FleetRouter", "Replica", "ACTIVE", "DRAINING", "RESTARTING", "RETIRED",
    "SchedulerPolicy", "FifoPolicy", "PriorityPolicy", "EdfPolicy", "WfqPolicy", "POLICIES",
    "make_policy", "QUEUED", "RUNNING", "DONE", "REJECTED", "SHED", "CANCELLED", "EVICTED",
    "EXPIRED", "FAILED", "TERMINAL_STATUSES",
]
