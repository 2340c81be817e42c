"""Fault tolerance of the port: deterministic fault injection (:class:`~.faults.FaultPlan`
at named sites, with the step watchdog) and the failure types the recovery boundaries
raise and catch.

The recovery machinery lives where the state lives: the serving engine's fault boundary
(quarantine, bisection, in-place rebuild: ``serving.ContinuousBatcher``), the gateway's
circuit breaker and request replay and the fleet router's failover
(``serving_gateway``), and the train step's non-finite guard (``accelerator``).
"""

from .faults import (
    EngineCrashed,
    FaultError,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    NonFiniteStepError,
    StageCrashed,
    StepTimeout,
    StepWatchdog,
    parse_fault_spec,
)

__all__ = [
    "EngineCrashed",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "NonFiniteStepError",
    "StageCrashed",
    "StepTimeout",
    "StepWatchdog",
    "parse_fault_spec",
]
