"""Fault tolerance of the port's serving stack: :class:`~.faults.EngineCrashed`, the
whole-engine death the fleet router fails over from.

The JAX package's ``FaultPlan`` (seeded fault injection at named sites), the engine's
fault boundary (quarantine, bisection, rebuild) and its step watchdog are not ported
yet; ``FleetRouter.kill`` is the out-of-band spelling of a crash.
"""

from .faults import EngineCrashed, FaultError

__all__ = ["EngineCrashed", "FaultError"]
