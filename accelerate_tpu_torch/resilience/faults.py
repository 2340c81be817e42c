"""The fault types of the port's serving stack: a copy of ``FaultError`` and
``EngineCrashed`` from ``accelerate_tpu/resilience/faults.py``."""

from __future__ import annotations

from typing import Optional

__all__ = ["FaultError", "EngineCrashed"]


class FaultError(RuntimeError):
    """Base of every fault the stack raises on purpose."""


class EngineCrashed(FaultError):
    """A whole-engine (replica) death: the in-process stand-in for a killed serving
    process. The engine does not catch it; it propagates out of ``step()`` (or
    ``adopt_handoff``) to the replica's owner, the fleet router, which migrates the
    in-flight requests and hands the replica to its supervisor for a restart."""

    def __init__(self, site: str, uid: Optional[int] = None):
        super().__init__(f"engine crashed at {site}")
        self.site = site
        self.kind = "crash"
        self.uid = uid
