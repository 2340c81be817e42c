"""The one sanctioned wall-clock source of the clock-injectable serving components
(gateway, fleet router, supervisor): a copy of ``accelerate_tpu/telemetry/clocks.py``.

Components default ``clock=None`` and resolve it through :func:`resolve_clock`, so a
composition keeps one time domain: a test's manual clock reaches every layer it is
handed to, and nothing falls back to the wall clock behind its back.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

__all__ = ["WALL_CLOCK", "WALL_SLEEP", "resolve_clock", "resolve_sleep"]

#: The sanctioned wall clock: monotonic, so backoff schedules and deadline arithmetic
#: survive NTP steps.
WALL_CLOCK: Callable[[], float] = time.monotonic

#: The sanctioned wall sleep, paired with :data:`WALL_CLOCK`.
WALL_SLEEP: Callable[[float], None] = time.sleep


def resolve_clock(clock: Optional[Callable[[], float]] = None,
                  *inherit: Optional[Callable[[], float]]) -> Callable[[], float]:
    """The injected ``clock``; else the first non-None ``inherit`` candidate (a bound
    collaborator's clock); else :data:`WALL_CLOCK`."""
    if clock is not None:
        return clock
    for candidate in inherit:
        if candidate is not None:
            return candidate
    return WALL_CLOCK


def resolve_sleep(sleep: Optional[Callable[[float], None]] = None
                  ) -> Callable[[float], None]:
    """The injected sleep, else :data:`WALL_SLEEP`."""
    return WALL_SLEEP if sleep is None else sleep
