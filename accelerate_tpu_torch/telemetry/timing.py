"""Fenced step timing, the port's counterpart of ``accelerate_tpu/telemetry/timing.py``.

A kernel launch returns before the device has run it, so a host clock read after the
launch times the dispatch only. :func:`fence` waits for the device through a
``torch.cuda.Event`` recorded after the step's smallest output (typically the scalar
loss): a stream runs its work in order, so the event completes once everything before it
has. It never copies a result to the host. On CPU tensors and host values it does
nothing. :class:`StepTimer` splits a step into ``dispatch_s`` (the host enqueueing it),
``fence_s`` (the wait for the device) and ``wall_s``, their sum.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from ..utils.tree import tree_leaves

__all__ = ["fence", "StepTimer", "StepTiming"]


def fence(out: Any) -> Any:
    """Wait until ``out`` is computed → ``out``. Picks the smallest CUDA tensor leaf of
    ``out`` and synchronizes on an event recorded after it on its device's current
    stream; no data moves to the host. CPU tensors and host values pass untouched."""
    leaves = [leaf for leaf in tree_leaves(out)
              if torch.is_tensor(leaf) and leaf.is_cuda]
    if not leaves:
        return out
    target = min(leaves, key=lambda leaf: leaf.numel())
    with torch.cuda.device(target.device):
        event = torch.cuda.Event()
        event.record()
    event.synchronize()
    return out


@dataclasses.dataclass(frozen=True)
class StepTiming:
    """One fenced step measurement: ``dispatch_s`` the host time to enqueue the step,
    ``fence_s`` the wait until the device finished, ``wall_s`` their sum."""

    wall_s: float
    dispatch_s: float
    fence_s: float


class StepTimer:
    """Monotonic-clock step timer with explicit fencing::

        timer.start()
        state, metrics = step(state, batch)   # launches return at once
        timing = timer.stop(fence_on=metrics["loss"])
    """

    def __init__(self):
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._t0 is not None

    def stop(self, fence_on: Any) -> StepTiming:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        t_dispatched = time.perf_counter()
        fence(fence_on)
        t_done = time.perf_counter()
        t0, self._t0 = self._t0, None
        return StepTiming(wall_s=t_done - t0, dispatch_s=t_dispatched - t0,
                          fence_s=t_done - t_dispatched)

    def time(self, fn, *args, **kwargs):
        """``(out, StepTiming)`` for one fenced call of ``fn``."""
        self.start()
        out = fn(*args, **kwargs)
        return out, self.stop(fence_on=out)
