"""Compile-event counters, the port's counterpart of
``accelerate_tpu/telemetry/compile_monitor.py``.

The port compiles nothing the way XLA does. What it pays at first use, and what a
"recompile storm" would look like, are two other things, and the monitor counts both as
compiles under the active label:

- a CUDA graph capture (``utils.cuda_graph.CapturedStep``: the decode super-steps, the
  prefill programs, the fused speculative super-steps, a ModelDrafter's draft round),
  its seconds the capture and instantiation;
- a kernel built from source at first use (``ops._build.build``: one ``nvcc`` run per
  CUDA source), its seconds the build's wall time.

Each event carries its ``kind`` (``graph_capture`` or ``kernel_build``), counted in
``by_kind``. Live monitors subscribe to one module-level dispatcher; starting and
stopping monitors never leaks listeners.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["CompileMonitor", "compile_label", "dispatch_compile", "COMPILE_KINDS"]

#: The events counted as compiles.
COMPILE_KINDS = ("graph_capture", "kernel_build")

_lock = threading.Lock()
_monitors: list = []  # live CompileMonitor instances
_label_local = threading.local()  # .value: current attribution label or None


def _current_label() -> Optional[str]:
    return getattr(_label_local, "value", None)


class compile_label:
    """Context manager attributing compile events fired inside it to ``name``."""

    def __init__(self, name: Optional[str]):
        self.name = name
        self._prev: Optional[str] = None

    def __enter__(self):
        self._prev = _current_label()
        _label_local.value = self.name
        return self

    def __exit__(self, *exc):
        _label_local.value = self._prev
        return False


def dispatch_compile(kind: str, duration_s: float) -> None:
    """Feed one compile event (``kind`` in :data:`COMPILE_KINDS`) to every live monitor,
    attributed to the current label. Costs a lock and an empty loop with none live."""
    label = _current_label()
    with _lock:
        for mon in _monitors:
            mon._record(kind, duration_s, label)


class CompileMonitor:
    """Counts compile events (count and cumulative seconds, per label and per kind).

    ``start()`` begins listening, ``stop()`` detaches; counters persist across stop so
    end-of-run records can still report totals."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        self.by_label: Dict[str, Dict[str, float]] = {}
        self.by_kind: Dict[str, int] = {k: 0 for k in COMPILE_KINDS}
        self.supported: Optional[bool] = None  # unknown until start()
        self._active = False

    def start(self) -> "CompileMonitor":
        if self._active:
            return self
        self.supported = True
        with _lock:
            _monitors.append(self)
        self._active = True
        return self

    def stop(self) -> None:
        if not self._active:
            return
        with _lock:
            if self in _monitors:
                _monitors.remove(self)
        self._active = False

    def _record(self, kind: str, duration_s: float, label: Optional[str]) -> None:
        self.count += 1
        self.seconds += duration_s
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        if label is not None:
            slot = self.by_label.setdefault(label, {"count": 0, "seconds": 0.0})
            slot["count"] += 1
            slot["seconds"] += duration_s

    def snapshot(self) -> dict:
        """Counter state as plain JSON-serializable values."""
        return {
            "compiles_total": self.count,
            "compile_s_total": round(self.seconds, 6),
            "compiles_by_label": {
                k: {"count": v["count"], "seconds": round(v["seconds"], 6)}
                for k, v in self.by_label.items()
            },
            "compiles_by_kind": dict(self.by_kind),
        }

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
