"""Steady-state detection: a copy of ``accelerate_tpu/telemetry/steady.py``.

Warm until K consecutive windows agree within a relative tolerance, THEN measure: a
one-time post-capture allocator transient is labeled (``warmup_steps_detected``), never
averaged into a step time. ``TELEMETRY_REV`` is stamped into every record; records
stamped with one revision are comparable.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["SteadyStateDetector", "TELEMETRY_REV"]

#: Measurement-methodology revision (the bench.py ``_BENCH_REV`` lineage). Rev 2 =
#: warm-until-steady. Stamped into every telemetry record and BENCH_SELF record.
TELEMETRY_REV = 2


class SteadyStateDetector:
    """Warm until ``k`` consecutive windows agree within ``rtol``, then mark steady.

    Feed per-window durations (one step, or one fused round — any consistent unit)
    to :meth:`observe`; it returns True once steady state is reached. Transients are
    *labeled*, never averaged in: ``warmup_steps_detected`` says how many leading
    windows were still settling, and every window observed after that is steady.

    ``max_windows`` caps the warmup (the bench_rev-2 "cap 5"): a workload that never
    settles within the cap is declared steady anyway with ``capped=True``, so a noisy
    host degrades to the old fixed-warmup behavior instead of warming forever.
    ``max_windows=0`` disables the cap.
    """

    def __init__(self, k: int = 2, rtol: float = 0.10, max_windows: int = 5):
        if k < 2:
            raise ValueError(f"k={k}: agreement needs at least 2 windows")
        if rtol <= 0:
            raise ValueError(f"rtol={rtol} must be > 0")
        if max_windows < 0:
            raise ValueError(f"max_windows={max_windows} must be >= 0 (0 = no cap)")
        # max_windows < k is allowed: the cap fires before agreement is possible and
        # every window is labeled warmup (bench's BENCH_MAX_SETTLE_ROUNDS=1 contract).
        self.k = k
        self.rtol = rtol
        self.max_windows = max_windows
        self.durations: List[float] = []
        self.steady = False
        self.capped = False
        self._agree_run = 1  # consecutive agreeing windows, current one included
        self._warmup: Optional[int] = None  # frozen at the moment steadiness fires

    @property
    def warmup_steps_detected(self) -> Optional[int]:
        """Leading windows that were still settling (None until steady; frozen at
        detection — later observations never relabel the past).

        The ``k`` agreeing windows that *triggered* steadiness count as steady, so
        on the PERF_NOTES shape ``[10.2, 2.1, 0.47, 0.46]`` this is 2 — the 10 s and
        2 s rounds are the transient, the two agreeing ~0.46 s rounds are not. When
        the cap fired, EVERY observed window counts as warmup (none proved steady).
        """
        return self._warmup

    def agrees(self, a: float, b: float) -> bool:
        """The rev-2 agreement predicate: relative gap within ``rtol`` of the larger."""
        return abs(a - b) <= self.rtol * max(a, b)

    def observe(self, duration_s: float) -> bool:
        """Record one window; returns whether steady state has been reached."""
        if self.steady:
            self.durations.append(duration_s)
            return True
        prev = self.durations[-1] if self.durations else None
        self.durations.append(duration_s)
        if prev is not None and self.agrees(duration_s, prev):
            self._agree_run += 1
        else:
            self._agree_run = 1
        if self._agree_run >= self.k:
            self.steady = True
            self._warmup = len(self.durations) - self.k
        elif self.max_windows and len(self.durations) >= self.max_windows:
            # Cap reached without agreement: every observed window was (potentially)
            # transient — label them all warmup rather than pretend any was steady.
            self.steady = True
            self.capped = True
            self._warmup = len(self.durations)
        return self.steady

    def steady_mean_s(self) -> Optional[float]:
        """Mean duration over the steady windows only (None before steady, or when
        the cap fired — a capped detector saw no provably-steady window)."""
        if not self.steady or self.capped:
            return None
        steady = self.durations[self.warmup_steps_detected :]
        return sum(steady) / len(steady) if steady else None

    def __repr__(self) -> str:
        return (
            f"SteadyStateDetector(steady={self.steady}, capped={self.capped}, "
            f"windows={len(self.durations)}, "
            f"warmup_steps_detected={self.warmup_steps_detected})"
        )
