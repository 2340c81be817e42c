"""Per-replica restart accounting of the fleet router: ``FleetSupervisor`` and the
``backoff_delay`` it schedules with, copies of ``accelerate_tpu/elastic.py``'s.

The subprocess gang supervisor (``ElasticSupervisor``) and the MPMD gang-of-gangs
orchestrator are not ported.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

from .logging import get_logger
from .telemetry.clocks import resolve_clock
from .telemetry.schemas import ELASTIC_RESTART_SCHEMA

logger = get_logger(__name__)

__all__ = ["FleetSupervisor", "backoff_delay"]


def backoff_delay(base: float, jitter: float, attempt: int) -> float:
    """Exponential restart backoff: ``base × 2^attempt`` seconds ± ``jitter``
    fractional random jitter; ``base <= 0`` = immediate."""
    if base <= 0:
        return 0.0
    delay = base * (2.0 ** attempt)
    if jitter:
        delay *= 1.0 + jitter * (2.0 * random.random() - 1.0)
    return max(0.0, delay)


class FleetSupervisor:
    """Per-gang restart accounting for a fleet of replicas: each gang (replica) has an
    independent restart budget and exponential-backoff schedule, and every recorded
    death emits one ``elastic.restart/v1`` record (``gang_id`` names the gang).

    The backoff is a schedule (:meth:`restart_at`), not a sleep: the router keeps
    serving the other replicas while a dead one waits out its delay. The clock is
    injectable for deterministic tests."""

    def __init__(self, max_restarts: int = 1, restart_backoff: float = 0.0,
                 backoff_jitter: float = 0.0, telemetry=None,
                 clock: Optional[Callable[[], float]] = None):
        if max_restarts < 0:
            raise ValueError(f"max_restarts={max_restarts} must be >= 0")
        if restart_backoff < 0:
            raise ValueError(f"restart_backoff={restart_backoff} must be >= 0")
        if not 0.0 <= backoff_jitter <= 1.0:
            raise ValueError(f"backoff_jitter={backoff_jitter} must be in [0, 1]")
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        self.backoff_jitter = float(backoff_jitter)
        self.telemetry = telemetry
        self._clock = resolve_clock(clock)
        self._attempts: dict = {}    # gang_id → failed attempts recorded
        self._restart_at: dict = {}  # gang_id → earliest allowed restart time

    def attempts_used(self, gang_id: str) -> int:
        return self._attempts.get(gang_id, 0)

    def budget_left(self, gang_id: str) -> bool:
        """Does this gang still have restart budget? (Independent per gang.)"""
        return self._attempts.get(gang_id, 0) <= self.max_restarts

    def record_failure(self, gang_id: str, exit_codes=(), reason: str = "failed") -> bool:
        """Record one gang death → True when a restart is still in budget (allowed at
        :meth:`restart_at`, after the backoff). Emits the restart record either way."""
        attempt = self._attempts.get(gang_id, 0)
        self._attempts[gang_id] = attempt + 1
        final = attempt >= self.max_restarts
        if not final:
            self._restart_at[gang_id] = self._clock() + backoff_delay(
                self.restart_backoff, self.backoff_jitter, attempt)
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            tel.emit({
                "schema": ELASTIC_RESTART_SCHEMA, "gang_id": gang_id, "attempt": attempt,
                "attempts_used": self._attempts[gang_id], "max_restarts": self.max_restarts,
                "exit_codes": list(exit_codes), "final": final, "timeout": False,
                "reason": reason,
            })
        logger.warning(f"gang {gang_id} {reason} (attempt {attempt + 1}/"
                       f"{self.max_restarts + 1}{', budget exhausted' if final else ''})")
        return not final

    def restart_at(self, gang_id: str) -> float:
        """Earliest time the gang's next restart is allowed (-inf: never failed)."""
        return self._restart_at.get(gang_id, float("-inf"))

    def may_restart(self, gang_id: str) -> bool:
        """Budget left AND the backoff delay has elapsed."""
        return self.budget_left(gang_id) and self._clock() >= self.restart_at(gang_id)

    def stats(self) -> dict:
        return {
            "max_restarts": self.max_restarts,
            "attempts": dict(self._attempts),
            "exhausted": sorted(g for g, n in self._attempts.items() if n > self.max_restarts),
        }
