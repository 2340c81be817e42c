"""Elastic supervision: the port's copy of ``accelerate_tpu/elastic.py``'s
``ElasticSupervisor`` with ``WorkerFailure``, and ``FleetSupervisor`` with the
``backoff_delay`` both schedule with.

``ElasticSupervisor`` owns one gang of worker processes with whole-gang restarts: any
worker's death (a crash, a preemption's SIGKILL, a non-zero exit) tears the survivors
down, and the whole gang is launched again on a fresh rendezvous port, up to
``max_restarts`` times. A ``torch.distributed`` process group is formed once, like the
JAX coordinator's, so a gang is never patched with one replacement. Training resumes
from the last valid checkpoint (``Accelerator.load_state`` + ``skip_first_batches``).
``FleetSupervisor`` keeps the fleet router's per-replica restart budgets.

Not ported: the MPMD gang-of-gangs orchestrator (``GangOfGangs``), which needs
``parallel/mpmd.py``.
"""

from __future__ import annotations

import random
import subprocess
import time
from typing import Callable, Optional, Sequence

from .logging import get_logger
from .telemetry.clocks import resolve_clock
from .telemetry.schemas import ELASTIC_RESTART_SCHEMA
from .utils.other import get_free_port

logger = get_logger(__name__)

__all__ = ["ElasticSupervisor", "FleetSupervisor", "WorkerFailure", "backoff_delay"]


def backoff_delay(base: float, jitter: float, attempt: int) -> float:
    """Exponential restart backoff: ``base × 2^attempt`` seconds ± ``jitter``
    fractional random jitter; ``base <= 0`` = immediate."""
    if base <= 0:
        return 0.0
    delay = base * (2.0 ** attempt)
    if jitter:
        delay *= 1.0 + jitter * (2.0 * random.random() - 1.0)
    return max(0.0, delay)


class WorkerFailure(RuntimeError):
    """The gang exhausted its restart budget; ``exit_codes`` are the last attempt's."""

    def __init__(self, message: str, exit_codes: Sequence[Optional[int]]):
        super().__init__(message)
        self.exit_codes = list(exit_codes)


class ElasticSupervisor:
    """Supervise a gang of worker processes with restart on failure.

    ``make_plan(rendezvous_address) -> list[(cmd, env)]`` builds each worker's launch
    for one attempt; it is called again with a fresh ``host:port`` on every restart, so
    a stale rendezvous never poisons the new gang.

    - Health: every worker polled each ``monitor_interval`` seconds. A worker that exits
      non-zero or dies from a signal (a preemption shows as SIGKILL, a negative
      returncode) tears the gang down for a restart.
    - ``grace_period``: the survivors get SIGTERM, then SIGKILL after this many seconds.
    - ``attempt_timeout``: the liveness horizon of one attempt (a gang where one worker
      exits 0 and another hangs would otherwise be watched forever); past it the attempt
      is torn down and counted as failed.
    - ``restart_backoff``: ``backoff × 2^attempt`` seconds between restarts, ±
      ``backoff_jitter`` (a fraction) of random jitter; 0 restarts at once.
    - ``on_restart(attempt, codes)``: called for every failed attempt.
    - ``telemetry``: an enabled ``telemetry.Telemetry`` gets one ``elastic.restart/v1``
      record per failed attempt (its index, exit codes, budget, ``final`` and
      ``timeout``), the attempt that exhausts the budget included.
    """

    def __init__(self, make_plan: Callable[[str], list], max_restarts: int = 0,
                 monitor_interval: float = 0.2, grace_period: float = 5.0,
                 coordinator_host: str = "127.0.0.1", coordinator_port: Optional[int] = None,
                 on_restart: Optional[Callable[[int, list], None]] = None, telemetry=None,
                 restart_backoff: float = 0.0, backoff_jitter: float = 0.0,
                 attempt_timeout: Optional[float] = None, gang_id: str = "gang0"):
        if restart_backoff < 0:
            raise ValueError(f"restart_backoff={restart_backoff} must be >= 0")
        if not 0.0 <= backoff_jitter <= 1.0:
            raise ValueError(f"backoff_jitter={backoff_jitter} must be in [0, 1]")
        if attempt_timeout is not None and attempt_timeout <= 0:
            raise ValueError(f"attempt_timeout={attempt_timeout} must be > 0")
        self.make_plan = make_plan
        self.max_restarts = max_restarts
        self.monitor_interval = monitor_interval
        self.grace_period = grace_period
        self.coordinator_host = coordinator_host
        self.coordinator_port = coordinator_port
        self.on_restart = on_restart
        self.telemetry = telemetry
        self.restart_backoff = restart_backoff
        self.backoff_jitter = backoff_jitter
        self.attempt_timeout = attempt_timeout
        #: The gang's name in its restart records.
        self.gang_id = str(gang_id)
        self.attempts_used = 0
        self.attempt_timeouts = 0

    def _emit_restart_record(self, attempt: int, codes: list, final: bool = False,
                             timeout: bool = False) -> None:
        tel = self.telemetry
        if tel is None or not getattr(tel, "enabled", False):
            return
        tel.emit({
            "schema": ELASTIC_RESTART_SCHEMA, "gang_id": self.gang_id, "attempt": attempt,
            "attempts_used": self.attempts_used, "max_restarts": self.max_restarts,
            "exit_codes": list(codes), "final": final, "timeout": timeout,
        })

    def _backoff_delay(self, attempt: int) -> float:
        return backoff_delay(self.restart_backoff, self.backoff_jitter, attempt)

    def _coordinator(self) -> str:
        port = self.coordinator_port or get_free_port()
        self.coordinator_port = None  # a fresh port on every later attempt
        return f"{self.coordinator_host}:{port}"

    def _spawn(self, plans) -> list:
        return [subprocess.Popen(cmd, env=env) for cmd, env in plans]

    def _teardown(self, procs: list) -> None:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + self.grace_period
        for p in procs:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.kill()
                p.wait()

    def run(self) -> int:
        """Run the gang to completion: 0, or ``WorkerFailure`` once the budget is spent."""
        codes: list = []
        timed_out = False
        for attempt in range(self.max_restarts + 1):
            self.attempts_used = attempt + 1
            procs = self._spawn(self.make_plan(self._coordinator()))
            started = time.monotonic()
            timed_out = False
            while True:
                codes = [p.poll() for p in procs]
                if any(c is not None and c != 0 for c in codes):
                    break
                if all(c == 0 for c in codes):
                    return 0
                if (self.attempt_timeout is not None
                        and time.monotonic() - started > self.attempt_timeout):
                    timed_out = True
                    self.attempt_timeouts += 1
                    break
                time.sleep(self.monitor_interval)
            self._teardown(procs)
            codes = [p.returncode for p in procs]
            final = attempt >= self.max_restarts
            logger.warning(f"worker group {'timed out' if timed_out else 'failed'} with exit "
                           f"codes {codes} (attempt {attempt + 1}/{self.max_restarts + 1})")
            self._emit_restart_record(attempt, codes, final=final, timeout=timed_out)
            if self.on_restart is not None:
                self.on_restart(attempt, codes)
            if not final:
                delay = self._backoff_delay(attempt)
                if delay > 0:
                    logger.warning(f"backing off {delay:.2f}s before restart "
                                   f"(restart_backoff={self.restart_backoff})")
                    time.sleep(delay)
        raise WorkerFailure(
            f"worker group {'timed out' if timed_out else 'failed'} after "
            f"{self.max_restarts + 1} attempts (last exit codes {codes})", codes)


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
