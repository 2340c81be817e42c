"""Closed-loop fleet sizing of the port, a copy of
``accelerate_tpu/serving_gateway/autoscaler.py``: alert transitions become scale
actions.

The trigger surface is the ``AlertEngine`` rules firing ``alert/v1`` off the live
``MetricsPlane``; the actuators are ``FleetRouter``/``DisaggRouter`` with
``engine_factory``, ``spawn_replica`` and ``decommission``. An
:class:`Autoscaler` subscribes to ``alert/v1`` transitions on the router's
telemetry stream and drives the fleet through the machinery that already
exists, never around it:

- **Scale-up** — ``spawn_replica()``: a fresh replica from the restart
  ``engine_factory``, admitted to routing through the same half-open probe
  warm-up a restarted replica earns its way back with. On the card the factory
  calls ``warm_programs()`` before the replica takes traffic, so growth captures
  no CUDA graph inside traffic.
- **Scale-down** — ``decommission()``: always a drain, so in-flight requests
  finish or migrate via the replay path (byte-identical streams, never
  stranded), then a retirement that charges NO supervisor restart budget — a
  planned exit is not a failure.
- **Thrash guards** — per-direction cooldowns, min/max fleet bounds, and the
  scale-down trigger is the ``sustained_low`` hysteresis rule kind
  (fire needs the full window below, clear needs the value back above a
  DISTINCT higher bound), so the controller cannot flap on the threshold
  that fired it.
- **Role-ratio control** (disagg fleets) — sustained handoff-backlog per
  decode replica (or router-queue depth per prefill replica with an empty
  handoff backlog) shifts the prefill:decode ratio by spawning one role and
  retiring the other: fleet size holds, the ratio follows the prompt-length
  mix.
- **Predictive layer** — reactive rules catch what already went wrong; the
  forecaster anticipates. Offered load for the next window is extrapolated
  from the trace's OWN arrival history (two consecutive windowed arrival
  rates, linear extrapolation — no wall clocks, no new deps), divided by an
  online per-replica service-rate estimate, and the deficit spawns ahead of
  the ramp.

Every decision is one ``fleet.scale/v1`` record on the router's (virtual)
clock, carrying the action, the triggering reason, the post-action per-role
census and the cumulative replica-hours — the audit trail
``serve-bench --autoscale`` replays deterministically under ``VirtualClock``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..telemetry.alerts import AlertEngine, AlertRule
from ..telemetry.clocks import resolve_clock
from ..telemetry.metrics import (
    M_REPLICA_ACTIVE_SLOTS,
    M_REPLICA_QUEUED,
    M_REQUESTS_TOTAL,
)
from ..telemetry.schemas import ALERT_SCHEMA, FLEET_SCALE_SCHEMA
from .fleet import ACTIVE, RETIRED, FleetRouter, Replica

__all__ = ["Autoscaler", "default_autoscale_rules", "FLEET_SCALE_SCHEMA"]


def default_autoscale_rules(
    queue_high: float = 4.0,
    queue_window_s: float = 30.0,
    idle_lane_floor: float = 1.0,
    idle_clear: Optional[float] = None,
    idle_window_s: float = 45.0,
    objective: float = 0.9,
    fast_window_s: float = 30.0,
    slow_window_s: float = 120.0,
    burn_threshold: float = 3.0,
) -> Tuple[List[AlertRule], List[AlertRule]]:
    """The stock ``(up_rules, down_rules)`` pair the autoscale bench arms.

    Up: the SLO burn rate (attainment actively bleeding), windowed
    expired/shed terminals (router-level backpressure — a fleet's ENGINE
    queues stay near-empty by construction, so overload surfaces as deadline
    expiry and shed, not engine queue depth), and per-replica engine queue
    depth for mixed/single topologies. Down: the ``sustained_low`` hysteresis
    rule on the FLEET-WIDE sum of active decode lanes — the fleet must stay
    below ``idle_lane_floor`` busy lanes for the full ``idle_window_s``, and
    the rule only re-arms once the sum climbs to ``idle_clear`` (default: one
    above the floor)."""
    if idle_clear is None:
        idle_clear = idle_lane_floor + 1.0
    up = [
        AlertRule("scale-up-slo-burn", kind="burn_rate", severity="page",
                  objective=objective, fast_window_s=fast_window_s,
                  slow_window_s=slow_window_s, burn_threshold=burn_threshold),
        AlertRule("scale-up-expired", metric=M_REQUESTS_TOTAL,
                  labels={"status": "expired"}, threshold=0.0,
                  window_s=queue_window_s, severity="page"),
        AlertRule("scale-up-shed", metric=M_REQUESTS_TOTAL,
                  labels={"status": "shed"}, threshold=0.0,
                  window_s=queue_window_s, severity="page"),
        AlertRule("scale-up-queue", metric=M_REPLICA_QUEUED,
                  threshold=queue_high, window_s=queue_window_s,
                  severity="ticket"),
    ]
    down = [
        AlertRule("scale-down-idle", kind="sustained_low",
                  metric=M_REPLICA_ACTIVE_SLOTS, threshold=idle_lane_floor,
                  clear_threshold=idle_clear, window_s=idle_window_s,
                  reduce="sum", severity="ticket"),
    ]
    return up, down


class Autoscaler:
    """Alert-driven fleet-size controller over one :class:`FleetRouter`.

    ``up_rules`` / ``down_rules`` are :class:`AlertRule` objects (armed on
    the router's metrics plane as one :class:`AlertEngine`) or bare rule
    NAMES (armed elsewhere — the autoscaler only needs to recognize their
    transitions). Either way the controller acts on the firing LEVEL folded
    from ``alert/v1`` transition records: a persistently-firing up rule keeps
    ramping one replica per cooldown until it resolves or ``max_replicas``
    binds.

    The router polls the controller at the end of every ``step()`` (after
    health emission, so decisions read this step's signals), on the router's
    own clock — fully deterministic under ``VirtualClock`` replay. No wall
    clocks, no randomness, no background threads.
    """

    def __init__(self, router: FleetRouter, *,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 cooldown_s: float = 30.0,
                 down_cooldown_s: Optional[float] = None,
                 eval_interval_s: float = 1.0,
                 up_rules: Optional[Sequence] = None,
                 down_rules: Optional[Sequence] = None,
                 drain_deadline_s: Optional[float] = None,
                 predictive: bool = True,
                 forecast_window_s: float = 30.0,
                 forecast_util_floor: float = 0.85,
                 forecast_warmup: int = 3,
                 headroom: float = 1.25,
                 queue_backlog_per_replica: float = 4.0,
                 rebalance_window_s: float = 20.0,
                 backlog_per_decode: float = 2.0,
                 queue_per_prefill: float = 4.0,
                 default_role: str = "decode",
                 telemetry=None,
                 clock: Optional[Callable[[], float]] = None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas={min_replicas} must be >= 1 "
                             "(a fleet of zero serves nobody)")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas={max_replicas} must be >= "
                             f"min_replicas={min_replicas}")
        if router.engine_factory is None:
            raise ValueError(
                "Autoscaler needs the router built with an engine_factory — "
                "scale-up spawns replicas through it"
            )
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = float(cooldown_s)
        self.down_cooldown_s = (self.cooldown_s if down_cooldown_s is None
                                else float(down_cooldown_s))
        self.eval_interval_s = float(eval_interval_s)
        self.drain_deadline_s = drain_deadline_s
        self.predictive = bool(predictive)
        self.forecast_window_s = float(forecast_window_s)
        self.forecast_util_floor = float(forecast_util_floor)
        self.forecast_warmup = int(forecast_warmup)
        self.headroom = float(headroom)
        self.queue_backlog_per_replica = float(queue_backlog_per_replica)
        self.rebalance_window_s = float(rebalance_window_s)
        self.backlog_per_decode = float(backlog_per_decode)
        self.queue_per_prefill = float(queue_per_prefill)
        self.default_role = default_role
        # One clock domain: explicitly injected wins, else the router's.
        self._clock = resolve_clock(clock, getattr(router, "_clock", None))
        self.telemetry = telemetry if telemetry is not None else router.telemetry

        self._up_names: set = set()
        self._down_names: set = set()
        rule_objs: List[AlertRule] = []
        for rule in (up_rules or []):
            if isinstance(rule, AlertRule):
                rule_objs.append(rule)
                self._up_names.add(rule.name)
            else:
                self._up_names.add(str(rule))
        for rule in (down_rules or []):
            if isinstance(rule, AlertRule):
                rule_objs.append(rule)
                self._down_names.add(str(rule.name))
            else:
                self._down_names.add(str(rule))
        self.engine: Optional[AlertEngine] = None
        if rule_objs:
            if router.metrics is None:
                raise ValueError(
                    "AlertRule objects need the router's metrics plane — "
                    "build the router with GatewayConfig(metrics=True), or "
                    "pass rule NAMES armed on an external engine"
                )
            self.engine = AlertEngine(router.metrics, rule_objs,
                                      telemetry=self.telemetry,
                                      eval_interval_s=eval_interval_s)

        #: rule name → currently-firing level, folded from transitions.
        self._firing: Dict[str, bool] = {}
        #: Every ``fleet.scale/v1`` record emitted, in order.
        self.events: List[dict] = []
        self._last_eval: Optional[float] = None
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None
        #: Predictive state: (t, submitted, done) samples one forecast window
        #: apart, busy-lane accumulator between samples, and the per-LANE
        #: service-rate EMA fitted from them. Per-lane (completions over mean
        #: BUSY lanes), not per-replica (completions over fleet size): the
        #: latter is utilization-bound and makes every underloaded fleet
        #: forecast a deficit of headroom x size.
        self._samples: List[Tuple[float, int, int]] = []
        self._lane_acc: List[float] = [0.0, 0.0]
        self._mu: Optional[float] = None
        self._mu_updates = 0
        self._last_util: float = 0.0
        #: Forecast persistence anchor: a deficit must survive one full
        #: forecast window before the controller acts on it — one noisy
        #: arrival window must not buy a replica.
        self._deficit_since: Optional[float] = None
        #: Role-ratio dwell anchors (router-clock time pressure started).
        self._decode_pressure_since: Optional[float] = None
        self._prefill_pressure_since: Optional[float] = None

        if self.telemetry is not None and getattr(self.telemetry, "enabled",
                                                  False):
            self.telemetry.sinks.append(self._on_record)
        router._autoscaler = self

    # ----------------------------------------------------------- alert intake
    def _on_record(self, record) -> None:
        """Telemetry sink: fold ``alert/v1`` transitions into firing levels.
        Only the rules this controller was told about participate — an
        unrelated page must not resize the fleet."""
        if record.get("schema") != ALERT_SCHEMA:
            return
        rule = record.get("rule")
        if rule in self._up_names or rule in self._down_names:
            self._firing[rule] = record.get("state") == "firing"

    # -------------------------------------------------------------- census
    def _live(self) -> List[Replica]:
        """Replicas that count toward fleet size: not retired, not already
        on their way out (a decommissioned replica stops counting the moment
        the decision lands, so bounds see the POST-action size)."""
        return [rep for rep in self.router._replicas
                if rep.state != RETIRED and not rep.retire_on_drain]

    def replicas_by_role(self) -> Dict[str, int]:
        census: Dict[str, int] = {}
        for rep in self._live():
            role = getattr(rep.engine, "role", "mixed")
            census[role] = census.get(role, 0) + 1
        return census

    # ------------------------------------------------------------- main loop
    def poll(self, now: Optional[float] = None) -> None:
        """One control evaluation (the router calls this at the end of every
        ``step()``), throttled to ``eval_interval_s`` of router-clock time.
        At most ONE action per evaluation — a controller that scales twice in
        one tick cannot attribute either move to a signal."""
        now = self._clock() if now is None else now
        if (self._last_eval is not None
                and now - self._last_eval < self.eval_interval_s):
            return
        self._last_eval = now
        self._observe(now)
        if self._maybe_scale_up(now):
            return
        if self._maybe_rebalance(now):
            return
        self._maybe_scale_down(now)

    # ------------------------------------------------------------ predictive
    def _observe(self, now: float) -> None:
        """Sample the arrival/completion counters one forecast window apart
        and refit the per-lane service-rate EMA from completions over the
        mean number of BUSY lanes in the window."""
        if not self.predictive:
            return
        self._lane_acc[0] += float(sum(len(rep.running)
                                       for rep in self._live()))
        self._lane_acc[1] += 1.0
        if (self._samples
                and now - self._samples[-1][0] < self.forecast_window_s):
            return
        counters = self.router.counters
        mean_busy = (self._lane_acc[0] / self._lane_acc[1]
                     if self._lane_acc[1] else 0.0)
        self._lane_acc = [0.0, 0.0]
        replicas = self.router._replicas
        slots = getattr(replicas[0].engine, "max_slots", 1) if replicas else 1
        self._last_util = mean_busy / max(1.0,
                                          float(slots * len(self._live())))
        self._samples.append((now, int(counters.get("submitted", 0)),
                              int(counters.get("done", 0))))
        if len(self._samples) > 3:
            self._samples.pop(0)
        if len(self._samples) >= 2 and mean_busy > 0:
            (t0, _s0, d0), (t1, _s1, d1) = self._samples[-2], self._samples[-1]
            dt = t1 - t0
            if dt > 0:
                mu_lane = (d1 - d0) / dt / mean_busy
                if mu_lane > 0:
                    self._mu = (mu_lane if self._mu is None
                                else 0.5 * self._mu + 0.5 * mu_lane)
                    self._mu_updates += 1

    def _forecast_deficit(self, now: float) -> Optional[str]:
        """Predictive scale-up reason: linear extrapolation of the windowed
        arrival rate says next window's offered load (× headroom) exceeds
        what the current fleet clears at the fitted per-lane service rate.

        Two sanity gates keep the forecaster honest: the service-rate EMA
        must have ``forecast_warmup`` updates behind it (cold-start windows
        produce garbage estimates), and the fleet's busy-lane share over the
        last window must be at least ``forecast_util_floor`` — predictive
        spawning is about staying ahead of a ramp that is already FILLING the
        lanes; while there is slack, the reactive rules own the decision."""
        if len(self._samples) < 3 or not self._mu:
            return None
        if (self._mu_updates < self.forecast_warmup
                or self._last_util < self.forecast_util_floor):
            return None
        (ta, sa, _), (tb, sb, _), (tc, sc, _) = self._samples
        if tb <= ta or tc <= tb:
            return None
        r_prev = (sb - sa) / (tb - ta)
        r_last = (sc - sb) / (tc - tb)
        forecast = max(0.0, r_last + (r_last - r_prev))
        replicas = self.router._replicas
        slots = getattr(replicas[0].engine, "max_slots", 1) if replicas else 1
        capacity = self._mu * max(1, slots)
        needed = math.ceil(forecast * self.headroom / capacity)
        if needed > len(self._live()):
            return (f"forecast:rate={round(forecast, 4)}"
                    f",mu_lane={round(self._mu, 4)},needed={needed}")
        return None

    # ----------------------------------------------------------------- actions
    def _maybe_scale_up(self, now: float) -> bool:
        reason = next((name for name in sorted(self._up_names)
                       if self._firing.get(name)), None)
        if reason is None:
            # Built-in backlog signal: the controller owns the router, and
            # the router's own queue depth is the purest overload evidence —
            # arrival extrapolation goes blind to a standing backlog the
            # moment the arrival rate turns back down.
            depth = self.router.queue_depth
            bound = self.queue_backlog_per_replica * max(1, len(self._live()))
            if depth > bound:
                reason = f"queue_backlog:depth={depth},bound={round(bound, 1)}"
        if reason is None and self.predictive:
            forecast = self._forecast_deficit(now)
            if forecast is None:
                self._deficit_since = None
            else:
                if self._deficit_since is None:
                    self._deficit_since = now
                if now - self._deficit_since >= self.forecast_window_s:
                    reason = forecast
        if reason is None:
            return False
        if (self._last_up_t is not None
                and now - self._last_up_t < self.cooldown_s):
            return False
        if len(self._live()) >= self.max_replicas:
            return False
        role = (self.default_role
                if getattr(self.router, "roles", None) is not None else None)
        rep = self.router.spawn_replica(role)
        self._record("scale_up", reason, now, replica=rep.rid, role=role)
        self._last_up_t = now
        self._deficit_since = None
        return True

    def _maybe_scale_down(self, now: float) -> bool:
        reason = next((name for name in sorted(self._down_names)
                       if self._firing.get(name)), None)
        if reason is None:
            return False
        if (self._last_down_t is not None
                and now - self._last_down_t < self.down_cooldown_s):
            return False
        if len(self._live()) <= self.min_replicas:
            return False
        victim = self._pick_victim(now)
        if victim is None:
            return False
        role = (getattr(victim.engine, "role", "mixed")
                if getattr(self.router, "roles", None) is not None else None)
        self.router.decommission(victim.rid, self.drain_deadline_s)
        self._record("scale_down", reason, now, replica=victim.rid, role=role)
        self._last_down_t = now
        return True

    def _pick_victim(self, now: float,
                     role: Optional[str] = None) -> Optional[Replica]:
        """Cheapest planned exit: an ACTIVE replica (optionally of one role),
        fewest in-flight requests first (least to drain/migrate), highest rid
        on ties; replica 0 is spared while any alternative exists (the base
        gateway's cost model reads its engine)."""
        candidates = [rep for rep in self.router._replicas
                      if rep.state == ACTIVE and not rep.retire_on_drain]
        if role is not None:
            candidates = [rep for rep in candidates
                          if getattr(rep.engine, "role", "mixed") == role]
        nonzero = [rep for rep in candidates if rep.rid != 0]
        if nonzero:
            candidates = nonzero
        if not candidates:
            return None
        return min(candidates, key=lambda rep: (len(rep.running), -rep.rid))

    def _maybe_rebalance(self, now: float) -> bool:
        """Disagg role-ratio control: sustained handoff backlog per decode
        replica trades a prefill replica for a decode one; sustained router
        queue per prefill replica with an EMPTY handoff backlog trades the
        other way. Spawn-then-drain, so capacity never dips mid-shift."""
        router = self.router
        if getattr(router, "roles", None) is None:
            return False
        census = self.replicas_by_role()
        n_prefill = sum(n for role, n in census.items()
                        if role in ("prefill", "mixed"))
        n_decode = sum(n for role, n in census.items()
                       if role in ("decode", "mixed"))
        backlog = len(getattr(router, "_handoffs", ()))
        queue_depth = len(router._policy)
        if backlog / max(1, n_decode) > self.backlog_per_decode:
            if self._decode_pressure_since is None:
                self._decode_pressure_since = now
        else:
            self._decode_pressure_since = None
        if backlog == 0 and queue_depth / max(1, n_prefill) > self.queue_per_prefill:
            if self._prefill_pressure_since is None:
                self._prefill_pressure_since = now
        else:
            self._prefill_pressure_since = None

        grow, shrink, since, why = None, None, None, None
        if (self._decode_pressure_since is not None
                and census.get("prefill", 0) > 1):
            grow, shrink = "decode", "prefill"
            since, why = self._decode_pressure_since, "decode_backlog"
        elif (self._prefill_pressure_since is not None
                and census.get("decode", 0) > 1):
            grow, shrink = "prefill", "decode"
            since, why = self._prefill_pressure_since, "prefill_queue"
        if grow is None or now - since < self.rebalance_window_s:
            return False
        if (self._last_up_t is not None
                and now - self._last_up_t < self.cooldown_s):
            return False
        victim = self._pick_victim(now, role=shrink)
        if victim is None:
            return False
        rep = router.spawn_replica(grow)
        router.decommission(victim.rid, self.drain_deadline_s)
        self._record("rebalance", why, now, replica=rep.rid, role=grow,
                     retired_replica=victim.rid, retired_role=shrink)
        self._last_up_t = now
        self._last_down_t = now
        self._decode_pressure_since = None
        self._prefill_pressure_since = None
        return True

    # ----------------------------------------------------------------- record
    def _record(self, action: str, reason: str, now: float, **cols) -> None:
        census = self.replicas_by_role()
        record = {
            "schema": FLEET_SCALE_SCHEMA,
            "action": action,
            "reason": reason,
            "replicas": sum(census.values()),
            "replicas_by_role": census,
            "replica_hours": round(self.router.replica_hours, 6),
            "t": round(now, 6),
            **cols,
        }
        self.events.append(record)
        if self.telemetry is not None and getattr(self.telemetry, "enabled",
                                                  False):
            self.telemetry.emit(record)

    # ------------------------------------------------------------------ report
    def stats(self) -> dict:
        return {
            "bounds": [self.min_replicas, self.max_replicas],
            "replicas": len(self._live()),
            "replicas_by_role": self.replicas_by_role(),
            "replica_hours": round(self.router.replica_hours, 6),
            "scale_events": len(self.events),
            "actions": {
                action: sum(1 for e in self.events if e["action"] == action)
                for action in ("scale_up", "scale_down", "rebalance")
            },
            "firing": sorted(n for n, f in self._firing.items() if f),
            "service_rate_per_lane": self._mu,
        }

    def __repr__(self) -> str:
        return (f"Autoscaler(replicas={len(self._live())}, "
                f"bounds=[{self.min_replicas},{self.max_replicas}], "
                f"events={len(self.events)})")
