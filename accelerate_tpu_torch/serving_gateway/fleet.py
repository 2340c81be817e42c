"""Fleet-level serving: a router over N engine replicas — the port's counterpart of
``accelerate_tpu/serving_gateway/fleet.py``.

:class:`FleetRouter` is a ``ServingGateway`` (one queue, one policy, the same submit
contract and SLO records) dispatching into a fleet of ``ContinuousBatcher`` replicas:

- **Health-driven routing** — a per-replica score from lane occupancy, the engine's
  own queue, page-pool occupancy and recent step failures; admission goes to the
  healthiest least-loaded routable replica (a ``fleet.route/v1`` record each), and
  every router step emits one ``replica.health/v1`` record per replica.
- **Per-replica circuit breakers** — OPEN isolates one replica while the others
  serve; a half-open probe earns routing back.
- **Failover** — a replica death (:meth:`FleetRouter.kill`, or ``EngineCrashed`` out
  of its ``step()``: a ``crash`` clause of the engine's ``FaultPlan``) migrates its in-flight requests to the queue by replay
  (``on_retry`` resets the stream; the transcript ends equal to an undisturbed
  run's) at no cost to the preemption retry budget; the replica restarts through
  ``engine_factory`` within the per-replica budget of an ``elastic.FleetSupervisor``,
  or retires.
- **Drain / rolling restart / retire** — :meth:`drain` stops routing to a replica and
  restarts it when its requests finish (or migrates them past the drain deadline);
  :meth:`rolling_restart` walks the fleet one replica at a time;
  :meth:`decommission` drains a replica and retires it.

A tracer (``tracer=``) threads through every replica engine (restarted ones
included), as in the single-engine gateway; a request a replica's fault boundary
quarantined ends ``FAILED`` with its reason.

- **Scale** — :meth:`spawn_replica` appends a replica built by ``engine_factory`` (its
  geometry checked, its breaker HALF-OPEN, so one probe earns it full routing) and
  :meth:`decommission` drains one and retires it; an attached
  ``autoscaler.Autoscaler`` is polled at the end of every step, and ``replica_hours``
  integrates the live replicas over the router's clock.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from ..elastic import FleetSupervisor
from ..resilience.faults import EngineCrashed
from ..telemetry.schemas import FLEET_ROUTE_SCHEMA, RECOVERY_SCHEMA, REPLICA_HEALTH_SCHEMA
from ..utils.dataclasses import GatewayConfig
from .gateway import CANCELLED, DONE, EXPIRED, FAILED, QUEUED, RUNNING, CircuitBreaker, \
    GatewayRequest, ServingGateway

__all__ = ["FleetRouter", "Replica", "ACTIVE", "DRAINING", "RESTARTING", "RETIRED"]

# ------------------------------------------------------------- replica states
ACTIVE = "active"          # routable (subject to its breaker)
DRAINING = "draining"      # no new admissions; in-flight finishing (→ restart)
RESTARTING = "restarting"  # dead or stopped; waiting out the supervisor's backoff
RETIRED = "retired"        # restart budget spent, or decommissioned: out for good


class Replica:
    """One engine replica's routing state: the engine, its breaker, the requests it
    serves (engine uid → gateway request; engine uids are unique per engine only) and
    the failure times its health score reads."""

    def __init__(self, rid: int, engine, breaker: CircuitBreaker):
        self.rid = rid
        self.engine = engine
        self.breaker = breaker
        self.state = ACTIVE
        self.running: Dict[int, GatewayRequest] = {}
        self.failures_seen = getattr(engine, "step_failures", 0)
        self.fail_times: List[float] = []
        self.drain_deadline: Optional[float] = None
        self.restarts = 0
        #: Decommission: retire (no restart budget charged) when the drain completes.
        self.retire_on_drain = False

    @property
    def gang_id(self) -> str:
        return f"replica{self.rid}"

    def free_lanes(self) -> int:
        eng = self.engine
        return eng.max_slots - sum(r is not None for r in eng.slot_req) - len(eng.queue)

    def __repr__(self) -> str:
        return (f"Replica({self.rid}, state={self.state!r}, running={len(self.running)}, "
                f"breaker={self.breaker.state!r})")


#: Seconds of failure history the health score weighs.
HEALTH_WINDOW_S = 60.0


class FleetRouter(ServingGateway):
    """Health-routed, failover-capable gateway over N ``ContinuousBatcher`` replicas.

    ``engines`` share one geometry (``max_slots``, ``max_len``, ``prompt_bucket``,
    ``page_size``: admission prices one layout). ``engine_factory(rid)`` builds a
    replacement engine for restarts; without one a dead replica retires.
    ``supervisor`` owns the restart budgets and backoff (by default one built from the
    config on the router's clock)."""

    def __init__(self, engines: Sequence, config: Optional[GatewayConfig] = None,
                 telemetry=None, clock: Optional[Callable[[], float]] = None,
                 tracer=None, engine_factory: Optional[Callable[[int], object]] = None,
                 supervisor: Optional[FleetSupervisor] = None):
        engines = list(engines)
        if not engines:
            raise ValueError("FleetRouter needs at least one engine replica")
        geo = [(e.max_slots, e.max_len, e.prompt_bucket, e.page_size) for e in engines]
        if len(set(geo)) > 1:
            raise ValueError(
                f"fleet replicas must share one engine geometry (max_slots/max_len/"
                f"prompt_bucket/page_size), got {geo}: the admission cost model prices "
                "ONE layout")
        if config is not None and config.degrade:
            raise ValueError(
                "degrade=True is a single-engine breaker rung ladder; the fleet degrades "
                "by ISOLATING replicas instead — disable it")
        super().__init__(engines[0], config, telemetry=telemetry, clock=clock,
                         tracer=tracer)
        self.engine_factory = engine_factory
        cfg = self.config
        self.supervisor = supervisor if supervisor is not None else FleetSupervisor(
            max_restarts=cfg.replica_restarts, restart_backoff=cfg.replica_restart_backoff,
            telemetry=telemetry, clock=self._clock)
        for eng in engines:
            self._bind_tracer(eng)
        self._replicas: List[Replica] = [
            Replica(rid, eng, self._new_breaker()) for rid, eng in enumerate(engines)]
        self.counters.update({"migrated": 0, "replica_kills": 0, "replica_restarts": 0,
                              "replica_retired": 0, "replica_spawned": 0})
        self._steps = 0
        #: Replica-hours: ACTIVE and DRAINING replicas integrated over the router's
        #: clock (the autoscale bench's cost axis).
        self.replica_hours = 0.0
        self._last_step_t: Optional[float] = None
        #: The attached ``autoscaler.Autoscaler``, polled at the end of every step.
        self._autoscaler = None
        #: Replica ids awaiting their turn in a rolling restart.
        self._rolling: List[int] = []
        self._rolling_deadline_s: Optional[float] = None
        #: Requests finalized outside a step (the all-retired backlog flush after an
        #: out-of-band ``kill()``), returned by the next ``step()``.
        self._pending_events: List[GatewayRequest] = []

    def _bind_tracer(self, engine) -> None:
        """Hand the router's tracer to an engine that has none."""
        if self.tracer is not None and getattr(engine, "tracer", None) is None:
            engine.tracer = self.tracer

    def _new_breaker(self) -> CircuitBreaker:
        cfg = self.config
        return CircuitBreaker(cfg.breaker_threshold, cfg.breaker_window_s,
                              cfg.breaker_cooldown_s)

    # ------------------------------------------------------------- introspection
    @property
    def replicas(self) -> List[Replica]:
        return list(self._replicas)

    @property
    def running_count(self) -> int:
        return sum(len(rep.running) for rep in self._replicas)

    def replica_health(self, rid: int) -> float:
        return self._health(self._replicas[rid], self._clock())

    # ---------------------------------------------------------------- admission
    def _admission_gate(self, greq: GatewayRequest, now: float) -> Optional[str]:
        """Refuse only when no replica could ever serve the request (every replica
        retired); a replica with an open breaker, draining or restarting keeps the
        request queued."""
        if all(rep.state == RETIRED for rep in self._replicas):
            return "fleet_down"
        return None

    def _free_lanes(self) -> int:
        now = self._clock()
        return sum(rep.free_lanes() for rep in self._replicas if self._routable(rep, now))

    def _routable(self, rep: Replica, now: float) -> bool:
        """May ``rep`` take a new admission now? (Read-only: the probe is assigned at
        dispatch through ``breaker.gate``.)"""
        if rep.state != ACTIVE:
            return False
        br = rep.breaker
        if br.enabled and br.state != "closed":
            if br.state == "open":
                return now - br._opened_at >= br.cooldown_s  # will half-open
            return br.probe_uid is None  # half-open: one outstanding probe
        return True

    def _health(self, rep: Replica, now: float) -> float:
        """Health in [0, 1]: recent step failures, lane occupancy, the engine's own
        queue depth (deferred paged admissions wait there) and page-pool occupancy;
        dead or retired replicas score 0, a breaker not closed caps it at 0.25."""
        if rep.state in (RESTARTING, RETIRED):
            return 0.0
        eng = rep.engine
        rep.fail_times = [t for t in rep.fail_times if now - t <= HEALTH_WINDOW_S]
        fail_scale = max(1, rep.breaker.threshold or 3)
        score = 1.0
        score -= 0.5 * min(1.0, len(rep.fail_times) / fail_scale)
        active = sum(r is not None for r in eng.slot_req)
        score -= 0.2 * (active / eng.max_slots)
        score -= 0.1 * min(1.0, len(eng.queue) / eng.max_slots)
        if eng.paged:
            ms = eng.block_mgr
            score -= 0.2 * (ms.pages_in_use / ms.num_pages)
        if rep.breaker.enabled and rep.breaker.state != "closed":
            score = min(score, 0.25)
        return max(0.0, round(score, 4))

    def _pick_replica(self, now: float,
                      reps: Optional[List[Replica]] = None) -> Optional[Replica]:
        """The next admission's replica: a half-open replica with no outstanding probe
        first; else the healthiest routable replica with free lanes (ties: most free
        lanes, then lowest rid). ``reps`` restricts the candidates (the disaggregated
        router's role subsets)."""
        if reps is None:
            reps = self._replicas
        probes = [rep for rep in reps
                  if rep.state == ACTIVE and rep.breaker.enabled
                  and rep.breaker.state != "closed" and self._routable(rep, now)
                  and rep.free_lanes() > 0]
        if probes:
            return probes[0]
        candidates = [rep for rep in reps if self._routable(rep, now) and rep.free_lanes() > 0]
        if not candidates:
            return None
        return max(candidates, key=lambda r: (self._health(r, now), r.free_lanes(), -r.rid))

    def _dispatch(self, greq: GatewayRequest, rep: Replica, now: float) -> None:
        """Admit ``greq`` into ``rep``'s engine, recorded as ``fleet.route/v1``."""
        probe = False
        if rep.breaker.enabled:
            gate = rep.breaker.gate(greq.uid, now)
            assert gate is None, (rep, gate)  # _routable said yes
            probe = rep.breaker.probe_uid == greq.uid
        greq.status = RUNNING
        greq.t_admit = now
        greq._rid = rep.rid
        self.counters["admitted"] += 1
        ereq = rep.engine.submit(
            greq.prompt, gen=greq.gen,
            seed=greq.seed if greq.gen.temperature > 0.0 else None,
            on_token=self._stream_cb(greq))
        greq._engine_req = ereq
        rep.running[ereq.uid] = greq
        self._trace_admitted(greq, ereq, now)
        self._emit_route(greq.uid, rep, "probe" if probe else "dispatch", now)

    # ------------------------------------------------------------------ stepping
    def step(self) -> List[GatewayRequest]:
        """One fleet cycle: expire deadline violators, advance replica lifecycles
        (drains, restart backoffs, the rolling restart), preempt, admit queued requests
        to routable replicas in policy order, step every live replica (a crash fails
        over instead of propagating), feed each replica's failures to its breaker, and
        emit the ``replica.health/v1`` records."""
        now = self._clock()
        self._steps += 1
        if self._last_step_t is not None and now > self._last_step_t:
            live = sum(1 for rep in self._replicas if rep.state in (ACTIVE, DRAINING))
            self.replica_hours += (now - self._last_step_t) / 3600.0 * live
        self._last_step_t = now
        events: List[GatewayRequest] = self._pending_events
        self._pending_events = []
        # 1) queued deadline expiry.
        for item in self._policy.items():
            if item.deadline_at is not None and now > item.deadline_at:
                self._policy.remove(item.uid)
                self._queued_cost -= item.cost
                self.counters["expired"] += 1
                self._finalize(item, EXPIRED, "deadline_queued", now)
                events.append(item)
        # 2) running deadline eviction, per replica.
        for rep in self._replicas:
            for greq in list(rep.running.values()):
                if greq.deadline_at is not None and now > greq.deadline_at:
                    rep.engine.cancel(greq._engine_req.uid)
                    rep.running.pop(greq._engine_req.uid, None)
                    greq.tokens = list(greq._engine_req.tokens)
                    self.counters["expired"] += 1
                    self._finalize(greq, EXPIRED, "deadline_running", now)
                    events.append(greq)
        # 3) replica lifecycle.
        self._advance_replicas(now, events)
        # 4) priority preemption (opt-in), fleet-wide.
        if self.config.preempt:
            events.extend(self._preempt(now))
        # 5) admit in policy order while some replica can take the work.
        while len(self._policy):
            rep = self._pick_replica(now)
            if rep is None:
                break
            item = self._policy.pop(now)
            self._queued_cost -= item.cost
            self._dispatch(item, rep, now)
        # 6) step every live replica; a crash is the failover signal.
        for rep in self._replicas:
            if rep.state in (RESTARTING, RETIRED):
                continue
            try:
                finished = rep.engine.step()
            except EngineCrashed as e:
                self._replica_died(rep, f"crash:{e.site}", now)
                continue
            t_done = self._clock()
            for ereq in finished:
                greq = rep.running.pop(ereq.uid, None)
                if greq is None:
                    continue
                self._complete(greq, ereq, events, t_done)
            self._observe_replica(rep, now)
        # 7) lifecycle again with this step's completions applied (a drain whose last
        #    request just finished restarts now).
        self._advance_replicas(self._clock(), events)
        events.extend(self._pending_events)
        self._pending_events = []
        self._emit_health(now)
        if self._autoscaler is not None:
            self._autoscaler.poll(self._clock())
        return sorted(events, key=lambda r: r.uid)

    def run(self, report_slo: bool = False):
        """The base drain loop, stepping on while out-of-band terminals wait to be
        returned."""
        out: List[GatewayRequest] = []
        while self.queue_depth or self.running_count or self._pending_events:
            out.extend(self.step())
        if report_slo:
            return out, self.emit_slo_record()
        return out

    def _observe_replica(self, rep: Replica, now: float) -> None:
        """The replica's step-failure delta into its breaker and health window; a trip
        isolates the replica and migrates its in-flight requests."""
        failures = getattr(rep.engine, "step_failures", 0)
        delta = failures - rep.failures_seen
        rep.failures_seen = failures
        if delta > 0:
            rep.fail_times.extend([now] * delta)
        if rep.breaker.record_failures(delta, now):
            rep.breaker.open(now)
            self._emit_fleet_recovery("circuit_open", rep, now)
            self._migrate(rep, f"breaker_open:replica{rep.rid}", now, engine_alive=True)

    # ------------------------------------------------------------------ failover
    def _migrate(self, rep: Replica, cause: str, now: float,
                 engine_alive: bool) -> List[GatewayRequest]:
        """Move every in-flight request off ``rep`` back to the queue by replay. A live
        engine's lanes are cancelled first; a crashed engine is abandoned."""
        migrated = []
        for greq in list(rep.running.values()):
            if engine_alive:
                rep.engine.cancel(greq._engine_req.uid)
            self._replay_requeue(greq, now, cause)
            self.counters["migrated"] += 1
            self._emit_route(greq.uid, rep, "migrate", now)
            migrated.append(greq)
        rep.running.clear()
        return migrated

    def _replica_died(self, rep: Replica, reason: str, now: float) -> None:
        """A replica's engine is gone: migrate its requests, then restart it when the
        supervisor's budget and backoff allow, or retire it."""
        self.counters["replica_kills"] += 1
        self._migrate(rep, reason, now, engine_alive=False)
        allowed = self.supervisor.record_failure(rep.gang_id, reason=reason)
        if allowed and self.engine_factory is not None:
            rep.state = RESTARTING
        else:
            self._retire(rep, now)
        self._emit_fleet_recovery("replica_died", rep, now, reason=reason)

    def _retire(self, rep: Replica, now: float) -> None:
        rep.state = RETIRED
        self.counters["replica_retired"] += 1
        self._emit_fleet_recovery("replica_retired", rep, now)
        if all(r.state == RETIRED for r in self._replicas):
            # Nothing left to serve with: fail the backlog (returned by the next step).
            for item in self._policy.items():
                self._policy.remove(item.uid)
                self._queued_cost -= item.cost
                self.counters["failed"] += 1
                self._finalize(item, FAILED, "fleet_down", now)
                self._pending_events.append(item)

    def kill(self, rid: int, reason: str = "killed") -> None:
        """Treat replica ``rid`` as dead right now (the out-of-band spelling of a
        crash): its engine is marked ``crashed`` and abandoned."""
        rep = self._replicas[rid]
        if rep.state in (RESTARTING, RETIRED):
            return
        rep.engine.crashed = True
        self._replica_died(rep, reason, self._clock())

    # ------------------------------------------------------------------ scale down
    def spawn_replica(self, role: Optional[str] = None) -> Replica:
        """Scale-up actuator: append a replica built by ``engine_factory`` (the
        fleet's geometry, checked), its breaker started HALF-OPEN so that one probe earns
        it full routing, as a restarted replica's. ``role`` is refused here: the disagg
        router's override grows its role table."""
        if self.engine_factory is None:
            raise ValueError("spawn_replica needs an engine_factory — a fleet that "
                             "cannot build engines cannot grow")
        if role is not None:
            raise ValueError("role-aware spawning is a DisaggRouter capability; a flat "
                             "fleet has no roles")
        rid = len(self._replicas)
        engine = self.engine_factory(rid)
        ref = self._replicas[0].engine
        geo = (engine.max_slots, engine.max_len, engine.prompt_bucket, engine.page_size)
        ref_geo = (ref.max_slots, ref.max_len, ref.prompt_bucket, ref.page_size)
        if geo != ref_geo:
            raise ValueError(f"spawned replica geometry {geo} != fleet geometry "
                             f"{ref_geo}: the admission cost model prices ONE layout")
        self._bind_tracer(engine)
        rep = Replica(rid, engine, self._new_breaker())
        self._replicas.append(rep)
        self.counters["replica_spawned"] += 1
        if rep.breaker.enabled:
            rep.breaker.force_half_open()
        self._emit_fleet_recovery("replica_spawn", rep, self._clock())
        return rep

    def decommission(self, rid: int, deadline_s: Optional[float] = None) -> Replica:
        """Drain replica ``rid`` and retire it when the drain completes (a planned
        exit: no restart budget charged)."""
        rep = self.drain(rid, deadline_s)
        rep.retire_on_drain = True
        return rep

    # ------------------------------------------------------------ drain / restart
    def drain(self, rid: int, deadline_s: Optional[float] = None) -> Replica:
        """Stop routing new admissions to replica ``rid``; its requests run until they
        finish or the drain deadline passes (then they migrate), after which it
        restarts and earns routing back through a half-open probe."""
        rep = self._replicas[rid]
        if rep.state != ACTIVE:
            raise ValueError(f"replica {rid} is {rep.state}, not active")
        if deadline_s is None:
            deadline_s = self.config.drain_deadline_s
        rep.state = DRAINING
        rep.drain_deadline = None if deadline_s is None else self._clock() + float(deadline_s)
        self._emit_fleet_recovery("drain", rep, self._clock())
        return rep

    def rolling_restart(self, deadline_s: Optional[float] = None) -> None:
        """Restart every replica, one at a time: each next drain starts once the
        previous replica is back and fully routable."""
        self._rolling = [rep.rid for rep in self._replicas if rep.state == ACTIVE]
        self._rolling_deadline_s = deadline_s
        if self._rolling:
            self.drain(self._rolling.pop(0), deadline_s)

    def _advance_replicas(self, now: float, events: List[GatewayRequest]) -> None:
        for rep in self._replicas:
            if rep.state == DRAINING:
                overdue = rep.drain_deadline is not None and now > rep.drain_deadline
                if overdue and rep.running:
                    self._migrate(rep, f"drain_deadline:replica{rep.rid}", now,
                                  engine_alive=True)
                if not rep.running:
                    self._restart(rep, now)
            elif rep.state == RESTARTING:
                if self.engine_factory is not None and self.supervisor.may_restart(rep.gang_id):
                    self._restart(rep, now)
        if self._rolling and all(
                rep.state == RETIRED
                or (rep.state == ACTIVE and (not rep.breaker.enabled
                                             or rep.breaker.state == "closed"))
                for rep in self._replicas):
            while self._rolling:
                rid = self._rolling.pop(0)
                if self._replicas[rid].state == ACTIVE:
                    self.drain(rid, self._rolling_deadline_s)
                    break

    def _restart(self, rep: Replica, now: float) -> None:
        """Bring a drained or dead replica back: a fresh engine from the factory (or
        the drained engine itself without one), then the half-open probe warm-up."""
        if rep.retire_on_drain:
            rep.drain_deadline = None
            self._retire(rep, now)
            return
        if self.engine_factory is not None:
            rep.engine = self.engine_factory(rep.rid)
            self._bind_tracer(rep.engine)
            if rep.rid == 0:
                self.engine = rep.engine  # the base class's kv_demand reads it
        rep.failures_seen = getattr(rep.engine, "step_failures", 0)
        rep.fail_times = []
        rep.drain_deadline = None
        rep.restarts += 1
        rep.state = ACTIVE
        self.counters["replica_restarts"] += 1
        if rep.breaker.enabled:
            rep.breaker.force_half_open()
        self._emit_fleet_recovery("replica_restart", rep, now)

    def _probe_verdict(self, greq: GatewayRequest, status: str, now: float) -> None:
        """Per-replica probe fate: DONE closes that replica's breaker, FAILED re-opens
        it; any other terminal state frees the probe slot."""
        for rep in self._replicas:
            br = rep.breaker
            if br.probe_uid is None or br.probe_uid != greq.uid:
                continue
            if status == DONE:
                br.close(now)
                self._emit_fleet_recovery("circuit_close", rep, now)
            elif status == FAILED:
                br.open(now)
                self._emit_fleet_recovery("circuit_open", rep, now)
            else:
                br.probe_uid = None
            return

    # ------------------------------------------------------------------- control
    def cancel(self, uid: int) -> bool:
        greq = self._all.get(uid)
        if greq is None or greq.terminal:
            return False
        now = self._clock()
        if greq.status == QUEUED:
            self._policy.remove(greq.uid)
            self._queued_cost -= greq.cost
            self.counters["cancelled"] += 1
            self._finalize(greq, CANCELLED, "cancelled_queued", now)
            return True
        rep = self._replicas[greq._rid]
        rep.engine.cancel(greq._engine_req.uid)
        rep.running.pop(greq._engine_req.uid, None)
        greq.tokens = list(greq._engine_req.tokens)
        self.counters["cancelled"] += 1
        self._finalize(greq, CANCELLED, "cancelled_running", now)
        return True

    def _preempt(self, now: float) -> List[GatewayRequest]:
        """Fleet-wide preemption: the least urgent running request (on a replica whose
        breaker is closed) yields its lane to a strictly higher-priority queued one,
        admitted into that replica directly."""
        events: List[GatewayRequest] = []
        while len(self._policy):
            running = [(rep, greq) for rep in self._replicas
                       if rep.state == ACTIVE
                       and (not rep.breaker.enabled or rep.breaker.state == "closed")
                       for greq in rep.running.values()]
            if not running or self._free_lanes() > 0:
                break
            top = max(self._policy.items(), key=lambda i: (i.priority, -i.uid))
            rep, victim = min(running, key=lambda rg: (rg[1].priority, -rg[1].uid))
            if victim.priority >= top.priority:
                break
            rep.engine.cancel(victim._engine_req.uid)
            rep.running.pop(victim._engine_req.uid, None)
            if self.tracer is not None:
                self.tracer.event(victim._trace, "preempt", t=now, preempted_by=top.uid,
                                  tokens_lost=len(victim._engine_req.tokens))
            self._policy.take(top.uid, now)
            self._queued_cost -= top.cost
            self._dispatch(top, rep, now)
            evicted = self._preempt_victim_requeue(victim, now)
            if evicted is not None:
                events.append(evicted)
        return events

    def reattach_engine(self, engine=None, reason: str = "engine_restart"):
        raise NotImplementedError(
            "the fleet router owns replica recovery itself — use kill()/drain()/"
            "rolling_restart(); single-engine replay is ServingGateway's")

    # ---------------------------------------------------------------- telemetry
    def _emit_route(self, uid: int, rep: Replica, reason: str, now: float) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        tel.emit({"schema": FLEET_ROUTE_SCHEMA, "uid": uid, "replica": rep.rid,
                  "reason": reason, "health": self._health(rep, now),
                  "free_lanes": rep.free_lanes(), "step": self._steps, "t": now})

    def _emit_health(self, now: float) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        for rep in self._replicas:
            eng = rep.engine
            record = {
                "schema": REPLICA_HEALTH_SCHEMA, "replica": rep.rid, "state": rep.state,
                "role": getattr(eng, "role", "mixed"), "health": self._health(rep, now),
                "breaker_state": rep.breaker.state,
                "active_slots": sum(r is not None for r in eng.slot_req),
                "queued": len(eng.queue), "step_failures": getattr(eng, "step_failures", 0),
                "restarts": rep.restarts, "step": self._steps, "t": now,
            }
            if eng.paged:
                record["page_occupancy"] = round(
                    eng.block_mgr.pages_in_use / eng.block_mgr.num_pages, 4)
            tel.emit(record)

    def _emit_fleet_recovery(self, action: str, rep: Replica, now: float, **cols) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        tel.emit({"schema": RECOVERY_SCHEMA, "action": action, "t": now,
                  "replica": rep.rid, "replica_state": rep.state,
                  "breaker_state": rep.breaker.state, **cols})

    # ------------------------------------------------------------------ reporting
    def stats(self) -> dict:
        """Fleet counters with one block per replica."""
        now = self._clock()
        return {
            "policy": self._policy.name, "queued": len(self._policy),
            "queued_cost_tokens": self._queued_cost, "running": self.running_count,
            **dict(self.counters),
            "replicas": [
                {"replica": rep.rid, "state": rep.state, "health": self._health(rep, now),
                 "breaker_state": rep.breaker.state,
                 "breaker_openings": rep.breaker.openings,
                 "breaker_closings": rep.breaker.closings, "running": len(rep.running),
                 "restarts": rep.restarts, "engine": rep.engine.stats()}
                for rep in self._replicas],
            "supervisor": self.supervisor.stats(),
            "slo": self.slo_summary(),
            # The metrics plane's snapshot: the health and route records this router
            # emits land there as labeled gauges, the signals the autoscaler polls.
            **({"metrics": self.metrics.stats()} if self.metrics is not None else {}),
        }

    def __repr__(self) -> str:
        states = ",".join(f"{r.rid}:{r.state}" for r in self._replicas)
        return (f"FleetRouter(policy={self._policy.name!r}, replicas=[{states}], "
                f"queued={len(self._policy)}, running={self.running_count})")
