"""Disaggregated prefill/decode serving: role-aware routing over a split fleet — the
port's counterpart of ``accelerate_tpu/serving_gateway/disagg.py``.

- **Replica roles** — each engine is ``prefill`` / ``decode`` / ``mixed``
  (``ContinuousBatcher(role=...)``, matched by ``roles=`` or
  ``GatewayConfig.replica_roles`` and rebuilt with the same role by the restart
  ``engine_factory``). Prefill replicas prefill admitted requests on lanes freed the
  same step and export each request's KV as a page-list ``serving.KVHandoff``;
  decode replicas never prefill: they adopt handoffs (full context pages read-only,
  the boundary page copied on write) and run decode-only lanes, where kernel #1 reads
  the adopted pages.
- **Cross-engine page handoff** — the source gathers the handoff's pages
  (``export_page_block``), ``ops.collectives.kv_page_transfer`` moves the block to the
  decode replica's device (a no-op when both share one card, a peer copy otherwise;
  one ``serving.handoff/v1`` record each), and the decode replica scatters it into its
  pool (``adopt_handoff``).
- **Role-aware routing** — :class:`DisaggRouter` (a ``FleetRouter``) dispatches
  admissions to the healthiest prefill-capable replica, collects finished prefills
  into a FIFO handoff queue, checks ``can_adopt_handoff`` BEFORE gathering (a deferred
  adoption pays no copy; it is counted in ``handoff_defers``) and adopts onto the
  healthiest decode-capable replica. Admission is priced by the decode side's
  adoption demand; the prefill side only validates the context.
- **Failover** — a dead prefill replica's in-flight and pending requests re-prefill
  on a peer by replay; a dead decode replica's requests RE-ADOPT from the source pages
  the handoff record still holds (``readopted``), and fall back to replay when the
  source is gone too. Streams end equal to an undisturbed run's either way. A
  ``crash`` clause of a replica engine's ``FaultPlan`` reaches the failover as
  ``EngineCrashed`` out of its ``step()`` or ``adopt_handoff``; any other exception out
  of ``adopt_handoff`` ends the request ``FAILED`` with ``adopt_fault:<kind>``.
- **Tracing** — a tracer records a ``handoff`` span from export (or requeue) to the
  decode lane going live, then binds the decode engine's uid for its decode spans.
"""

from __future__ import annotations

import dataclasses
import inspect
from collections import deque
from typing import Callable, List, Optional, Sequence

from ..ops.collectives import TransferStats, kv_page_transfer
from ..resilience.faults import EngineCrashed
from ..utils.dataclasses import GatewayConfig
from .fleet import DRAINING, RESTARTING, RETIRED, FleetRouter, Replica
from .gateway import CANCELLED, EXPIRED, FAILED, RUNNING, GatewayRequest

__all__ = ["DisaggRouter", "parse_roles"]

#: Roles that can take an admission (run prefill) / adopt a handoff (decode).
PREFILL_CAPABLE = ("prefill", "mixed")
DECODE_CAPABLE = ("decode", "mixed")


def parse_roles(spec) -> List[str]:
    """A role spec → a list of role names: a sequence of names, or the
    ``GatewayConfig.replica_roles`` comma string (``"prefill,decode,decode"``)."""
    roles = ([r.strip() for r in spec.split(",")] if isinstance(spec, str)
             else [str(r) for r in spec])
    bad = [r for r in roles if r not in ("prefill", "decode", "mixed")]
    if bad or not roles:
        raise ValueError(
            f"replica roles {spec!r}: expected prefill/decode/mixed, one per replica")
    return roles


@dataclasses.dataclass
class _PendingHandoff:
    """One exported handoff whose request is not terminal yet: the gateway request,
    the engine's record (which owns refcounted pages on the source pool) and the
    source's identity, which the re-adoption and release guards check (a restarted
    source's pool is gone; releasing against another pool would corrupt refcounts)."""

    greq: GatewayRequest
    handoff: object          # serving.KVHandoff
    src_rid: int
    src_engine: object
    src_mgr: object          # the source BlockManager at export time
    exported_at: float = 0.0  # router clock at export or requeue: the handoff span's t0
    readoptions: int = 0     # decode-replica deaths this handoff survived


def _takes_role(factory) -> bool:
    """Does ``factory`` take ``(rid, role)``: exactly two or more required positional
    parameters? (A factory with a defaulted second parameter keeps its one-argument
    call.)"""
    try:
        required = [p for p in inspect.signature(factory).parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                    and p.default is p.empty]
    except (TypeError, ValueError):
        return False
    return len(required) >= 2


class DisaggRouter(FleetRouter):
    """Role-aware fleet router: prefill replicas feed decode replicas through KV page
    handoffs (see the module docstring).

    ``roles`` (or ``config.replica_roles``) names each replica's role, matching the
    engines' own ``role``; the fleet needs a prefill-capable and a decode-capable
    replica. ``engine_factory`` may take ``(rid)`` or ``(rid, role)``.
    ``config.preempt`` is refused: admissions flow through the handoff pipeline."""

    def __init__(self, engines: Sequence, config: Optional[GatewayConfig] = None,
                 telemetry=None, clock: Optional[Callable[[], float]] = None,
                 tracer=None, engine_factory: Optional[Callable] = None,
                 supervisor=None, roles: Optional[Sequence] = None):
        engines = list(engines)
        if config is None:
            config = GatewayConfig(enabled=True)
        if roles is None:
            if config.replica_roles is None:
                raise ValueError(
                    "DisaggRouter needs replica roles: pass roles=[...] or set "
                    "GatewayConfig.replica_roles")
            roles = config.replica_roles
        self.roles = parse_roles(roles)
        if len(self.roles) != len(engines):
            raise ValueError(f"{len(self.roles)} roles for {len(engines)} engines")
        if not any(r in PREFILL_CAPABLE for r in self.roles):
            raise ValueError("disagg fleet needs a prefill-capable replica")
        if not any(r in DECODE_CAPABLE for r in self.roles):
            raise ValueError("disagg fleet needs a decode-capable replica")
        if config.preempt:
            raise ValueError(
                "preempt=True is a lane-level mechanism; disagg admissions flow through "
                "the handoff pipeline — disable it")
        for i, eng in enumerate(engines):
            if getattr(eng, "role", "mixed") != self.roles[i]:
                raise ValueError(
                    f"replica {i}: engine role {getattr(eng, 'role', None)!r} != declared "
                    f"role {self.roles[i]!r} — build engines with ContinuousBatcher(role=...) "
                    "matching replica_roles")
            if ("prefill" in self.roles and self.roles[i] in DECODE_CAPABLE
                    and not getattr(eng, "paged", False)):
                raise ValueError(
                    f"replica {i} ({self.roles[i]}) is dense (page_size=0) in a fleet with "
                    "prefill replicas: handoff adoption needs the paged KV cache on every "
                    "decode-capable replica")
        if engine_factory is not None and _takes_role(engine_factory):
            user_factory, role_table = engine_factory, self.roles
            engine_factory = lambda rid: user_factory(rid, role_table[rid])  # noqa: E731
        super().__init__(engines, config, telemetry=telemetry, clock=clock, tracer=tracer,
                         engine_factory=engine_factory, supervisor=supervisor)
        self.counters.update({"handoffs": 0, "readopted": 0, "handoff_defers": 0})
        #: Handoffs awaiting adoption, in export order.
        self._handoffs: deque = deque()
        #: gateway uid → live _PendingHandoff (released at the terminal state).
        self._live_handoffs: dict = {}
        #: Bytes and seconds of every kv_page_transfer.
        self.transfer_stats = TransferStats()

    # ------------------------------------------------------------- introspection
    @property
    def running_count(self) -> int:
        """In-flight requests, handoff limbo (exported, not yet adopted) included."""
        return sum(len(rep.running) for rep in self._replicas) + len(self._handoffs)

    def _phase_reps(self, want) -> List[Replica]:
        return [rep for rep in self._replicas if getattr(rep.engine, "role", "mixed") in want]

    # ------------------------------------------------------------------ pricing
    def _admission_cost(self, prompt_len: int, max_new: int) -> int:
        """The decode side's adoption demand (context + budget + the boundary page's
        transient import), with the prefill side's context-only servability checked:
        pricing both phases at prompt + budget would double-count KV."""
        prefill_ref = next((rep.engine for rep in self._phase_reps(PREFILL_CAPABLE)), None)
        decode_ref = next((rep.engine for rep in self._phase_reps(DECODE_CAPABLE)), None)
        cost = 0
        if prefill_ref is not None:
            cost = int(prefill_ref.kv_demand(prompt_len, max_new))
        if decode_ref is not None:
            cost = max(cost, int(decode_ref.kv_demand(prompt_len, max_new)))
        return cost

    # ------------------------------------------------------------------ routing
    def _pick_replica(self, now: float, reps=None) -> Optional[Replica]:
        """Admissions go to prefill-capable replicas only."""
        return super()._pick_replica(
            now, self._phase_reps(PREFILL_CAPABLE) if reps is None else reps)

    def _pick_decode_replica(self, now: float) -> Optional[Replica]:
        return super()._pick_replica(now, self._phase_reps(DECODE_CAPABLE))

    def _admission_gate(self, greq: GatewayRequest, now: float) -> Optional[str]:
        """Serve only while both phases have a replica that is not retired."""
        if all(rep.state == RETIRED for rep in self._phase_reps(PREFILL_CAPABLE)):
            return "fleet_down"
        if all(rep.state == RETIRED for rep in self._phase_reps(DECODE_CAPABLE)):
            return "fleet_down"
        return None

    # ------------------------------------------------------------------ stepping
    def step(self) -> List[GatewayRequest]:
        """The fleet cycle (prefill replicas export during their step), then the
        handoff pass: expire limbo deadline violators, collect fresh exports, adopt
        pending handoffs onto decode-capable replicas."""
        events = super().step()
        extra = self._disagg_pass(self._clock())
        if extra:
            events = sorted(events + extra, key=lambda r: r.uid)
        return events

    def _disagg_pass(self, now: float) -> List[GatewayRequest]:
        events: List[GatewayRequest] = []
        for ph in list(self._handoffs):
            greq = ph.greq
            if greq.deadline_at is not None and now > greq.deadline_at:
                self._handoffs.remove(ph)
                greq.tokens = list(ph.handoff.tokens)
                self.counters["expired"] += 1
                self._finalize(greq, EXPIRED, "deadline_handoff", now)
                events.append(greq)
        self._collect_handoffs(now)
        events.extend(self._pump_handoffs(now))
        return events

    def _collect_handoffs(self, now: float) -> None:
        """Drain every prefill replica's export queue into the router's: the request
        leaves the replica's running set (its lane is already free) for handoff limbo."""
        for rep in self._replicas:
            if getattr(rep.engine, "role", "mixed") != "prefill":
                continue
            if rep.state in (RESTARTING, RETIRED):
                continue
            for h in rep.engine.take_handoffs():
                greq = rep.running.pop(h.uid, None)
                if greq is None or greq.terminal:
                    rep.engine.release_handoff(h)  # nothing owes tokens for it
                    continue
                ph = _PendingHandoff(greq, h, rep.rid, rep.engine, rep.engine.block_mgr,
                                     exported_at=now)
                greq._rid = None
                greq._engine_req = None
                self._handoffs.append(ph)
                self._live_handoffs[greq.uid] = ph

    def _handoff_alive(self, ph: _PendingHandoff) -> bool:
        """May ``ph``'s source pages still be read and released? A crashed, replaced or
        rebuilt source engine invalidates the record."""
        rep = self._replicas[ph.src_rid]
        return (rep.engine is ph.src_engine
                and not getattr(ph.src_engine, "crashed", False)
                and ph.src_engine.block_mgr is ph.src_mgr
                and rep.state not in (RESTARTING, RETIRED))

    def _pump_handoffs(self, now: float) -> List[GatewayRequest]:
        """Adopt pending handoffs onto decode-capable replicas, FIFO: a deferred
        adoption holds the queue, as the engine's own paged admission does."""
        events: List[GatewayRequest] = []
        if self._handoffs and all(rep.state == RETIRED
                                  for rep in self._phase_reps(DECODE_CAPABLE)):
            events.extend(self._flush_handoffs_fleet_down(now))
            return events
        while self._handoffs:
            ph = self._handoffs[0]
            greq = ph.greq
            if greq.terminal:
                self._handoffs.popleft()
                continue
            if not self._handoff_alive(ph):
                # The source died before adoption: re-prefill on a peer.
                self._handoffs.popleft()
                self._drop_handoff_record(greq.uid)
                self._replay_requeue(greq, now, "handoff_src_dead")
                continue
            rep = self._pick_decode_replica(now)
            if rep is None:
                break
            if not rep.engine.can_adopt_handoff(ph.handoff):
                # Pool pressure: defer before paying for the gather and the transfer.
                self.counters["handoff_defers"] += 1
                break
            probe = False
            if rep.breaker.enabled:
                gate = rep.breaker.gate(greq.uid, now)
                assert gate is None, (rep, gate)
                probe = rep.breaker.probe_uid == greq.uid
            block = ph.src_engine.export_page_block(ph.handoff)
            block, nbytes, _dur = kv_page_transfer(
                block, src_replica=ph.src_rid, dst_replica=rep.rid, uid=greq.uid,
                pages=len(ph.handoff.pages), device=rep.engine.device,
                stats=self.transfer_stats, telemetry=self.telemetry)
            try:
                ereq = rep.engine.adopt_handoff(ph.handoff, block,
                                                on_token=self._stream_cb(greq),
                                                replay_tokens=ph.readoptions > 0)
            except EngineCrashed as e:
                if probe:
                    rep.breaker.probe_uid = None
                self._replica_died(rep, f"crash:{e.site}", now)
                continue  # ph stays at the head; the next pick skips the dead replica
            except Exception as e:  # an adoption fault, attributable to this request
                if probe:
                    rep.breaker.probe_uid = None
                self._handoffs.popleft()
                greq.tokens = list(ph.handoff.tokens)
                kind = getattr(e, "kind", type(e).__name__)
                self.counters["failed"] += 1
                self._finalize(greq, FAILED, f"adopt_fault:{kind}", now)
                events.append(greq)
                continue
            if ereq is None:
                # A lane or the pool was taken after all: defer, nothing consumed.
                if probe:
                    rep.breaker.probe_uid = None
                break
            self._handoffs.popleft()
            greq._rid = rep.rid
            greq._engine_req = ereq
            rep.running[ereq.uid] = greq
            self.counters["handoffs"] += 1
            tr = self.tracer
            if tr is not None and greq._trace is not None:
                # From export (the adoption-queue wait is handoff time) until the
                # decode lane is live.
                tr.span(greq._trace, "handoff", ph.exported_at, self._clock(),
                        src_replica=ph.src_rid, dst_replica=rep.rid,
                        pages=len(ph.handoff.pages), nbytes=nbytes)
                tr.bind_engine(greq._trace, ereq.uid)
            self._emit_route(greq.uid, rep, "probe" if probe else "handoff", now)
        return events

    # ------------------------------------------------------------------ failover
    def _migrate(self, rep: Replica, cause: str, now: float,
                 engine_alive: bool) -> List[GatewayRequest]:
        """A request whose handoff record is alive on another replica RE-ADOPTS from
        the source pages (a decode-replica death repeats no prefill); anything else
        replays from the queue."""
        migrated = []
        for greq in list(rep.running.values()):
            if engine_alive:
                rep.engine.cancel(greq._engine_req.uid)
            ph = self._live_handoffs.get(greq.uid)
            if ph is not None and ph.src_rid != rep.rid and self._handoff_alive(ph):
                self._readopt_requeue(greq, ph, now, cause)
            else:
                if ph is not None:
                    self._drop_handoff_record(greq.uid)
                self._replay_requeue(greq, now, cause)
            self.counters["migrated"] += 1
            self._emit_route(greq.uid, rep, "migrate", now)
            migrated.append(greq)
        rep.running.clear()
        return migrated

    def _readopt_requeue(self, greq: GatewayRequest, ph: _PendingHandoff, now: float,
                         cause: str) -> None:
        """Reset one request for re-adoption: the stream resets (``on_retry``), the
        handoff re-enters the adoption queue, and the next decode replica delivers the
        handoff's tokens again, then generates the rest."""
        greq.replays += 1
        self.counters["replayed"] += 1
        self.counters["readopted"] += 1
        greq.status = RUNNING  # mid-service: in the adoption queue, not the policy's
        greq.tokens = []
        greq._engine_req = None
        greq._rid = None
        greq.t_first_token = greq.t_last_token = None
        greq.n_streamed = 0
        if greq.on_retry is not None:
            greq.on_retry()
        if self.tracer is not None and greq._trace is not None:
            greq._trace.attempt = greq.retries_used + greq.replays
            self.tracer.event(greq._trace, "retry", t=now, attempt=greq._trace.attempt,
                              cause=cause)
        ph.readoptions += 1
        ph.exported_at = now  # the re-adoption's span times the new wait alone
        self._handoffs.append(ph)

    def _replica_died(self, rep: Replica, reason: str, now: float) -> None:
        super()._replica_died(rep, reason, now)
        # Handoffs pending adoption whose source died here: re-prefill on a peer.
        survivors: deque = deque()
        for ph in self._handoffs:
            if ph.src_rid == rep.rid and not self._handoff_alive(ph):
                if not ph.greq.terminal:
                    self._drop_handoff_record(ph.greq.uid)
                    self._replay_requeue(ph.greq, now, f"handoff_src_dead:{reason}")
            else:
                survivors.append(ph)
        self._handoffs = survivors

    def _flush_handoffs_fleet_down(self, now: float) -> List[GatewayRequest]:
        """Fail every limbo handoff with ``fleet_down``."""
        failed: List[GatewayRequest] = []
        while self._handoffs:
            ph = self._handoffs.popleft()
            if ph.greq.terminal:
                continue
            ph.greq.tokens = list(ph.handoff.tokens)
            self.counters["failed"] += 1
            self._finalize(ph.greq, FAILED, "fleet_down", now)
            failed.append(ph.greq)
        return failed

    def _retire(self, rep: Replica, now: float) -> None:
        super()._retire(rep, now)
        if all(r.state == RETIRED for r in self._replicas):
            self._pending_events.extend(self._flush_handoffs_fleet_down(now))

    def spawn_replica(self, role: Optional[str] = None) -> Replica:
        """Role-aware scale-up: grow the role table first (the wrapped ``(rid, role)``
        factory reads it by reference), then build the replica through the base
        actuator; a replica of the wrong role, or a dense decode-capable one in a fleet
        with prefill replicas, is unregistered and refused."""
        if role is None:
            raise ValueError("DisaggRouter.spawn_replica needs a role "
                             "(prefill/decode/mixed) — a disagg fleet grows BY role")
        role = parse_roles([role])[0]
        self.roles.append(role)
        try:
            rep = super().spawn_replica()
        except Exception:
            self.roles.pop()
            raise
        eng = rep.engine
        problem = None
        if getattr(eng, "role", "mixed") != role:
            problem = (f"engine role {getattr(eng, 'role', None)!r} != requested role "
                       f"{role!r} — the factory must consult the router's role table")
        elif (role in DECODE_CAPABLE and any(r == "prefill" for r in self.roles)
                and not getattr(eng, "paged", False)):
            problem = (f"spawned {role} replica is dense (page_size=0) in a fleet with "
                       "prefill replicas: handoff adoption needs the paged KV cache")
        if problem is not None:
            self._replicas.pop()
            self.roles.pop()
            self.counters["replica_spawned"] -= 1
            raise ValueError(f"replica {rep.rid}: {problem}")
        return rep

    def _restart(self, rep: Replica, now: float) -> None:
        """A draining prefill replica waits for its exported handoffs to reach terminal
        states (their pages live in its pool); past the drain deadline it restarts
        anyway and those handoffs re-prefill on first touch."""
        if (rep.state == DRAINING and getattr(rep.engine, "role", "mixed") == "prefill"
                and (rep.drain_deadline is None or now <= rep.drain_deadline)
                and any(ph.src_rid == rep.rid and not ph.greq.terminal
                        for ph in self._live_handoffs.values())):
            return
        super()._restart(rep, now)

    # ------------------------------------------------------------------- control
    def cancel(self, uid: int) -> bool:
        greq = self._all.get(uid)
        if (greq is not None and not greq.terminal and greq.status == RUNNING
                and greq._rid is None and uid in self._live_handoffs):
            # Handoff limbo: withdrawn before any decode replica adopted it.
            ph = self._live_handoffs[uid]
            self._handoffs = deque(p for p in self._handoffs if p.greq is not greq)
            greq.tokens = list(ph.handoff.tokens)
            self.counters["cancelled"] += 1
            self._finalize(greq, CANCELLED, "cancelled_handoff", self._clock())
            return True
        return super().cancel(uid)

    # ---------------------------------------------------------------- lifecycle
    def _drop_handoff_record(self, uid: int) -> None:
        """Forget a handoff whose source pool is gone (nothing to release)."""
        self._live_handoffs.pop(uid, None)

    def _finalize(self, greq: GatewayRequest, status: str, reason: Optional[str],
                  now: float) -> None:
        ph = self._live_handoffs.pop(greq.uid, None)
        if ph is not None and self._handoff_alive(ph):
            # The terminal state returns the lent pages to the source pool.
            ph.src_engine.release_handoff(ph.handoff)
        super()._finalize(greq, status, reason, now)

    # ------------------------------------------------------------------ reporting
    def stats(self) -> dict:
        out = super().stats()
        out["roles"] = list(self.roles)
        out["handoffs_pending"] = len(self._handoffs)
        out["handoffs_live"] = len(self._live_handoffs)
        out["handoff_transfer"] = self.transfer_stats.summary()
        return out

    def __repr__(self) -> str:
        states = ",".join(f"{r.rid}:{self.roles[r.rid][0]}:{r.state}" for r in self._replicas)
        return (f"DisaggRouter(policy={self._policy.name!r}, replicas=[{states}], "
                f"queued={len(self._policy)}, running={self.running_count}, "
                f"handoffs_pending={len(self._handoffs)})")
