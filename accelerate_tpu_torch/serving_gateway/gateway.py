"""The SLO-aware request gateway: admission, scheduling, lifecycle, streaming — the
port's counterpart of ``accelerate_tpu/serving_gateway/gateway.py``.

``ServingGateway`` wraps, never replaces, one ``serving.ContinuousBatcher``:

- **Admission control** — a bounded queue (``max_queue``) and a token budget
  (``max_queued_tokens``) priced by the engine's own ``kv_demand``; past a bound the
  newcomer is REJECTED with a machine-readable reason, or (``overload="shed"``) less
  urgent queued requests are shed for it, atomically.
- **Scheduling** — one ``SchedulerPolicy`` (fifo / priority with aging / EDF / WFQ)
  orders admission into free lanes; the gateway hands the engine only as many
  requests as it has free lanes, so the engine's FIFO never reorders a decision.
- **Lifecycle** — deadlines (queued requests expire, running ones are evicted and
  their lane refills the same step), ``cancel(uid)``, priority preemption with a
  bounded retry budget (the victim replays from scratch: ``on_retry`` resets the
  stream, then ``on_token`` delivers from the first token), a circuit breaker over
  the engine's step failures with degradation rungs (speculation off through
  ``set_spec_enabled``, then halved bounds).
- **SLO observability** — per-request queue wait, TTFT and TPOT and their p50/p95/p99
  summaries; records go to any ``telemetry`` with ``enabled`` and ``emit(record)``.
- **Tracing** — a ``telemetry.Tracer`` (``tracer=``) opens a trace at submit and emits
  the scheduling-side spans (queue, shed, preempt, retry, first token, terminal); the
  engine, handed the same tracer, emits admit, prefill, decode and fault spans. An
  enabled tracer takes the gateway's clock, so both sides share one timeline.
- **Faults** — a request the engine's fault boundary quarantined ends ``FAILED`` with
  the engine's reason (``step_fault:<kind>``, ``prefill_fault:<kind>``, ...).

The gateway runs nothing on the device: every kernel launch happens inside the
engine. Sampled requests take an integer ``seed`` (the engine's), where the JAX
gateway takes an ``rng`` key. The live metrics plane (``GatewayConfig.metrics``) and
the flight recorder's state hook are not ported yet: an enabled metrics plane or an
enabled recorder raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from ..generation import GenerationConfig
from ..paged_kv import KVBudgetError
from ..serving import normalize_submit
from ..telemetry.clocks import resolve_clock
from ..telemetry.schemas import GATEWAY_REQUEST_SCHEMA, GATEWAY_SLO_SCHEMA, RECOVERY_SCHEMA
from ..telemetry.slo import slo_summary
from ..utils.dataclasses import GatewayConfig
from .policies import make_policy

__all__ = [
    "CircuitBreaker", "GatewayRequest", "ServingGateway", "QUEUED", "RUNNING", "DONE",
    "REJECTED", "SHED", "CANCELLED", "EVICTED", "EXPIRED", "FAILED", "TERMINAL_STATUSES",
]

# ---------------------------------------------------------------- status model
QUEUED = "queued"        # held by the scheduler policy
RUNNING = "running"      # admitted into an engine lane (or in handoff limbo)
DONE = "done"            # finished normally (EOS / max_new_tokens)
REJECTED = "rejected"    # refused at admission (queue_full/token_budget/kv_budget/
#                          unservable/circuit_open/circuit_probe/fleet_down)
SHED = "shed"            # removed from the queue by overload shedding
CANCELLED = "cancelled"  # withdrawn by cancel(uid) (reason: queued/running/handoff)
EVICTED = "evicted"      # lost its lane (preemption) with no retry budget left
EXPIRED = "expired"      # deadline passed (reason: queued/running/handoff)
FAILED = "failed"        # quarantined (step_fault:<kind>, prefill_fault:<kind>,
#                          adopt_fault:<kind>, fleet_down, ...)

TERMINAL_STATUSES = frozenset({DONE, REJECTED, SHED, CANCELLED, EVICTED, EXPIRED, FAILED})

_UNSET = object()  # submit() sentinel: "apply the config default"


@dataclasses.dataclass
class GatewayRequest:
    """One request's gateway lifecycle: scheduling inputs, state, SLO times.

    ``status`` walks queued → running → one of :data:`TERMINAL_STATUSES`; a request
    refused at admission is born terminal (``rejected``/``shed`` with a reason) rather
    than raising. ``ttft_s`` includes queue wait and prefill; ``tpot_s`` is the mean
    gap between tokens after the first."""

    uid: int
    prompt: np.ndarray
    gen: GenerationConfig
    seed: Optional[int] = None
    priority: int = 0
    deadline_at: Optional[float] = None   # absolute, on the gateway clock
    tenant: str = "default"
    on_token: Optional[Callable[[int], None]] = None
    on_retry: Optional[Callable[[], None]] = None  # stream reset before a replay
    max_retries: int = 0
    cost: int = 0                         # cache tokens the engine prices it at
    # lifecycle
    status: str = QUEUED
    reason: Optional[str] = None
    tokens: list = dataclasses.field(default_factory=list)
    retries_used: int = 0
    replays: int = 0                      # replays after a replica death or restart
    recoveries: int = 0                   # the engine's recovery re-admissions
    # SLO timestamps (gateway clock)
    t_submit: float = 0.0
    t_enqueued: float = 0.0               # this attempt's queue entry
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_done: Optional[float] = None
    n_streamed: int = 0
    _engine_req: Optional[object] = dataclasses.field(default=None, repr=False)
    _trace: Optional[object] = dataclasses.field(default=None, repr=False)
    #: Replica id serving this request (fleet routing only; None while queued, in
    #: handoff limbo, and on a single-engine gateway).
    _rid: Optional[int] = dataclasses.field(default=None, repr=False)

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.t_admit is None else self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first_token is None else self.t_first_token - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_last_token is None or self.n_streamed < 2:
            return None
        return (self.t_last_token - self.t_first_token) / (self.n_streamed - 1)

    @property
    def deadline_met(self) -> Optional[bool]:
        if self.deadline_at is None or self.t_done is None:
            return None
        return self.status == DONE and self.t_done <= self.deadline_at

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES


class CircuitBreaker:
    """The closed → open → half-open failure-isolation state machine, one
    implementation for the single-engine gateway (OPEN gates the front door) and each
    fleet replica (OPEN isolates the replica). Pure state over an injected notion of
    time: the owner feeds failure deltas and admission attempts and acts on the
    verdicts."""

    def __init__(self, threshold: int, window_s: float, cooldown_s: float):
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"
        #: The one request admitted while half-open; its fate decides the next state.
        self.probe_uid: Optional[int] = None
        self.openings = 0
        self.closings = 0
        self._fail_times: List[float] = []
        self._opened_at = 0.0

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def gate(self, uid: int, now: float) -> Optional[str]:
        """None admits request ``uid`` (making it the probe when half-open with none
        outstanding); else the refusal reason: ``circuit_open`` while the cooldown
        runs, ``circuit_probe`` while another request is the outstanding probe."""
        if not self.enabled or self.state == "closed":
            return None
        if self.state == "open":
            if now - self._opened_at >= self.cooldown_s:
                self.state = "half_open"
                self.probe_uid = None
            else:
                return "circuit_open"
        if self.probe_uid is None:
            self.probe_uid = uid
            return None
        return "circuit_probe"

    def record_failures(self, delta: int, now: float) -> bool:
        """Feed the failure delta since the last read → True when it crossed the open
        threshold (>= ``threshold`` failures in ``window_s`` while closed, or any
        failure while half-open); the caller then calls :meth:`open`."""
        if not self.enabled or delta <= 0:
            return False
        self._fail_times.extend([now] * delta)
        self._fail_times = [t for t in self._fail_times if now - t <= self.window_s]
        if self.state == "half_open":
            return True
        return self.state == "closed" and len(self._fail_times) >= self.threshold

    def open(self, now: float) -> None:
        self.state = "open"
        self._opened_at = now
        self.probe_uid = None
        self.openings += 1

    def close(self, now: float) -> None:
        self.state = "closed"
        self._fail_times = []
        self.probe_uid = None
        self.closings += 1

    def force_half_open(self) -> None:
        """Jump to half-open with a clean slate: a restarted or spawned replica earns
        full routing by completing one probe request."""
        self.state = "half_open"
        self.probe_uid = None
        self._fail_times = []

    def __repr__(self) -> str:
        return (f"CircuitBreaker(state={self.state!r}, openings={self.openings}, "
                f"closings={self.closings})")


class ServingGateway:
    """Admission + scheduling + lifecycle tier above one ``ContinuousBatcher``.

    ``clock`` defaults to the wall clock (``telemetry.clocks``); tests inject a manual
    clock to make deadlines and aging deterministic."""

    def __init__(self, engine, config: Optional[GatewayConfig] = None, telemetry=None,
                 clock: Optional[Callable[[], float]] = None, tracer=None):
        if config is None:
            config = GatewayConfig(enabled=True)
        if config.metrics and getattr(telemetry, "enabled", False):
            raise NotImplementedError(
                "GatewayConfig.metrics is not ported yet: the live metrics plane waits "
                "for the telemetry slice; pass metrics=False")
        recorder = getattr(telemetry, "recorder", None)
        if config.capsule_state and getattr(recorder, "enabled", False):
            raise NotImplementedError(
                "the flight recorder's gateway state hook is not ported yet (telemetry "
                "slice); pass capsule_state=False or a telemetry without a recorder")
        self.engine = engine
        self.config = config
        # The engine owns the super-step depth; the gateway only checks the pairing.
        if config.decode_steps > 1 and getattr(engine, "multi_step", 1) != config.decode_steps:
            raise ValueError(
                f"GatewayConfig.decode_steps={config.decode_steps} but the engine runs "
                f"decode_steps={getattr(engine, 'multi_step', 1)}: construct the "
                "ContinuousBatcher with the same decode_steps (the engine owns the knob; "
                "the gateway only validates it)")
        self.telemetry = telemetry
        self._clock = resolve_clock(clock)
        # Request-scoped tracing: the gateway opens the trace at submit and emits the
        # scheduling-side spans; the engine, handed the same tracer, the execution-side
        # ones. An enabled tracer takes the gateway's clock (one timeline for deadlines,
        # ttft_s and every span); a disabled one never reads its clock.
        self.tracer = tracer
        if tracer is not None:
            if getattr(engine, "tracer", None) is None:
                engine.tracer = tracer
            if tracer.enabled:
                tracer._clock = self._clock
        self._policy = make_policy(config)
        self._uid = 0
        self._queued_cost = 0
        self._running: Dict[int, GatewayRequest] = {}  # engine uid → gateway request
        self._all: Dict[int, GatewayRequest] = {}      # gateway uid → request
        self._terminal: List[GatewayRequest] = []      # terminal order (SLO summaries)
        self.counters = {
            "submitted": 0, "admitted": 0, "done": 0, "rejected": 0, "shed": 0,
            "cancelled": 0, "expired": 0, "evicted": 0, "retried": 0, "failed": 0,
            "replayed": 0,
        }
        # The breaker reads the engine's step_failures counter as a delta after each
        # step.
        self._breaker = CircuitBreaker(config.breaker_threshold, config.breaker_window_s,
                                       config.breaker_cooldown_s)
        self._engine_failures_seen = getattr(engine, "step_failures", 0)
        # Degradation rungs: each breaker opening escalates (1: speculation off; 2:
        # admission bounds halved); a close restores the full configuration.
        self.degrade_level = 0
        self._admission_scale = 1.0

    # ------------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None, gen: Optional[GenerationConfig] = None,
               seed: Optional[int] = None, priority: Optional[int] = None,
               deadline_s=_UNSET, tenant: str = "default",
               on_token: Optional[Callable[[int], None]] = None,
               on_retry: Optional[Callable[[], None]] = None,
               max_retries: Optional[int] = None) -> GatewayRequest:
        """Queue a request under the gateway's policy; always returns a
        ``GatewayRequest``: refusals come back terminal ``rejected`` with a reason,
        never as an exception. API misuse raises the engine's exceptions (one shared
        ``serving.normalize_submit``).

        ``deadline_s`` is relative to now (None disables even the config default);
        ``priority``: higher = more urgent; ``tenant`` feeds WFQ; ``max_retries``
        bounds retry on preemption; ``on_retry`` fires when a replay restarts the
        stream, before ``on_token`` delivers again from the first token."""
        now = self._clock()
        prompt, gen = normalize_submit(prompt, max_new_tokens, eos_token_id, gen, seed)
        if deadline_s is _UNSET:
            deadline_s = self.config.deadline_s
        greq = GatewayRequest(
            uid=self._uid, prompt=prompt, gen=gen, seed=seed,
            priority=self.config.default_priority if priority is None else priority,
            deadline_at=None if deadline_s is None else now + float(deadline_s),
            tenant=tenant, on_token=on_token, on_retry=on_retry,
            max_retries=self.config.max_retries if max_retries is None else max_retries,
            t_submit=now, t_enqueued=now,
        )
        self._uid += 1
        self._all[greq.uid] = greq
        self.counters["submitted"] += 1
        if self.tracer is not None:
            # The trace opens here: queue wait is client-visible latency.
            greq._trace = self.tracer.start(greq.uid, tenant=tenant, t=now)
        gate_reason = self._admission_gate(greq, now)
        if gate_reason is not None:
            return self._refuse(greq, now, gate_reason)
        try:
            greq.cost = self._admission_cost(len(prompt), gen.max_new_tokens)
        except KVBudgetError as e:
            return self._refuse(greq, now, "kv_budget", str(e))
        except ValueError as e:
            return self._refuse(greq, now, "unservable", str(e))
        if not self._make_room(greq, now):
            return greq  # _make_room already marked it rejected
        self._policy.push(greq)
        self._queued_cost += greq.cost
        return greq

    def _admission_cost(self, prompt_len: int, max_new: int) -> int:
        """Cache tokens one request charges the queue budget: the engine's own KV
        pricing (``kv_demand``). Raises ``KVBudgetError``/``ValueError`` for a request
        that could never be served. The disaggregated router prices by the decode
        side's adoption demand instead."""
        return int(self.engine.kv_demand(prompt_len, max_new))

    def _refuse(self, greq: GatewayRequest, now: float, reason: str,
                detail: Optional[str] = None) -> GatewayRequest:
        self.counters["rejected"] += 1
        self._finalize(greq, REJECTED, reason if detail is None else f"{reason}:{detail}", now)
        return greq

    def _effective_bounds(self) -> tuple:
        """(max_queue, max_queued_tokens) after the degradation scale."""
        mq, mt = self.config.max_queue, self.config.max_queued_tokens
        if self._admission_scale != 1.0:
            mq = max(1, int(mq * self._admission_scale)) if mq else 0
            mt = max(1, int(mt * self._admission_scale)) if mt else 0
        return mq, mt

    def _over_budget(self, incoming_cost: int) -> Optional[str]:
        max_queue, max_tokens = self._effective_bounds()
        if max_queue and len(self._policy) + 1 > max_queue:
            return "queue_full"
        if max_tokens and self._queued_cost + incoming_cost > max_tokens:
            return "token_budget"
        return None

    def _make_room(self, greq: GatewayRequest, now: float) -> bool:
        """Enforce the admission bounds for one incoming request → True when it may
        queue, False after marking it rejected. ``overload="shed"`` sheds strictly
        less urgent queued requests (least urgent first), atomically: the victims are
        planned first and shed only if that makes room."""
        reason = self._over_budget(greq.cost)
        if reason is None:
            return True
        max_queue, max_tokens = self._effective_bounds()
        if self.config.overload != "shed" or (max_tokens and greq.cost > max_tokens):
            self._refuse(greq, now, reason)
            return False
        new_urgency = self._policy.urgency(greq, now)
        pool = sorted((i for i in self._policy.items()
                       if self._policy.urgency(i, now) < new_urgency),
                      key=lambda i: (self._policy.urgency(i, now), -i.uid))
        victims = []
        qlen, qcost = len(self._policy), self._queued_cost

        def fits():
            return (not max_queue or qlen + 1 <= max_queue,
                    not max_tokens or qcost + greq.cost <= max_tokens)

        for victim in pool:
            len_ok, tok_ok = fits()
            if len_ok and tok_ok:
                break
            victims.append(victim)
            qlen -= 1
            qcost -= victim.cost
        len_ok, tok_ok = fits()
        if not (len_ok and tok_ok):
            self._refuse(greq, now, "queue_full" if not len_ok else "token_budget")
            return False
        for victim in victims:
            self._policy.remove(victim.uid)
            self._queued_cost -= victim.cost
            self.counters["shed"] += 1
            if self.tracer is not None:
                self.tracer.event(victim._trace, "shed", t=now, shed_for=greq.uid)
            self._finalize(victim, SHED, "overload_shed", now)
        return True

    # ------------------------------------------------------------------ control
    def cancel(self, uid: int) -> bool:
        """Withdraw request ``uid``: a queued one never reaches a lane, a running one's
        lane frees now. False for unknown or terminal uids."""
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
        self.engine.cancel(greq._engine_req.uid)
        self._running.pop(greq._engine_req.uid, None)
        greq.tokens = list(greq._engine_req.tokens)
        self.counters["cancelled"] += 1
        self._finalize(greq, CANCELLED, "cancelled_running", now)
        return True

    # ------------------------------------------------------------------ stepping
    def step(self) -> List[GatewayRequest]:
        """One gateway cycle: expire and evict deadline violators, preempt, admit into
        free lanes, advance the engine one step → every request that reached a
        terminal state in this call (submission order)."""
        now = self._clock()
        events: List[GatewayRequest] = []
        # 1) queued deadline expiry — never occupies a lane.
        for item in self._policy.items():
            if item.deadline_at is not None and now > item.deadline_at:
                self._policy.remove(item.uid)
                self._queued_cost -= item.cost
                self.counters["expired"] += 1
                self._finalize(item, EXPIRED, "deadline_queued", now)
                events.append(item)
        # 2) running deadline eviction — the lane frees for this step's admission. With
        #    decode_steps = N the check runs once a super-step (up to N-1 tokens late).
        for greq in list(self._running.values()):
            if greq.deadline_at is not None and now > greq.deadline_at:
                self.engine.cancel(greq._engine_req.uid)
                self._running.pop(greq._engine_req.uid, None)
                greq.tokens = list(greq._engine_req.tokens)
                self.counters["expired"] += 1
                self._finalize(greq, EXPIRED, "deadline_running", now)
                events.append(greq)
        # 3) priority preemption (opt-in).
        if self.config.preempt:
            events.extend(self._preempt(now))
        # 4) admit as many requests as there are free lanes, in policy order.
        free = self._free_lanes()
        while free > 0 and len(self._policy):
            item = self._policy.pop(now)
            self._queued_cost -= item.cost
            self._admit(item, now)
            free -= 1
        # 5) one engine step; map its completions back to gateway state. A request the
        #    engine's fault boundary quarantined ends FAILED with its reason (retrying
        #    a poison request would poison the batch again).
        for ereq in self.engine.step():
            greq = self._running.pop(ereq.uid, None)
            if greq is None:
                continue  # submitted to the engine directly, not through the gateway
            self._complete(greq, ereq, events)
        # 6) circuit breaker: this step's engine failure delta.
        if self.config.breaker_threshold:
            self._breaker_observe(now)
        return sorted(events, key=lambda r: r.uid)

    def _complete(self, greq: GatewayRequest, ereq, events: list,
                  t_done: Optional[float] = None) -> None:
        """Map one finished engine request onto its gateway request: DONE, or FAILED
        with the reason the engine's fault boundary gave it."""
        greq.tokens = list(ereq.tokens)
        greq.recoveries = getattr(ereq, "recoveries", 0)
        if t_done is None:
            t_done = self._clock()
        failed_reason = getattr(ereq, "failed", None)
        if failed_reason is not None:
            self.counters["failed"] += 1
            self._finalize(greq, FAILED, failed_reason, t_done)
        else:
            self.counters["done"] += 1
            self._finalize(greq, DONE, None, t_done)
        events.append(greq)

    # ------------------------------------------------------------ circuit breaker
    def _admission_gate(self, greq: GatewayRequest, now: float) -> Optional[str]:
        """Pre-queue health gate: a refusal reason, or None to queue. The fleet router
        replaces it with replica routability."""
        return self._breaker.gate(greq.uid, now)

    @property
    def _breaker_state(self) -> str:
        return self._breaker.state

    @property
    def breaker_openings(self) -> int:
        return self._breaker.openings

    @property
    def breaker_closings(self) -> int:
        return self._breaker.closings

    def _breaker_observe(self, now: float) -> None:
        failures = getattr(self.engine, "step_failures", 0)
        delta = failures - self._engine_failures_seen
        self._engine_failures_seen = failures
        if self._breaker.record_failures(delta, now):
            self._breaker_open(now)

    def _breaker_open(self, now: float) -> None:
        self._breaker.open(now)
        self._escalate()
        self._emit_breaker_record("circuit_open", now)

    def _breaker_close(self, now: float) -> None:
        self._breaker.close(now)
        while self.degrade_level:  # a proven-healthy probe restores everything
            self._deescalate()
        self._emit_breaker_record("circuit_close", now)

    def _emit_breaker_record(self, action: str, now: float) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        tel.emit({"schema": RECOVERY_SCHEMA, "action": action, "t": now,
                  "openings": self.breaker_openings, "closings": self.breaker_closings,
                  "degrade_level": self.degrade_level})

    # ------------------------------------------------------- graceful degradation
    def _escalate(self) -> None:
        """One rung down: speculative decoding off first, admission bounds halved
        second."""
        if not self.config.degrade or self.degrade_level >= 2:
            return
        self.degrade_level += 1
        if self.degrade_level == 1:
            if getattr(self.engine, "spec_k", 0):
                self.engine.set_spec_enabled(False)
        else:
            self._admission_scale = 0.5

    def _deescalate(self) -> None:
        """One rung back up, in the escalation's reverse order."""
        if not self.config.degrade or self.degrade_level == 0:
            return
        if self.degrade_level == 2:
            self._admission_scale = 1.0
        elif getattr(self.engine, "spec_k", 0):
            self.engine.set_spec_enabled(True)
        self.degrade_level -= 1

    # ------------------------------------------------------------- request replay
    def reattach_engine(self, engine=None, reason: str = "engine_restart") -> list:
        """Recover from an engine death or restart: optionally swap in the fresh
        engine, then requeue every in-flight request for replay (``on_retry`` fires;
        the transcript ends equal to an undisturbed run's). Replays do not spend the
        preemption retry budget. Returns the replayed requests."""
        now = self._clock()
        if engine is not None:
            if self.tracer is not None and getattr(engine, "tracer", None) is None:
                engine.tracer = self.tracer
            self.engine = engine
            self._engine_failures_seen = getattr(engine, "step_failures", 0)
        replayed = []
        for greq in list(self._running.values()):
            self._replay_requeue(greq, now, reason)
            replayed.append(greq)
        self._running.clear()
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit({"schema": RECOVERY_SCHEMA, "action": "replay", "t": now,
                      "reason": reason, "replayed": len(replayed)})
        return replayed

    def _replay_requeue(self, greq: GatewayRequest, now: float, cause: str) -> None:
        """Reset one in-flight request and requeue it under the policy: ``on_retry``
        fires, and ``on_token`` then delivers again from the first token. Shared by
        ``reattach_engine`` and the fleet router's failover and drain migration."""
        greq.replays += 1
        self.counters["replayed"] += 1
        greq.status = QUEUED
        greq.tokens = []
        greq._engine_req = None
        greq._rid = None
        greq.t_admit = greq.t_first_token = greq.t_last_token = None
        greq.t_enqueued = now
        greq.n_streamed = 0
        if greq.on_retry is not None:
            greq.on_retry()
        if self.tracer is not None and greq._trace is not None:
            greq._trace.attempt = greq.retries_used + greq.replays
            self.tracer.event(greq._trace, "retry", t=now, attempt=greq._trace.attempt,
                              cause=cause)
        self._policy.push(greq)
        self._queued_cost += greq.cost

    def _free_lanes(self) -> int:
        """Lanes the engine can fill this step: open lanes minus requests already in
        the engine's own queue."""
        return (self.engine.max_slots - sum(r is not None for r in self.engine.slot_req)
                - len(self.engine.queue))

    @property
    def queue_depth(self) -> int:
        return len(self._policy)

    @property
    def running_count(self) -> int:
        return len(self._running)

    def run(self, report_slo: bool = False):
        """Drain the queue and every lane → the requests that reached a terminal state
        (and, with ``report_slo``, the aggregate ``gateway.slo/v1`` record)."""
        out: List[GatewayRequest] = []
        while self.queue_depth or self.running_count:
            out.extend(self.step())
        if report_slo:
            return out, self.emit_slo_record()
        return out

    def _admit(self, greq: GatewayRequest, now: float) -> None:
        greq.status = RUNNING
        greq.t_admit = now
        self.counters["admitted"] += 1
        ereq = self.engine.submit(
            greq.prompt, gen=greq.gen,
            seed=greq.seed if greq.gen.temperature > 0.0 else None,
            on_token=self._stream_cb(greq))
        greq._engine_req = ereq
        self._running[ereq.uid] = greq
        self._trace_admitted(greq, ereq, now)

    def _trace_admitted(self, greq: GatewayRequest, ereq, now: float) -> None:
        """Close this attempt's queue span (from ``t_enqueued``: a retry's span measures
        the requeue wait alone) and bind the engine uid, so the engine's spans land in
        this trace."""
        tr = self.tracer
        if tr is not None:
            tr.span(greq._trace, "queue", greq.t_enqueued, now,
                    attempt=greq.retries_used + greq.replays, outcome="admitted")
            tr.bind_engine(greq._trace, ereq.uid)

    def _stream_cb(self, greq: GatewayRequest) -> Callable[[int], None]:
        def deliver(tok: int) -> None:
            t = self._clock()
            if greq.t_first_token is None:
                greq.t_first_token = t
                if self.tracer is not None:
                    # The clock read ttft_s derives from: trace-reconstructed TTFT
                    # equals the gateway's to the digit.
                    self.tracer.event(greq._trace, "first_token", t=t)
            greq.t_last_token = t
            greq.n_streamed += 1
            if greq.on_token is not None:
                greq.on_token(tok)

        return deliver

    def _preempt(self, now: float) -> List[GatewayRequest]:
        """Evict the least urgent running request while a strictly higher-priority one
        is queued and no lane is free, and admit the preemptor into the freed lane
        directly. Raw ``priority`` is the currency under every policy."""
        events: List[GatewayRequest] = []
        while len(self._policy) and self._running:
            if self._free_lanes() > 0:
                break
            top = max(self._policy.items(), key=lambda i: (i.priority, -i.uid))
            victim = min(self._running.values(), key=lambda r: (r.priority, -r.uid))
            if victim.priority >= top.priority:
                break
            self.engine.cancel(victim._engine_req.uid)
            self._running.pop(victim._engine_req.uid, None)
            if self.tracer is not None:
                self.tracer.event(victim._trace, "preempt", t=now, preempted_by=top.uid,
                                  tokens_lost=len(victim._engine_req.tokens))
            # take(), not remove(): the preemptor is served (WFQ charges its tenant).
            self._policy.take(top.uid, now)
            self._queued_cost -= top.cost
            self._admit(top, now)
            evicted = self._preempt_victim_requeue(victim, now)
            if evicted is not None:
                events.append(evicted)
        return events

    def _preempt_victim_requeue(self, victim: GatewayRequest,
                                now: float) -> Optional[GatewayRequest]:
        """A preempted victim retries (requeued, stream reset) while its budget lasts,
        else is terminally evicted → the victim when evicted, None when requeued."""
        if victim.retries_used < victim.max_retries:
            victim.retries_used += 1
            self.counters["retried"] += 1
            victim.status = QUEUED
            victim.tokens = []
            victim._engine_req = None
            victim._rid = None
            victim.t_admit = victim.t_first_token = victim.t_last_token = None
            victim.t_enqueued = now
            victim.n_streamed = 0
            if victim.on_retry is not None:
                victim.on_retry()
            if self.tracer is not None and victim._trace is not None:
                victim._trace.attempt = victim.retries_used
                self.tracer.event(victim._trace, "retry", t=now,
                                  attempt=victim.retries_used)
            self._policy.push(victim)
            self._queued_cost += victim.cost
            return None
        if victim._engine_req is not None:
            victim.tokens = list(victim._engine_req.tokens)
        self.counters["evicted"] += 1
        self._finalize(victim, EVICTED, "preempted", now)
        return victim

    def _probe_verdict(self, greq: GatewayRequest, status: str, now: float) -> None:
        """A half-open breaker's fate when the finished request was its probe."""
        if self._breaker.probe_uid is None or greq.uid != self._breaker.probe_uid:
            return
        if status == DONE:
            self._breaker_close(now)
        elif status == FAILED:
            self._breaker_open(now)
        else:
            self._breaker.probe_uid = None  # the probe never ran: probe again

    # ------------------------------------------------------------------ reporting
    def _finalize(self, greq: GatewayRequest, status: str, reason: Optional[str],
                  now: float) -> None:
        greq.status = status
        greq.reason = reason
        greq.t_done = now
        greq._engine_req = None
        self._probe_verdict(greq, status, now)
        tr = self.tracer
        if tr is not None and greq._trace is not None:
            if status in (FAILED, EXPIRED, SHED) or (
                    status == DONE and greq.deadline_met is False):
                # Tail promotion of a request that ended badly, before its closing
                # spans, so the promoted stream stays chronological.
                tr.promote(greq._trace)
            if greq.t_admit is None:
                # Still queued at its end: close this attempt's queue span.
                tr.span(greq._trace, "queue", greq.t_enqueued, now,
                        attempt=greq.retries_used + greq.replays, outcome=status)
            tr.event(greq._trace, "terminal", t=now, status=status, reason=reason,
                     n_tokens=len(greq.tokens), retries_used=greq.retries_used,
                     queue_wait_s=greq.queue_wait_s, ttft_s=greq.ttft_s,
                     tpot_s=greq.tpot_s)
            tr.finish(greq._trace)
        self._terminal.append(greq)
        self._emit_request_record(greq)
        cap = self.config.max_terminal
        if cap and len(self._terminal) > cap:
            for old in self._terminal[: len(self._terminal) - cap]:
                self._all.pop(old.uid, None)
            del self._terminal[: len(self._terminal) - cap]

    def _emit_request_record(self, greq: GatewayRequest) -> None:
        tel = self.telemetry
        if tel is None or not tel.enabled or not self.config.emit_per_request:
            return
        tel.emit({
            "schema": GATEWAY_REQUEST_SCHEMA, "uid": greq.uid, "status": greq.status,
            "reason": greq.reason, "tenant": greq.tenant, "priority": greq.priority,
            "n_tokens": len(greq.tokens), "retries_used": greq.retries_used,
            "queue_wait_s": greq.queue_wait_s, "ttft_s": greq.ttft_s,
            "tpot_s": greq.tpot_s, "deadline_met": greq.deadline_met,
        })

    def slo_summary(self) -> dict:
        """p50/p95/p99 blocks over the retained terminal requests' queue wait, TTFT
        and TPOT, plus terminal counts by status."""
        done = self._terminal
        summary = slo_summary({
            "queue_wait_s": [r.queue_wait_s for r in done],
            "ttft_s": [r.ttft_s for r in done],
            "tpot_s": [r.tpot_s for r in done],
        })
        summary["by_status"] = {s: sum(r.status == s for r in done)
                                for s in sorted(TERMINAL_STATUSES)}
        return summary

    def emit_slo_record(self) -> dict:
        """Build (and, with telemetry, emit) the aggregate SLO record."""
        record = {"schema": GATEWAY_SLO_SCHEMA, "policy": self._policy.name,
                  **dict(self.counters), "slo": self.slo_summary()}
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit(record)
        return record

    def stats(self) -> dict:
        """Gateway and nested engine counters."""
        return {
            "policy": self._policy.name, "queued": len(self._policy),
            "queued_cost_tokens": self._queued_cost, "running": len(self._running),
            **dict(self.counters), "breaker_state": self._breaker_state,
            "breaker_openings": self.breaker_openings,
            "breaker_closings": self.breaker_closings, "degrade_level": self.degrade_level,
            "slo": self.slo_summary(), "engine": self.engine.stats(),
        }

    def __repr__(self) -> str:
        return (f"ServingGateway(policy={self._policy.name!r}, queued={len(self._policy)}, "
                f"running={len(self._running)}, terminal={len(self._terminal)})")
