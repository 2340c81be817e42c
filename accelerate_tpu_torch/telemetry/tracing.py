"""Request-scoped tracing, a copy of ``accelerate_tpu/telemetry/tracing.py``: where did
THIS request's latency go?

A :class:`Tracer` rides the gateway and the engine and emits one
``accelerate_tpu.telemetry.trace.span/v1`` record per lifecycle phase, all carrying the
request's ``trace_id``:

===============  =============================================================
span kind        meaning / extra attributes
===============  =============================================================
``queue``        submit → admission (or → terminal, for requests that never ran)
``admit``        zero-duration: the lane and ``kv_defer_retries``
``prefill``      the admission prefill: ``mode``, padded ``width``, ``prompt_len``,
                 prefix ``hit``/``cow``/``adopted_pages``
``decode``       one per decode dispatch the request rode: engine ``step``,
                 ``occupancy``, ``tokens`` emitted, spec ``proposed``/``accepted``,
                 ``n_steps`` of a super-step, ``host_s`` (the inter-dispatch gap)
``handoff``      one cross-engine KV page handoff (src/dst replica, pages, bytes)
``first_token``  zero-duration: the client-visible first token (the TTFT anchor)
``fault``        zero-duration: the engine's fault boundary quarantined it
``preempt``      the request lost its lane to a more urgent one
``retry``        its retry or replay was requeued (attempt index, cause)
``shed``         removed from the queue by overload shedding
``terminal``     final state: status, reason, ``ttft_s``/``tpot_s``/``n_tokens``
===============  =============================================================

``commands/trace_report.py`` groups spans by ``trace_id`` into per-request timelines and
a critical-path breakdown. A span's end is taken where the engine already reads the
device's results (the one host read of a dispatch), never at an added synchronization.

Overhead contract, as :class:`~.core.Telemetry`'s: disabled tracing costs two attribute
reads per engine step: no clock calls, no records. A ``Tracer`` is enabled iff its
``Telemetry`` is (or an explicit ``sink`` is given). Head sampling (``sample_every``,
``sample_prob``) and tail promotion are as in the JAX package; an unsampled trace's spans
buffer in the telemetry's flight recorder, which is not ported yet, so without one they
are dropped (head sampling alone).
"""

from __future__ import annotations

import itertools
import random
from typing import Callable, Dict, Optional

from .clocks import resolve_clock
from .schemas import TRACE_SPAN_SCHEMA

__all__ = ["Tracer", "TraceHandle", "TRACE_SPAN_SCHEMA"]

#: Process-wide trace sequence: uid + submit time alone would collide when
#: several gateways run on injectable VIRTUAL clocks against one telemetry sink
#: (e.g. serve-bench replaying one trace per policy — every policy's request 0
#: would share "0:0.000000000" and trace-report would merge them).
_TRACE_SEQ = itertools.count()


class TraceHandle:
    """One live request's trace state (identity + the counters spans stamp).

    ``trace_id`` is gateway uid + submit time + a process-wide sequence number —
    unique within a process even across gateways/virtual clocks, and stable
    across the request's whole lifecycle, including preemption retries (a retry
    is a new attempt inside the SAME trace)."""

    __slots__ = ("trace_id", "uid", "tenant", "t_start", "kv_defers", "attempt",
                 "sampled")

    def __init__(self, uid: int, tenant: str, t_start: float,
                 sampled: bool = True):
        self.trace_id = f"{uid}:{t_start:.9f}:{next(_TRACE_SEQ):x}"
        self.uid = uid
        self.tenant = tenant
        self.t_start = t_start
        self.kv_defers = 0   # paged-pool admission defers observed for this request
        self.attempt = 0     # preemption retries re-admit under attempt n+1
        self.sampled = sampled  # head decision; tail promotion flips it True


class Tracer:
    """Span emitter threaded through gateway + engine.

    The gateway opens a trace per submit (:meth:`start`), binds it to the engine
    request uid after ``engine.submit`` (:meth:`bind_engine`) so the engine's
    prefill/decode instrumentation can attribute device work to the right trace,
    and closes it at the terminal state (:meth:`finish`). ``clock`` is injectable
    (tests and trace replay use a manual virtual clock — spans then share the
    gateway's deadline clock, so timelines and deadlines agree)."""

    def __init__(self, telemetry=None, clock: Optional[Callable[[], float]] = None,
                 sink: Optional[Callable[[dict], None]] = None,
                 sample_every: Optional[int] = None,
                 sample_prob: Optional[float] = None,
                 sample_seed: Optional[int] = None,
                 recorder=None):
        cfg = getattr(telemetry, "config", None)
        self.telemetry = telemetry
        self._sink = sink
        #: The ONE flag the hot path reads; spans are dropped wholesale when off.
        self.enabled = bool(sink) or (
            telemetry is not None and getattr(telemetry, "enabled", False)
        )
        #: Where unsampled spans buffer (tail-promotion source); defaults to
        #: the telemetry-owned FlightRecorder when one is configured.
        self.recorder = (getattr(telemetry, "recorder", None)
                         if recorder is None else recorder)
        # Inherit the bound recorder's time domain when no clock is injected:
        # buffered spans replay through the recorder's ring and cooldowns, so
        # a tracer stamping wall seconds against a virtual-clock recorder
        # would split one trace across two domains.
        self._clock = resolve_clock(
            clock, getattr(self.recorder, "_clock", None)
        )
        # Head sampling: every-Kth (deterministic counter) or seeded
        # probability — both resolvable from TelemetryConfig so production
        # wiring needs no extra plumbing. Explicit kwargs win over config.
        self.sample_every = int(
            getattr(cfg, "trace_sample_every", 1) if sample_every is None
            else sample_every
        )
        self.sample_prob = (
            getattr(cfg, "trace_sample_prob", None) if sample_prob is None
            else sample_prob
        )
        seed = (getattr(cfg, "trace_sample_seed", 0) if sample_seed is None
                else sample_seed)
        self._rng = (random.Random(seed) if self.sample_prob is not None
                     else None)
        self.spans_emitted = 0
        self.spans_buffered = 0
        self.traces_started = 0
        self.traces_sampled = 0
        self.traces_promoted = 0
        self._traces: Dict[int, TraceHandle] = {}      # gateway uid → handle
        self._by_engine: Dict[int, TraceHandle] = {}   # engine uid → handle

    # ------------------------------------------------------------------ lifecycle
    def _sample(self) -> bool:
        """The clock-free head-sampling decision for the next trace."""
        if self.sample_every > 1:
            return self.traces_started % self.sample_every == 0
        if self._rng is not None:
            return self._rng.random() < self.sample_prob
        return True

    def start(self, uid: int, tenant: str = "default",
              t: Optional[float] = None) -> Optional[TraceHandle]:
        """Open a trace for request ``uid``; returns None while disabled (callers
        store the handle wherever they track the request — a None handle makes
        every later emit a no-op)."""
        if not self.enabled:
            return None
        sampled = self._sample()
        self.traces_started += 1
        if sampled:
            self.traces_sampled += 1
        handle = TraceHandle(uid, tenant, self._clock() if t is None else t,
                             sampled=sampled)
        self._traces[uid] = handle
        return handle

    def bind_engine(self, handle: Optional[TraceHandle], engine_uid: int) -> None:
        """Associate an engine request uid with ``handle`` so engine-side spans
        (prefill, decode rounds, pool defers) land in the right trace."""
        if handle is not None:
            self._by_engine[engine_uid] = handle

    def handle_for(self, engine_uid: int) -> Optional[TraceHandle]:
        """The handle bound to ``engine_uid`` (None when unbound — engine-direct
        submissions trace nothing)."""
        return self._by_engine.get(engine_uid)

    def finish(self, handle: Optional[TraceHandle]) -> None:
        """Drop a terminal trace's state (its spans are already emitted)."""
        if handle is None:
            return
        self._traces.pop(handle.uid, None)
        stale = [k for k, v in self._by_engine.items() if v is handle]
        for k in stale:
            self._by_engine.pop(k, None)

    # ------------------------------------------------------------------ emission
    def span(self, handle: Optional[TraceHandle], kind: str, t0: float, t1: float,
             step: Optional[int] = None, **attrs) -> None:
        """Emit one span record on ``handle``'s trace. ``step`` is the engine
        decode-step index — the causal key joining this span to the
        ``serving/v1``/``serving.kv/v1``/``serving.spec/v1`` record of the same
        step. No-op on a None handle or while disabled."""
        if handle is None or not self.enabled:
            return
        record = {
            "schema": TRACE_SPAN_SCHEMA,
            "trace_id": handle.trace_id,
            "uid": handle.uid,
            "tenant": handle.tenant,
            "span": kind,
            "t0": round(t0, 9),
            "t1": round(t1, 9),
            "dur_s": round(t1 - t0, 9),
        }
        if step is not None:
            record["step"] = step
        if attrs:
            record.update(attrs)
        if not handle.sampled:
            # Unsampled trace: the span exists ONLY as a flight-ring entry
            # (no JSONL, no sinks) until tail promotion replays it. With no
            # recorder armed the span is dropped — head sampling alone.
            self.spans_buffered += 1
            if self.recorder is not None:
                self.recorder.buffer(record)
            return
        self.spans_emitted += 1
        if self.telemetry is not None:
            self.telemetry.emit(record)
        if self._sink is not None:
            self._sink(record)

    def event(self, handle: Optional[TraceHandle], kind: str,
              t: Optional[float] = None, step: Optional[int] = None,
              **attrs) -> None:
        """A zero-duration span (``first_token``, ``preempt``, ``shed``...).
        ``t`` lets the caller reuse a timestamp it already took — the gateway's
        first-token event shares the exact clock read its ``ttft_s`` uses, so
        trace-reconstructed TTFT equals the gateway's to the digit."""
        if handle is None or not self.enabled:
            return
        if t is None:
            t = self._clock()
        self.span(handle, kind, t, t, step=step, **attrs)

    def promote(self, handle: Optional[TraceHandle]) -> int:
        """Tail-promote an unsampled trace: flip its head decision so every
        LATER span emits in full, and replay the spans already buffered in the
        flight ring through ``Telemetry.emit`` (the gateway calls this before
        emitting the terminal event of a request that ended badly, so the
        promoted stream is chronological). No-op on sampled/None handles.
        Returns the number of ring spans replayed."""
        if handle is None or not self.enabled or handle.sampled:
            return 0
        handle.sampled = True
        self.traces_promoted += 1
        if self.recorder is None:
            return 0
        return self.recorder.promote(handle.trace_id)

    def count_defer(self, engine_uid: int) -> None:
        """One paged-pool admission defer observed for this engine request; the
        count lands on the eventual ``admit`` span as ``kv_defer_retries``."""
        handle = self._by_engine.get(engine_uid)
        if handle is not None:
            handle.kv_defers += 1

    def __repr__(self) -> str:
        return (
            f"Tracer(enabled={self.enabled}, live={len(self._traces)}, "
            f"spans_emitted={self.spans_emitted}, "
            f"spans_buffered={self.spans_buffered}, "
            f"promoted={self.traces_promoted})"
        )
