"""Deterministic fault injection of the port: a copy of
``accelerate_tpu/resilience/faults.py`` (host-only Python, no device code).

A :class:`FaultPlan` holds :class:`FaultSpec` clauses, each naming an injection **site**
(a string the instrumented code passes to :meth:`FaultPlan.draw`), a fault **kind** and a
seeded firing rule (a per-spec numpy stream ``(seed, [scope,] i)``, an invocation
window, a fire budget, optional request matching), so a plan fires at the same
invocations as the JAX package's. The port's instrumented sites:

=====================  ======================================================
site                   instrumented in
=====================  ======================================================
``serving.decode``     ``ContinuousBatcher`` decode/verify dispatch (``error``,
                       ``hang``; ``crash`` raises :class:`EngineCrashed` past
                       the engine's recovery boundary, the fleet router's
                       failover signal)
``serving.prefill``    admission prefill (``error``, always attributable to
                       the admitting request; ``crash`` as above)
``serving.kv_admit``   paged page-pool allocation (``error``)
``train.step``         ``Accelerator``'s train step (``nonfinite`` poisons the
                       batch's float leaves with NaN, the real non-finite
                       guard path; ``error`` raises; ``crash`` raises
                       :class:`StageCrashed` past the step boundary)
=====================  ======================================================

Every kind fires on the host before the launch it guards (``hang`` sleeps there), so no
CUDA graph is ever left half-replayed. Zero overhead when disabled: instrumented code
holds ``faults=None`` and pays one attribute read. ``StageCrashed`` is the class only:
its gang supervisor is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ..telemetry.clocks import resolve_clock

__all__ = [
    "FaultError",
    "InjectedFault",
    "EngineCrashed",
    "StageCrashed",
    "StepTimeout",
    "NonFiniteStepError",
    "FaultSpec",
    "FaultPlan",
    "StepWatchdog",
    "parse_fault_spec",
]

#: Fault kinds a spec may inject. What each means is site-specific (see the
#: site catalog above); sites ignore kinds they don't implement.
FAULT_KINDS = ("error", "hang", "nonfinite", "crash", "corrupt")


class FaultError(RuntimeError):
    """Base of every failure the resilience layer raises or injects."""


class InjectedFault(FaultError):
    """An injected failure firing at an instrumented site.

    ``uid`` carries the poison request when the spec is *attributed* (the
    recovery path quarantines it directly); ``None`` forces the bisection
    fallback. ``pre_dispatch`` tells the boundary the device state was NOT
    touched (the fault raised before any donated dispatch), so recovery can
    skip the full rebuild."""

    def __init__(self, site: str, kind: str, uid: Optional[int] = None,
                 pre_dispatch: bool = True):
        super().__init__(f"injected fault at {site}: {kind}"
                         + (f" (uid={uid})" if uid is not None else ""))
        self.site = site
        self.kind = kind
        self.uid = uid
        self.pre_dispatch = pre_dispatch


class EngineCrashed(FaultError):
    """A whole-engine (replica) death — the in-process stand-in for a killed
    serving process.

    Unlike :class:`InjectedFault`, the engine's own recovery boundary must NOT
    catch this: there is no process left to quarantine a request in, so the
    crash propagates out of ``step()`` to whoever owns the replica (the fleet
    router, which migrates the in-flight requests to another replica and hands
    the corpse to the supervisor for restart). Injected via fault kind
    ``crash`` at the serving sites (``serving.decode`` / ``serving.prefill``)."""

    def __init__(self, site: str, uid: Optional[int] = None):
        super().__init__(f"engine crashed at {site}")
        self.site = site
        self.kind = "crash"
        self.uid = uid


class StageCrashed(FaultError):
    """A whole-training-gang (MPMD stage) death — the training analog of
    :class:`EngineCrashed`.

    The step boundary must NOT catch this: there is no process left to skip a
    step in, so the crash propagates past ``train.step`` to whoever owns the
    gang (the gang-of-gangs orchestrator, ``elastic.GangOfGangs``, which holds
    the peer stages at a barrier, hands the corpse to the ``FleetSupervisor``
    for a budgeted restart, and replays the pipeline from the last verified
    checkpoint). ``gang_id`` is machine-readable — it names WHICH gang's
    restart budget the failure charges. Injected via fault kind ``crash`` at
    the ``train.step`` site."""

    def __init__(self, site: str, gang_id: str = "gang0",
                 uid: Optional[int] = None):
        super().__init__(f"stage gang {gang_id} crashed at {site}")
        self.site = site
        self.kind = "crash"
        self.gang_id = str(gang_id)
        self.uid = uid


class StepTimeout(FaultError):
    """A dispatch exceeded its :class:`StepWatchdog` wall-clock budget."""

    def __init__(self, site: str, elapsed_s: float, budget_s: float):
        super().__init__(
            f"{site}: dispatch took {elapsed_s:.3f}s (budget {budget_s:.3f}s)"
        )
        self.site = site
        self.uid = None
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s


class NonFiniteStepError(FaultError):
    """Training aborted: ``skip_nonfinite_steps`` consecutive-skip budget hit."""

    def __init__(self, consecutive: int, total: int):
        super().__init__(
            f"{consecutive} consecutive non-finite training steps "
            f"({total} total skipped) — loss/grads are diverging, aborting"
        )
        self.consecutive = consecutive
        self.total = total


@dataclasses.dataclass
class FaultSpec:
    """One injection clause: fire ``kind`` at ``site`` with probability
    ``prob`` per invocation, inside the invocation window ``[start, stop)``,
    at most ``max_fires`` times.

    ``match_uid`` restricts firing to invocations whose context includes that
    request uid (a data-poison stand-in); ``attributed=False`` withholds the
    uid from the raised fault, forcing the recovery path's bisection fallback.
    ``hang_s`` is the injected dispatch stall for kind ``hang``."""

    site: str
    kind: str = "error"
    prob: float = 1.0
    start: int = 0
    stop: Optional[int] = None
    max_fires: Optional[int] = None
    match_uid: Optional[int] = None
    attributed: bool = True
    hang_s: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"kind={self.kind!r} must be one of {list(FAULT_KINDS)}"
            )
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob={self.prob} must be in [0, 1]")
        if self.start < 0:
            raise ValueError(f"start={self.start} must be >= 0")
        if self.stop is not None and self.stop <= self.start:
            raise ValueError(f"stop={self.stop} must be > start={self.start}")
        if self.max_fires is not None and self.max_fires < 1:
            raise ValueError(f"max_fires={self.max_fires} must be >= 1")
        if self.hang_s < 0:
            raise ValueError(f"hang_s={self.hang_s} must be >= 0")


class FaultPlan:
    """A seeded set of :class:`FaultSpec` clauses plus the firing bookkeeping.

    ``draw(site, uids=...)`` is the ONE call instrumented code makes: it
    advances the site's invocation counter and returns the first spec that
    fires (or None). Every fire is recorded in :attr:`fired` (site, kind, uid,
    invocation) so tests and the chaos bench can assert exactly which faults
    landed. Determinism: spec ``i`` owns the RNG stream ``(seed, i)`` and
    consumes one uniform per invocation of its site — whether it fires at the
    site's n-th invocation is independent of every other site and spec.

    ``scope`` keys the streams ``(seed, scope, i)`` instead — the stage-scoped
    spelling for gang-of-gangs training: every MPMD stage process holds its OWN
    plan built from the SAME seed and clause string but scoped by its
    ``gang_id``, so which stage crashes at which step is a pure function of
    ``(seed, gang_id)`` and never of how the stages interleave."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0,
                 scope: Optional[str] = None):
        import zlib

        import numpy as np

        self.specs = list(specs)
        self.seed = int(seed)
        self.scope = scope
        scope_key = ([] if scope is None
                     else [zlib.crc32(str(scope).encode("utf-8"))])
        self._rngs = [np.random.default_rng([self.seed, *scope_key, i])
                      for i in range(len(self.specs))]
        self._site_counts: dict = {}
        self._fires_left = [
            s.max_fires if s.max_fires is not None else -1 for s in self.specs
        ]
        self.fired: List[dict] = []

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0,
                  scope: Optional[str] = None) -> "FaultPlan":
        """Build a plan from the compact ``ACCELERATE_FAULTS`` string form
        (:func:`parse_fault_spec`). ``scope`` stage-scopes the RNG streams
        (one plan per gang from one clause string)."""
        specs, parsed_seed = parse_fault_spec(spec)
        return cls(specs, seed=parsed_seed if parsed_seed is not None else seed,
                   scope=scope)

    def draw(self, site: str, uids: Optional[Sequence[int]] = None,
             uid: Optional[int] = None) -> Optional[FaultSpec]:
        """One invocation of ``site``: returns the first spec that fires.

        ``uids`` (the active request set) / ``uid`` (a single admitting
        request) let ``match_uid`` specs model data poison — they fire only
        when their target participates. The matched spec's raised fault
        carries the uid only when the spec is ``attributed``."""
        n = self._site_counts.get(site, 0)
        self._site_counts[site] = n + 1
        hit = None
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            # Every site-matching spec consumes its uniform at every
            # invocation (fired or not) — the stream position depends only on
            # the site's invocation count, never on which specs fired.
            u = float(self._rngs[i].random())
            if hit is not None or self._fires_left[i] == 0:
                continue
            if n < spec.start or (spec.stop is not None and n >= spec.stop):
                continue
            if spec.match_uid is not None:
                present = (uid == spec.match_uid) or (
                    uids is not None and spec.match_uid in uids
                )
                if not present:
                    continue
            if u < spec.prob:
                hit = (i, spec)
        if hit is None:
            return None
        i, spec = hit
        if self._fires_left[i] > 0:
            self._fires_left[i] -= 1
        target = spec.match_uid if spec.match_uid is not None else uid
        self.fired.append({
            "site": site, "kind": spec.kind, "invocation": n,
            "uid": target if spec.attributed else None,
        })
        return spec

    def fault_for(self, spec: FaultSpec, site: str,
                  uid: Optional[int] = None) -> InjectedFault:
        """The exception a fired spec injects (uid withheld when the spec is
        unattributed — the bisection-fallback test hook)."""
        target = spec.match_uid if spec.match_uid is not None else uid
        return InjectedFault(
            site, spec.kind, uid=target if spec.attributed else None
        )

    def stats(self) -> dict:
        return {
            "seed": self.seed,
            "scope": self.scope,
            "specs": len(self.specs),
            "fired": len(self.fired),
            "by_site": {
                site: sum(1 for f in self.fired if f["site"] == site)
                for site in sorted({f["site"] for f in self.fired})
            },
            "invocations": dict(self._site_counts),
        }

    def __repr__(self) -> str:
        scope = f", scope={self.scope!r}" if self.scope is not None else ""
        return (f"FaultPlan(seed={self.seed}{scope}, specs={len(self.specs)}, "
                f"fired={len(self.fired)})")


def parse_fault_spec(text: str):
    """Parse the compact ``ACCELERATE_FAULTS`` clause string →
    ``(specs, seed-or-None)``.

    Grammar: semicolon-separated clauses; ``seed=N`` sets the plan seed; every
    other clause is ``site:kind[:prob][,key=value...]`` with keys
    ``start``/``stop``/``max``/``uid``/``hang_s``/``attributed``. Example::

        seed=7; serving.decode:error:0.1,max=3; ckpt.save:crash,start=2
    """
    specs: List[FaultSpec] = []
    seed = None
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            seed = int(clause[len("seed="):])
            continue
        head, _, tail = clause.partition(",")
        parts = head.strip().split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault clause {clause!r}: expected site:kind[:prob][,k=v...]"
            )
        kw = {"site": parts[0].strip(), "kind": parts[1].strip()}
        if len(parts) > 2:
            kw["prob"] = float(parts[2])
        if len(parts) > 3:
            raise ValueError(f"fault clause {clause!r}: too many ':' fields")
        for item in tail.split(","):
            item = item.strip()
            if not item:
                continue
            key, _, value = item.partition("=")
            key = key.strip()
            value = value.strip()
            if key == "start":
                kw["start"] = int(value)
            elif key == "stop":
                kw["stop"] = int(value)
            elif key == "max":
                kw["max_fires"] = int(value)
            elif key == "uid":
                kw["match_uid"] = int(value)
            elif key == "hang_s":
                kw["hang_s"] = float(value)
            elif key == "attributed":
                kw["attributed"] = value.lower() in ("1", "true", "yes")
            else:
                raise ValueError(
                    f"fault clause {clause!r}: unknown key {key!r}"
                )
        specs.append(FaultSpec(**kw))
    return specs, seed


class StepWatchdog:
    """Wall-clock budget for one dispatch: ``open()`` before, ``check()``
    after the device sync — raises :class:`StepTimeout` when the dispatch
    (including any injected hang) overran.

    The check runs BEFORE any token is appended or streamed, so a timed-out
    step emits nothing and the recovery rebuild replays it cleanly — a hang
    converts into exactly the step-failure path (docs/resilience.md). The
    clock is injectable for tests.

    **Post-hoc by design**: the check fires only once the dispatch RETURNS —
    an overrun that eventually completes (transient device stall, injected
    hang) is caught and replayed, but a dispatch that never returns is never
    checked and blocks the process. Protection against truly-wedged processes
    is the supervisor layer's job (``ElasticSupervisor(attempt_timeout=...)``,
    which tears the whole gang down from outside)."""

    def __init__(self, budget_s: float, clock=None):
        if budget_s <= 0:
            raise ValueError(f"budget_s={budget_s} must be > 0")
        self.budget_s = float(budget_s)
        self._clock = resolve_clock(clock)
        self.timeouts = 0

    def open(self) -> float:
        return self._clock()

    def check(self, t0: float, site: str = "serving.decode") -> None:
        elapsed = self._clock() - t0
        if elapsed > self.budget_s:
            self.timeouts += 1
            raise StepTimeout(site, elapsed, self.budget_s)
