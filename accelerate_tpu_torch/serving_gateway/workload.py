"""Workload traces of the port, a copy of ``accelerate_tpu/serving_gateway/workload.py``:
recorded and generated arrival processes for serving replay. For a seed, every
generator's trace is byte-identical to the JAX package's (the same ``trace_hash``).

Production traffic is bursty, heavy-tailed and multi-tenant; this module is the trace
layer that replays such traffic:

- **Format** — one request per JSONL line: ``arrival_s`` (relative to trace
  start), ``prompt_len``/``output_len`` (tokens), ``tenant``, ``priority``,
  ``deadline_s`` (relative to arrival; None = no deadline). A header line
  (``schema = accelerate_tpu.serving.workload/v1``) records the generator and
  seed. Token *ids* are intentionally not in the trace — replay synthesizes
  them deterministically from the trace seed, so a trace stays model-agnostic
  (lengths and arrival structure are what serving performance depends on).
- **Generators** — deterministic-by-seed builders of the canonical hard
  arrival processes: ``poisson`` (bursty Poisson arrivals), ``diurnal``
  (sinusoidal rate ramp), ``swing`` (diurnal parameterized by peak:trough
  ratio — the autoscale bench's 4× load swing), ``heavy_tail`` (Pareto
  prompt/output lengths — the long-context tail that wrecks padded-width
  admission), ``tenant_flood``
  (an adversarial tenant dumping a flood into otherwise-normal traffic — the
  WFQ isolation scenario).
- **Replay** — :func:`replay_trace` drives a ``ServingGateway`` on a VIRTUAL
  clock (one ``step()`` = ``step_dt`` seconds), submitting each request when
  the clock passes its arrival. Offered load is swept by time-compression
  (``load=2.0`` replays arrivals twice as fast against the same engine
  capacity), which is how offered load is swept.
- **Identity** — :func:`trace_hash` content-hashes the rows; curve artifacts
  stamp it beside the git/config provenance so a curve names the exact arrival
  process that produced it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Dict, List, Optional

__all__ = [
    "WORKLOAD_TRACE_SCHEMA",
    "TraceRequest",
    "GENERATORS",
    "generate_workload",
    "save_trace",
    "load_trace",
    "trace_hash",
    "replay_trace",
]

#: Header-line schema id of a workload-trace JSONL file (not a telemetry record).
WORKLOAD_TRACE_SCHEMA = "accelerate_tpu.serving.workload/v1"


@dataclasses.dataclass
class TraceRequest:
    """One arrival in a workload trace (times in seconds, lengths in tokens)."""

    arrival_s: float
    prompt_len: int
    output_len: int
    tenant: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None  # relative to arrival; None = no deadline

    def to_json(self) -> dict:
        return {
            "arrival_s": round(float(self.arrival_s), 6),
            "prompt_len": int(self.prompt_len),
            "output_len": int(self.output_len),
            "tenant": self.tenant,
            "priority": int(self.priority),
            "deadline_s": (
                None if self.deadline_s is None else round(float(self.deadline_s), 6)
            ),
        }

    @classmethod
    def from_json(cls, row: dict) -> "TraceRequest":
        return cls(
            arrival_s=float(row["arrival_s"]),
            prompt_len=int(row["prompt_len"]),
            output_len=int(row["output_len"]),
            tenant=str(row.get("tenant", "default")),
            priority=int(row.get("priority", 0)),
            deadline_s=(
                None if row.get("deadline_s") is None else float(row["deadline_s"])
            ),
        )


def _lengths(rng, n, prompt_range, output_range):
    prompts = rng.integers(prompt_range[0], prompt_range[1] + 1, n)
    outputs = rng.integers(output_range[0], output_range[1] + 1, n)
    return prompts, outputs


def _class_attrs(rng, high_frac, tenants, deadline_tight, deadline_loose):
    is_high = bool(rng.random() < high_frac)
    return {
        "tenant": f"tenant{int(rng.integers(0, tenants))}",
        "priority": 2 if is_high else 0,
        "deadline_s": deadline_tight if is_high else deadline_loose,
    }


def poisson_burst(
    n: int, seed: int = 0, mean_iat_s: float = 1.0, burst_every: int = 12,
    burst_size: int = 6, prompt_range=(3, 24), output_range=(4, 16),
    high_frac: float = 0.25, tenants: int = 3,
    deadline_tight: float = 30.0, deadline_loose: float = 240.0,
) -> List[TraceRequest]:
    """Poisson arrivals punctuated by bursts: every ``burst_every``-th arrival
    brings ``burst_size`` extra requests at the SAME instant (retry storms, page
    reloads, fan-out callers) — the queue-depth spikes paced arrivals never show."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out: List[TraceRequest] = []
    t = 0.0
    k = 0
    while len(out) < n:
        t += float(rng.exponential(mean_iat_s))
        k += 1
        group = 1 + (burst_size if burst_every and k % burst_every == 0 else 0)
        for _ in range(min(group, n - len(out))):
            p, o = _lengths(rng, 1, prompt_range, output_range)
            out.append(TraceRequest(
                arrival_s=t, prompt_len=int(p[0]), output_len=int(o[0]),
                **_class_attrs(rng, high_frac, tenants, deadline_tight,
                               deadline_loose),
            ))
    return out


def diurnal_ramp(
    n: int, seed: int = 0, mean_iat_s: float = 1.0, period_s: float = 120.0,
    depth: float = 0.8, prompt_range=(3, 24), output_range=(4, 16),
    high_frac: float = 0.25, tenants: int = 3,
    deadline_tight: float = 30.0, deadline_loose: float = 240.0,
) -> List[TraceRequest]:
    """Sinusoidal rate modulation (period ``period_s``, peak/trough ratio set by
    ``depth``): the diurnal traffic shape that makes static capacity planning
    either wasteful at trough or shedding at peak."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out: List[TraceRequest] = []
    t = 0.0
    two_pi = 2.0 * 3.141592653589793
    for _ in range(n):
        # rate(t) = base * (1 + depth*sin) → iat scales inversely.
        rate_scale = 1.0 + depth * float(np.sin(two_pi * t / period_s))
        iat = mean_iat_s / max(rate_scale, 1e-3)
        t += float(rng.exponential(iat))
        p, o = _lengths(rng, 1, prompt_range, output_range)
        out.append(TraceRequest(
            arrival_s=t, prompt_len=int(p[0]), output_len=int(o[0]),
            **_class_attrs(rng, high_frac, tenants, deadline_tight, deadline_loose),
        ))
    return out


def swing(
    n: int, seed: int = 0, mean_iat_s: float = 1.0, period_s: float = 120.0,
    swing_ratio: float = 4.0, prompt_range=(3, 24), output_range=(4, 16),
    high_frac: float = 0.25, tenants: int = 3,
    deadline_tight: float = 30.0, deadline_loose: float = 240.0,
) -> List[TraceRequest]:
    """Diurnal ramp parameterized by PEAK:TROUGH ratio instead of modulation
    depth — ``swing_ratio=4.0`` is the canonical 4× load swing the autoscale
    bench replays (``serve-bench --autoscale``). A ratio R maps to
    ``depth=(R-1)/(R+1)`` on :func:`diurnal_ramp`'s sinusoid, so the trace is
    seeded, hash-stable and reproducible from ``--trace-gen swing`` alone."""
    if swing_ratio < 1.0:
        raise ValueError(f"swing_ratio={swing_ratio} must be >= 1.0")
    depth = (swing_ratio - 1.0) / (swing_ratio + 1.0)
    return diurnal_ramp(
        n, seed=seed, mean_iat_s=mean_iat_s, period_s=period_s, depth=depth,
        prompt_range=prompt_range, output_range=output_range,
        high_frac=high_frac, tenants=tenants,
        deadline_tight=deadline_tight, deadline_loose=deadline_loose,
    )


def heavy_tail(
    n: int, seed: int = 0, mean_iat_s: float = 1.0, alpha: float = 1.3,
    prompt_range=(3, 48), output_range=(4, 32), high_frac: float = 0.25,
    tenants: int = 3, deadline_tight: float = 30.0, deadline_loose: float = 240.0,
) -> List[TraceRequest]:
    """Poisson arrivals with Pareto(``alpha``) prompt/output lengths (clamped to
    the ranges): most requests are short chat turns, the tail is long-context —
    the mix where padded-width admission and per-request KV pricing diverge."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def pareto_len(lo, hi, size):
        raw = lo * (1.0 + rng.pareto(alpha, size))
        return np.clip(raw, lo, hi).astype(int)

    out: List[TraceRequest] = []
    t = 0.0
    prompts = pareto_len(prompt_range[0], prompt_range[1], n)
    outputs = pareto_len(output_range[0], output_range[1], n)
    for i in range(n):
        t += float(rng.exponential(mean_iat_s))
        out.append(TraceRequest(
            arrival_s=t, prompt_len=int(prompts[i]), output_len=int(outputs[i]),
            **_class_attrs(rng, high_frac, tenants, deadline_tight, deadline_loose),
        ))
    return out


def tenant_flood(
    n: int, seed: int = 0, mean_iat_s: float = 1.0, flood_frac: float = 0.4,
    flood_at_frac: float = 0.35, flood_span_s: float = 2.0,
    prompt_range=(3, 24), output_range=(4, 16), high_frac: float = 0.25,
    tenants: int = 3, deadline_tight: float = 30.0, deadline_loose: float = 240.0,
) -> List[TraceRequest]:
    """Adversarial tenant flood: normal multi-tenant Poisson traffic, then ONE
    tenant (``"flood"``, priority 0, no deadline pressure of its own) dumps
    ``flood_frac`` of the trace into a ``flood_span_s`` window — the isolation
    scenario where WFQ/priority must keep the other tenants' SLOs alive while
    FIFO serves the flood in arrival order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_flood = int(n * flood_frac)
    n_bg = n - n_flood
    out: List[TraceRequest] = []
    t = 0.0
    for _ in range(n_bg):
        t += float(rng.exponential(mean_iat_s))
        p, o = _lengths(rng, 1, prompt_range, output_range)
        out.append(TraceRequest(
            arrival_s=t, prompt_len=int(p[0]), output_len=int(o[0]),
            **_class_attrs(rng, high_frac, tenants, deadline_tight, deadline_loose),
        ))
    flood_at = flood_at_frac * t
    for _ in range(n_flood):
        p, o = _lengths(rng, 1, prompt_range, output_range)
        out.append(TraceRequest(
            arrival_s=flood_at + float(rng.random()) * flood_span_s,
            prompt_len=int(p[0]), output_len=int(o[0]),
            tenant="flood", priority=0, deadline_s=deadline_loose,
        ))
    out.sort(key=lambda r: r.arrival_s)
    return out


#: Generator registry (``serve-bench --trace-gen <name>``).
GENERATORS: Dict[str, Callable[..., List[TraceRequest]]] = {
    "poisson": poisson_burst,
    "diurnal": diurnal_ramp,
    "swing": swing,
    "heavy_tail": heavy_tail,
    "tenant_flood": tenant_flood,
}


def generate_workload(kind: str, n: int, seed: int = 0, **kwargs) -> List[TraceRequest]:
    """Build ``n`` requests with the named generator (deterministic per seed)."""
    if kind not in GENERATORS:
        raise ValueError(
            f"unknown workload generator {kind!r} (known: {sorted(GENERATORS)})"
        )
    return GENERATORS[kind](n, seed=seed, **kwargs)


# ----------------------------------------------------------------- file format
def save_trace(path: str, trace: List[TraceRequest], generator: str = "custom",
               seed: Optional[int] = None) -> None:
    """Write a trace as JSONL: one header line (schema/generator/seed/n), then
    one request per line in arrival order."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({
            "schema": WORKLOAD_TRACE_SCHEMA,
            "generator": generator,
            "seed": seed,
            "n": len(trace),
        }) + "\n")
        for row in trace:
            f.write(json.dumps(row.to_json()) + "\n")


def load_trace(path: str) -> List[TraceRequest]:
    """Read a JSONL workload trace (header line optional; rows sorted by arrival)."""
    rows: List[TraceRequest] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "schema" in obj and "arrival_s" not in obj:
                if obj["schema"] != WORKLOAD_TRACE_SCHEMA:
                    raise ValueError(
                        f"{path}: unknown workload trace schema {obj['schema']!r} "
                        f"(expected {WORKLOAD_TRACE_SCHEMA})"
                    )
                continue
            rows.append(TraceRequest.from_json(obj))
    rows.sort(key=lambda r: r.arrival_s)
    return rows


def trace_hash(trace: List[TraceRequest]) -> str:
    """Content hash of the rows (order-sensitive): the identity a curve artifact
    stamps so "same trace" means same bytes, not same filename."""
    h = hashlib.blake2b(digest_size=12)
    for row in trace:
        h.update(json.dumps(row.to_json(), sort_keys=True).encode())
    return h.hexdigest()


# ----------------------------------------------------------------------- replay
class VirtualClock:
    """Manual monotonic clock for deterministic replay (inject into the gateway,
    its tracer, AND :func:`replay_trace` so deadlines, spans and arrivals share
    one timeline)."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def replay_trace(
    gateway,
    trace: List[TraceRequest],
    vocab_size: int,
    clock: VirtualClock,
    step_dt: float = 1.0,
    load: float = 1.0,
    seed: int = 0,
    max_steps: Optional[int] = None,
    on_token_factory: Optional[Callable[[int], object]] = None,
) -> list:
    """Replay ``trace`` through ``gateway`` on the virtual clock; returns the
    ``GatewayRequest`` per trace row (submission order).

    Each loop iteration submits every request whose (load-compressed) arrival
    time has passed, runs ONE ``gateway.step()``, and advances the clock by
    ``step_dt`` — so "offered load" has a precise meaning: ``load=2.0`` presents
    the same arrival process at twice the rate against identical engine capacity
    (steps per virtual second is fixed). Prompt token ids are synthesized
    deterministically from ``seed`` + row index; deadlines come from the trace
    (relative to arrival, on the same virtual clock the gateway enforces them
    with)."""
    import numpy as np

    if load <= 0:
        raise ValueError(f"load={load} must be > 0")
    prompt_rng = np.random.default_rng(seed)
    prompts = [
        prompt_rng.integers(1, vocab_size, row.prompt_len).astype(np.int32)
        for row in trace
    ]
    greqs = []
    i = 0
    steps = 0
    cap = max_steps if max_steps is not None else 200 * max(1, len(trace))
    while i < len(trace) or gateway.queue_depth or gateway.running_count:
        while i < len(trace) and trace[i].arrival_s / load <= clock.t:
            row = trace[i]
            kwargs = {}
            if on_token_factory is not None:
                # Per-request streaming capture (and its on_retry stream
                # reset): the chaos bench's byte-parity evidence hangs off it.
                cbs = on_token_factory(i)
                if isinstance(cbs, tuple):
                    kwargs["on_token"], kwargs["on_retry"] = cbs
                else:
                    kwargs["on_token"] = cbs
            greqs.append(gateway.submit(
                prompts[i],
                max_new_tokens=row.output_len,
                priority=row.priority,
                deadline_s=row.deadline_s,
                tenant=row.tenant,
                **kwargs,
            ))
            i += 1
        gateway.step()
        clock.advance(step_dt)
        steps += 1
        if steps >= cap:
            raise RuntimeError(
                f"replay exceeded {cap} steps with {len(trace) - i} arrivals "
                "pending — engine stalled or step_dt/load pathological"
            )
    return greqs
