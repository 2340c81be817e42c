"""Latency summaries of the serving tier: a copy of ``accelerate_tpu/telemetry/slo.py``.

The gateway measures queue wait (submit → lane), TTFT (submit → first token, prefill
included) and TPOT (mean inter-token gap after the first) per request and reports
p50/p95/p99 summaries. Pure host-side float math.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence

from .schemas import ELASTIC_RESTART_SCHEMA, GATEWAY_REQUEST_SCHEMA, GATEWAY_SLO_SCHEMA

__all__ = [
    "GATEWAY_REQUEST_SCHEMA", "GATEWAY_SLO_SCHEMA", "ELASTIC_RESTART_SCHEMA",
    "percentile", "latency_summary", "slo_summary", "slo_attainment",
]

#: The percentiles every summary block carries.
SLO_PERCENTILES = (50, 95, 99)


def _percentile_sorted(ordered: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an already sorted non-empty sequence."""
    if len(ordered) == 1:
        return float(ordered[0])
    rank = (q / 100.0) * (len(ordered) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(ordered) - 1)
    frac = rank - lo
    return float(ordered[lo] * (1.0 - frac) + ordered[hi] * frac)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of ``values`` (linear interpolation, numpy's default);
    ``values`` need not be sorted and must be non-empty."""
    if not values:
        raise ValueError("percentile of an empty sequence")
    if not 0 <= q <= 100:
        raise ValueError(f"q={q} must lie in [0, 100]")
    return _percentile_sorted(sorted(values), q)


def latency_summary(values: Iterable[Optional[float]],
                    percentiles: Sequence[float] = SLO_PERCENTILES) -> dict:
    """``{count, mean, p50, p95, p99}`` over the non-None entries; ``{"count": 0}``
    when nothing was measured (a rejected request has no TTFT)."""
    vals = sorted(float(v) for v in values if v is not None)
    if not vals:
        return {"count": 0}
    out = {"count": len(vals), "mean": round(sum(vals) / len(vals), 6)}
    for q in percentiles:
        out[f"p{q:g}"] = round(_percentile_sorted(vals, q), 6)
    return out


def slo_summary(latencies: Mapping[str, Iterable[Optional[float]]]) -> Dict[str, dict]:
    """One :func:`latency_summary` block per metric name."""
    return {name: latency_summary(vals) for name, vals in latencies.items()}


def slo_attainment(values: Iterable[Optional[float]], target_s: float) -> Optional[float]:
    """Fraction of measured values at or under ``target_s`` (None when nothing was
    measured): "p95 TTFT <= 200 ms" is ``slo_attainment(ttfts, 0.2) >= 0.95``."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return None
    return sum(v <= target_s for v in vals) / len(vals)
