"""Derived throughput rates (MFU, tokens/s, examples/s), the port's counterpart of
``accelerate_tpu/telemetry/derived.py``: computed from a static per-step FLOP cost and
a fenced step time, never from device counters.

``PEAK_TFLOPS`` holds the datasheet peaks of the port's card: the H100 SXM's dense bf16
989 TFLOP/s (and ``PEAK_HBM_TBPS`` its 3.35 TB/s), the figures ``PERF.md`` bounds every
kernel with; ``cpu`` keeps a CPU run's MFU finite (and meaningless).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["PEAK_TFLOPS", "PEAK_HBM_TBPS", "peak_tflops", "derived_rates"]

#: Peak dense bf16 TFLOP/s per card by device name.
PEAK_TFLOPS = {
    "H100": 989.0,
    "cpu": 0.5,
}

#: Peak HBM bandwidth, TB/s, per card by device name.
PEAK_HBM_TBPS = {"H100": 3.35}

#: The peak assumed when the device name matches no entry (the H100's).
DEFAULT_PEAK_TFLOPS = 989.0


def _device_kind(device) -> str:
    """The device's name: ``torch.cuda.get_device_name`` for a CUDA device."""
    if device is None:
        return "cpu"
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def peak_tflops(device=None, device_kind: Optional[str] = None) -> float:
    """Datasheet bf16 peak for a device (the longest matching name wins)."""
    if device_kind is None:
        device_kind = _device_kind(device)
    kind = device_kind.lower()
    best = None
    for key, val in PEAK_TFLOPS.items():
        if key.lower() in kind and (best is None or len(key) > best[0]):
            best = (len(key), val)
    return best[1] if best else DEFAULT_PEAK_TFLOPS


def derived_rates(
    step_time_s: float,
    *,
    tokens_per_step: Optional[float] = None,
    examples_per_step: Optional[float] = None,
    flops_per_step: Optional[float] = None,
    peak_flops: Optional[float] = None,
    device=None,
    n_chips: int = 1,
) -> dict:
    """Per-card rates for one step window; absent inputs yield absent columns.
    ``peak_flops`` (FLOP/s) defaults to the datasheet peak of ``device``."""
    out: dict = {}
    if step_time_s <= 0:
        return out
    chips = max(n_chips, 1)
    if tokens_per_step is not None:
        out["tokens_per_sec_per_chip"] = tokens_per_step / step_time_s / chips
    if examples_per_step is not None:
        out["examples_per_sec_per_chip"] = examples_per_step / step_time_s / chips
    if flops_per_step is not None:
        tflops = flops_per_step / step_time_s / chips / 1e12
        out["achieved_tflops_per_chip"] = tflops
        if peak_flops is None:
            peak_flops = peak_tflops(device) * 1e12
        out["peak_tflops_assumed"] = peak_flops / 1e12
        out["mfu"] = tflops * 1e12 / peak_flops
    return out
