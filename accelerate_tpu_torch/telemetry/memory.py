"""Device memory counters from the CUDA caching allocator, the port's counterpart of
``accelerate_tpu/telemetry/memory.py``.

``torch.cuda.memory_stats`` is the allocator's own ledger, read on the host without a
device synchronization. Without a card the result is empty, so records omit their
memory columns there.
"""

from __future__ import annotations

import torch

__all__ = ["device_memory_stats"]


def device_memory_stats(device=None, device_index: int = 0) -> dict:
    """Live and peak allocated bytes, the card's total bytes, allocation count and
    largest allocation of one CUDA device, under the JAX record's keys; ``{}`` without
    a card (a CPU device, or none visible)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return {}
        device_index = device.index or 0
    if not torch.cuda.is_available() or device_index >= torch.cuda.device_count():
        return {}
    stats = torch.cuda.memory_stats(device_index)
    if not stats:
        return {}
    out = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device_index).total_memory),
        "num_allocs": int(stats.get("allocation.all.allocated", 0)),
    }
    largest = stats.get("max_split_size")
    if largest is not None and largest > 0:
        out["largest_alloc_size"] = int(largest)
    return out
