"""Seeding and cross-process synchronisation of host random states: the port's
counterpart of ``accelerate_tpu/utils/random.py``.

Model randomness in the port comes from explicit ``torch.Generator``s (a train step's
rng loss gets one per micro-step); what needs synchronising is data-order randomness
in host generators (Python's, numpy's, torch's, or a sampler's generator).
``synchronize_rng_states`` broadcasts process 0's states before a data loader's epoch.
"""

from __future__ import annotations

import random
from typing import Iterable, Optional

import numpy as np
import torch

from .dataclasses import RNGType

__all__ = ["set_seed", "synchronize_rng_state", "synchronize_rng_states"]


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False) -> int:
    """Seed Python's, numpy's and torch's (CPU and CUDA) generators; return the seed.
    ``device_specific`` adds the process index, so each process draws its own stream;
    ``deterministic`` asks torch for deterministic algorithms."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState._shared_state.get("process_index", 0)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True)
    return seed


def _get_state(rng_type: RNGType, generator=None):
    if rng_type == RNGType.PYTHON:
        return random.getstate()
    if rng_type == RNGType.NUMPY:
        return np.random.get_state()
    if rng_type == RNGType.GENERATOR:
        if generator is None:
            raise ValueError("generator RNG sync requested but no generator passed")
        return generator.get_state()
    return torch.get_rng_state()


def _set_state(rng_type: RNGType, state, generator=None) -> None:
    if rng_type == RNGType.PYTHON:
        random.setstate(state)
    elif rng_type == RNGType.NUMPY:
        np.random.set_state(state)
    elif rng_type == RNGType.GENERATOR:
        generator.set_state(state)
    else:
        torch.set_rng_state(state)


def synchronize_rng_state(rng_type: Optional[RNGType] = None, generator=None) -> None:
    """Process 0's state of one host generator, broadcast to every process (a no-op in
    one process)."""
    from .operations import _world_size, broadcast_object_list

    if rng_type is None or _world_size() == 1:
        return
    rng_type = RNGType(str(rng_type))
    payload = [_get_state(rng_type, generator)]
    broadcast_object_list(payload, from_process=0)
    _set_state(rng_type, payload[0], generator)


def synchronize_rng_states(rng_types: Iterable[str], generator=None) -> None:
    for rng_type in rng_types:
        synchronize_rng_state(RNGType(str(rng_type)), generator=generator)
