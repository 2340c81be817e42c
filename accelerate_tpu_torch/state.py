"""Process and device state singletons (``PartialState``, ``AcceleratorState``,
``GradientState``): the port's counterpart of ``accelerate_tpu/state.py``.

Single process for now: ``torch.distributed`` is not initialized, the world size is 1
and ``distributed_type`` is ``NO``. The device is CUDA unless the caller asks for the CPU
(``cpu=True`` or ``device="cpu"``); without CUDA and without that request, construction
raises; a re-init that asks for another device raises too. Each class keeps the
shared-dict singleton of the JAX package: every instance observes one state until
``_reset_state()``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
)
from .utils.device import resolve_device

__all__ = ["PartialState", "AcceleratorState", "GradientState", "is_initialized"]


class PartialState:
    """Singleton holding process/device topology."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False, device=None):
        self.__dict__ = self._shared_state
        if self.initialized:
            self._check_device(cpu, device)
            return
        self.device = resolve_device("cpu" if cpu else device)
        self.num_processes = 1
        self.process_index = 0
        self.local_process_index = 0
        self.distributed_type = DistributedType.NO

    @property
    def initialized(self) -> bool:
        return self.__dict__.get("num_processes") is not None

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    def _check_device(self, cpu: bool, device) -> None:
        """Raise when a re-init asks for another device than the state holds (``None``
        asks for CUDA, as on first init)."""
        want = torch.device("cpu" if cpu else "cuda" if device is None else device)
        have = self.device
        if want.type != have.type or (want.index is not None and have.index is not None
                                      and want.index != have.index):
            raise ValueError(
                f"PartialState already initialized on {have}; cannot re-init on {want}. "
                "Call AcceleratorState._reset_state(reset_partial_state=True) first "
                "(tests) or create the Accelerator once.")

    def __repr__(self) -> str:
        return (f"PartialState(distributed_type={getattr(self, 'distributed_type', None)}, "
                f"num_processes={getattr(self, 'num_processes', None)}, "
                f"device={getattr(self, 'device', None)})")

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()


class AcceleratorState:
    """PartialState + the mixed-precision policy."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None):
        self.__dict__ = self._shared_state
        if self.initialized:
            self._partial._check_device(cpu, device)
            if mixed_precision is not None and mixed_precision != self._mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with mixed_precision="
                    f"{self._mixed_precision!r}; cannot re-init with {mixed_precision!r}. "
                    "Call AcceleratorState._reset_state() first (tests) or create the "
                    "Accelerator once.")
            return
        self._partial = PartialState(cpu=cpu, device=device)
        self._mixed_precision = str(PrecisionType(mixed_precision or "no"))
        self.mixed_precision_policy = MixedPrecisionPolicy.from_precision(self._mixed_precision)

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        partial = self.__dict__.get("_partial")
        if partial is not None and hasattr(partial, name):
            return getattr(partial, name)
        raise AttributeError(f"AcceleratorState has no attribute {name!r}")

    @property
    def initialized(self) -> bool:
        return "_partial" in self.__dict__

    @property
    def mixed_precision(self) -> str:
        return self._mixed_precision

    def __repr__(self) -> str:
        return (f"AcceleratorState(mixed_precision={self._mixed_precision!r}, "
                f"device={self.device})")

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = False) -> None:
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()


class GradientState:
    """Gradient-accumulation bookkeeping singleton: ``sync_gradients`` (is this step an
    optimizer-apply step) and the accumulation plugin's settings."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.plugin_kwargs = {}
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()

    @property
    def initialized(self) -> bool:
        return "sync_gradients" in self.__dict__

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps", 1)

    def _set_sync_gradients(self, sync_gradients: bool) -> None:
        self.sync_gradients = sync_gradients

    def __repr__(self) -> str:
        return f"GradientState(sync_gradients={self.sync_gradients}, num_steps={self.num_steps})"

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()


def is_initialized() -> bool:
    """True once an ``AcceleratorState`` exists."""
    return AcceleratorState._shared_state != {}
