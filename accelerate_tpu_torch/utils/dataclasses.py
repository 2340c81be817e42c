"""Config dataclasses and enums of the training path.

Copies of ``accelerate_tpu/utils/dataclasses.py``'s ``KwargsHandler``, ``PrecisionType``,
``DistributedType``, ``GradientAccumulationPlugin`` and ``MixedPrecisionPolicy`` (dtypes
are torch's).
"""

from __future__ import annotations

import copy
import enum
from dataclasses import dataclass
from typing import Any

import torch

__all__ = [
    "KwargsHandler", "PrecisionType", "DistributedType", "GradientAccumulationPlugin",
    "MixedPrecisionPolicy",
]


class KwargsHandler:
    """Base mixin for kwargs dataclasses."""

    def to_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self) -> dict[str, Any]:
        """Return only the fields that differ from the dataclass defaults."""
        default = self.__class__()
        return {k: v for k, v in self.to_dict().items() if getattr(default, k) != v}


class EnumWithContains(enum.EnumMeta):
    def __contains__(cls, item):
        try:
            cls(item)
        except ValueError:
            return False
        return True


class BaseEnum(str, enum.Enum, metaclass=EnumWithContains):
    def __str__(self):
        return self.value

    @classmethod
    def list(cls):
        return list(map(str, cls))


class DistributedType(BaseEnum):
    """Which parallelism mode the Accelerator is driving: ``NO`` in one process without a
    mesh, otherwise the JAX package's rule over the mesh's axes of size > 1
    (``state.AcceleratorState``)."""

    NO = "NO"
    MULTI_DEVICE = "MULTI_DEVICE"
    FSDP = "FSDP"
    TP = "TP"
    PP = "PP"
    SP = "SP"
    EP = "EP"
    HYBRID = "HYBRID"
    MULTI_HOST = "MULTI_HOST"


class PrecisionType(BaseEnum):
    NO = "no"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class MixedPrecisionPolicy(KwargsHandler):
    """The dtype quadruple governing a train step: params kept in ``param_dtype``
    (master weights), cast to ``compute_dtype`` for the forward/backward, outputs cast to
    ``output_dtype``, gradients taken in ``reduce_dtype`` when it equals the compute
    dtype (the bf16 ``compress_reduce`` branch of ``build_train_step``)."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32
    reduce_dtype: Any = torch.float32

    @classmethod
    def from_precision(cls, precision) -> "MixedPrecisionPolicy":
        precision = PrecisionType(str(precision))
        if precision == PrecisionType.NO:
            return cls()
        if precision == PrecisionType.BF16:
            return cls(compute_dtype=torch.bfloat16, reduce_dtype=torch.bfloat16)
        if precision == PrecisionType.FP16:
            return cls(compute_dtype=torch.float16, reduce_dtype=torch.float16)
        if precision == PrecisionType.FP8:
            return cls(compute_dtype=torch.bfloat16, reduce_dtype=torch.bfloat16)
        raise ValueError(f"unknown precision {precision}")
