"""Config dataclasses and enums of the training path.

Copies of ``accelerate_tpu/utils/dataclasses.py``'s ``KwargsHandler``, ``PrecisionType``,
``DistributedType``, ``RNGType``, ``GradientAccumulationPlugin``, ``MixedPrecisionPolicy``
(dtypes are torch's), ``DataLoaderConfiguration`` (with its launcher environment
sentinels), ``ProjectConfiguration`` and ``TensorInformation``. ``RNGType`` has no
``jax`` member: the port draws no JAX keys.
"""

from __future__ import annotations

import copy
import enum
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

__all__ = [
    "KwargsHandler", "PrecisionType", "DistributedType", "RNGType",
    "GradientAccumulationPlugin", "MixedPrecisionPolicy", "DataLoaderConfiguration",
    "ProjectConfiguration", "TensorInformation", "parse_flag_from_env",
]

_TRUE = {"1", "true", "yes", "y", "on", "t"}
_FALSE = {"0", "false", "no", "n", "off", "f"}


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    """The environment variable ``key`` read as a boolean flag (``default`` when unset or
    not a recognised flag value)."""
    value = str(os.environ.get(key, default)).lower().strip()
    if value in _TRUE:
        return True
    if value in _FALSE:
        return False
    return default


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


class RNGType(BaseEnum):
    NUMPY = "numpy"
    PYTHON = "python"
    GENERATOR = "generator"  # the torch generator that drives a sampler's data order
    TORCH = "torch"


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


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """How ``Accelerator.prepare`` wraps a data loader. The None-sentinel fields resolve
    from the launcher's environment (``ACCELERATE_DISPATCH_BATCHES``,
    ``ACCELERATE_EVEN_BATCHES``, ``ACCELERATE_USE_SEEDABLE_SAMPLER``), else the built-in
    default. ``prefetch_depth``: batches placed on the device ahead of the one being
    consumed (at least 1, which ``end_of_dataloader`` needs)."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: Optional[bool] = None         # built-in True
    use_seedable_sampler: Optional[bool] = None  # built-in True
    data_seed: Optional[int] = None
    non_blocking: bool = False
    use_stateful_dataloader: bool = False
    prefetch_depth: int = 1

    def __post_init__(self):
        if self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth={self.prefetch_depth} must be >= 1 (the one-batch "
                "lookahead is required to detect end_of_dataloader before the final "
                "batch is yielded)")
        if self.dispatch_batches is None and "ACCELERATE_DISPATCH_BATCHES" in os.environ:
            self.dispatch_batches = parse_flag_from_env("ACCELERATE_DISPATCH_BATCHES")
        if self.even_batches is None:
            self.even_batches = parse_flag_from_env("ACCELERATE_EVEN_BATCHES", True)
        if self.use_seedable_sampler is None:
            self.use_seedable_sampler = parse_flag_from_env("ACCELERATE_USE_SEEDABLE_SAMPLER",
                                                            True)


@dataclass
class ProjectConfiguration(KwargsHandler):
    """Checkpoint folder layout and rotation: with ``automatic_checkpoint_naming``,
    ``save_state()`` writes ``project_dir/checkpoints/checkpoint_{iteration}`` and keeps
    at most ``total_limit`` committed checkpoints."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.project_dir is None and os.environ.get("ACCELERATE_PROJECT_DIR"):
            self.project_dir = os.environ["ACCELERATE_PROJECT_DIR"]
        if self.total_limit is None and os.environ.get("ACCELERATE_CHECKPOINT_TOTAL_LIMIT"):
            self.total_limit = int(os.environ["ACCELERATE_CHECKPOINT_TOTAL_LIMIT"])
        if self.logging_dir is None:
            self.logging_dir = self.project_dir


class TensorInformation:
    """Shape and dtype of one leaf, sent ahead of its data by the object collectives."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return f"TensorInformation(shape={self.shape}, dtype={self.dtype})"

    def __eq__(self, other):
        return (isinstance(other, TensorInformation) and self.shape == other.shape
                and self.dtype == other.dtype)
