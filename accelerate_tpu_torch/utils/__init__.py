"""Small shared helpers of the port, with the JAX package's ``utils`` names for what is
ported: the config dataclasses and plugins, the environment parsers, the host-level
collectives and the rng helpers."""

from .dataclasses import (
    DataLoaderConfiguration,
    DistributedType,
    FaultConfig,
    FP8RecipeKwargs,
    FSDPShardingStrategy,
    FullyShardedDataParallelPlugin,
    GatewayConfig,
    GradientAccumulationPlugin,
    KwargsHandler,
    MixedPrecisionPolicy,
    PrecisionType,
    ProjectConfiguration,
    RNGType,
    TelemetryConfig,
    TensorInformation,
    TensorParallelPlugin,
)
from .device import resolve_device
from .environment import parse_choice_from_env, parse_flag_from_env, patch_environment
from .operations import (
    broadcast,
    broadcast_object_list,
    gather,
    gather_object,
    pad_across_processes,
    recursively_apply,
    reduce,
    send_to_device,
)
from .random import set_seed, synchronize_rng_state, synchronize_rng_states

__all__ = [
    "DataLoaderConfiguration", "DistributedType", "FaultConfig", "FP8RecipeKwargs",
    "FSDPShardingStrategy", "FullyShardedDataParallelPlugin", "GatewayConfig",
    "GradientAccumulationPlugin", "KwargsHandler", "MixedPrecisionPolicy", "PrecisionType",
    "ProjectConfiguration", "RNGType", "TelemetryConfig", "TensorInformation",
    "TensorParallelPlugin", "resolve_device", "parse_choice_from_env", "parse_flag_from_env",
    "patch_environment", "broadcast", "broadcast_object_list", "gather", "gather_object",
    "pad_across_processes", "recursively_apply", "reduce", "send_to_device", "set_seed",
    "synchronize_rng_state", "synchronize_rng_states",
]
