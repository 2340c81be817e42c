"""Parallelism over a process mesh: ``mesh`` (the mesh, its config and context, the
partition spec ``P``), ``tp`` (tensor-parallel placement and collectives) and ``fsdp``
(ZeRO/FSDP specs and collectives)."""

from .mesh import MeshConfig, Mesh, P, build_mesh, current_mesh, mesh_batch_size_divisor, mesh_context
from . import fsdp
from .fsdp import (gather_full_params, get_fsdp_shardings, get_zero_specs, infer_fsdp_spec,
                   shard_params)
from .tp import apply_tensor_parallel, gather_tensor_parallel, get_tp_plan, plan_from_rules, register_tp_plan

__all__ = [
    "fsdp", "infer_fsdp_spec", "get_fsdp_shardings", "get_zero_specs", "shard_params",
    "gather_full_params",
    "MeshConfig", "Mesh", "P", "build_mesh", "current_mesh", "mesh_batch_size_divisor",
    "mesh_context", "apply_tensor_parallel", "gather_tensor_parallel", "get_tp_plan",
    "plan_from_rules", "register_tp_plan",
]
