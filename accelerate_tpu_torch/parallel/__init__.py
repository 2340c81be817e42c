"""Parallelism over a process mesh: ``mesh`` (the mesh, its config and context, the
partition spec ``P``) and ``tp`` (tensor-parallel placement and collectives)."""

from .mesh import MeshConfig, Mesh, P, build_mesh, current_mesh, mesh_batch_size_divisor, mesh_context
from .tp import apply_tensor_parallel, gather_tensor_parallel, get_tp_plan, plan_from_rules, register_tp_plan

__all__ = [
    "MeshConfig", "Mesh", "P", "build_mesh", "current_mesh", "mesh_batch_size_divisor",
    "mesh_context", "apply_tensor_parallel", "gather_tensor_parallel", "get_tp_plan",
    "plan_from_rules", "register_tp_plan",
]
