"""Tensor parallelism: the plan registry and the placement of params on a mesh (the
port's counterpart of ``accelerate_tpu/parallel/tp.py``), and the collectives that
GSPMD inserts in JAX, written out as autograd functions.

A plan maps a param tree to a tree of :class:`~.mesh.P` specs (``models.llama.
partition_specs``, a registered plan, or :func:`plan_from_rules`).
:func:`apply_tensor_parallel` gives each rank its contiguous shard of every leaf along
the spec's axes; :func:`gather_tensor_parallel` puts the shards back together. A spec
tree whose layer entry is one dict (the stacked ``scan_layers`` specs) applies to each
layer of a per-layer list with its leading entry dropped. A param spec may split a leaf
over ``tp`` and ``fsdp`` (both on one dim as ``(tp, fsdp)``: tp the outer index);
``apply_tensor_parallel(..., fsdp_plugin=)`` adds the fsdp axis on the first free dim
(``parallel/fsdp.py``). sp, pp and ep specs raise ``NotImplementedError``.

The collectives (Megatron's regions), each over an explicit process group; a ``None``
group is one rank, and every collective is then the identity:

- :func:`copy_to_group` — identity forward, all-reduce (sum) of the gradient: the input
  of a column-parallel product, replicated over the group;
- :func:`reduce_from_group` — all-reduce (sum) forward, identity backward: the output of
  a row-parallel product, a sum of the tp ranks' partials;
- :func:`replica_sum` — all-reduce (sum) forward, the gradient times the group's size:
  a sum over the batch (data-parallel) ranks inside a loss, whose gradients the train
  step then averages over those ranks;
- :func:`vocab_parallel_embedding` — the lookup into a vocab-sharded table: ids outside
  this rank's rows give zero rows, and the rows are summed over the group.

Every all-reduce runs in the tensor's own type (gloo and NCCL take fp32 and bf16 sums
and maxima); only one rank contributes a non-zero row to the embedding's sum, so that
sum is exact in any type.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.constants import FSDP_AXIS, TENSOR_AXIS
from ..utils.tree import tree_leaves
from .mesh import Mesh, P, spec_axes

__all__ = [
    "register_tp_plan", "get_tp_plan", "plan_from_rules", "apply_tensor_parallel",
    "gather_tensor_parallel", "map_with_specs", "local_shard", "spec_is_sharded",
    "all_reduce", "group_rank_size", "copy_to_group", "reduce_from_group",
    "replica_sum", "vocab_parallel_embedding", "split_dims", "gather_split_leaf",
]

_TP_PLANS: dict[str, Callable] = {}


def register_tp_plan(name: str, plan_fn: Callable) -> None:
    """Register ``plan_fn(params) -> spec tree`` under ``name``."""
    _TP_PLANS[name] = plan_fn


def get_tp_plan(name: str) -> Callable:
    if name not in _TP_PLANS:
        raise KeyError(f"No TP plan {name!r} registered; have {sorted(_TP_PLANS)}")
    return _TP_PLANS[name]


def plan_from_rules(rules: list) -> Callable:
    """A plan from ``(regex, spec)`` pairs matched against '/'-joined param paths (list
    entries by index); the first matching rule wins, an unmatched leaf is replicated."""

    def plan(params):
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + [str(k)]) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(c, path + [str(i)]) for i, c in enumerate(node))
            joined = "/".join(path)
            for pattern, spec in rules:
                if re.fullmatch(pattern, joined):
                    return spec
            return P(*([None] * np.ndim(node)))

        return walk(params, [])

    return plan


# --------------------------------------------------------------------------- placement
def _slices(shape, spec, mesh: Optional[Mesh]) -> tuple:
    """This rank's index along every dim of a leaf of ``shape`` under ``spec``."""
    spec = tuple(spec or ())
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the leaf's {len(shape)} dims")
    out = []
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        n = 1 if mesh is None or not axes else mesh.axis_size(axes)
        for a in axes:
            if mesh is not None and a not in (TENSOR_AXIS, FSDP_AXIS) and mesh.shape[a] > 1:
                raise NotImplementedError(
                    f"sharding a param over {a!r} (size {mesh.shape[a]}) is not ported: "
                    "sp, pp and ep specs come in a later slice")
        if n == 1:
            out.append(slice(None))
            continue
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of size {shape[dim]} does not split over {axes} "
                             f"({n} ranks)")
        k = shape[dim] // n
        i = mesh.axis_index(axes)
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


def local_shard(leaf, spec, mesh: Optional[Mesh]):
    """This rank's contiguous shard of ``leaf`` (a tensor or a numpy array) under
    ``spec``: a copy, so the full leaf can be freed; the leaf itself when unsharded."""
    idx = _slices(tuple(leaf.shape), spec, mesh)
    if all(s == slice(None) for s in idx):
        return leaf
    if torch.is_tensor(leaf):
        return leaf[idx].clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(leaf[idx])


def spec_is_sharded(spec, mesh: Optional[Mesh]) -> bool:
    """Whether ``spec`` splits a leaf over more than one rank of ``mesh``."""
    return mesh is not None and any(mesh.axis_size(spec_axes(e)) > 1 for e in (spec or ()))


def map_with_specs(fn: Callable, params: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over the leaves of ``params`` and the matching :class:`P` of
    ``specs`` (``None`` for a missing spec). A spec dict standing for a list of layers
    (the stacked ``scan_layers`` layout) applies to each layer, its leading entry
    dropped."""
    if isinstance(params, dict):
        specs = specs or {}
        return {k: map_with_specs(fn, v, specs.get(k)) for k, v in params.items()}
    if isinstance(params, (list, tuple)) and not isinstance(params, P):
        if isinstance(specs, dict):
            per_item = _unstack_specs(specs)
            return type(params)(map_with_specs(fn, c, per_item) for c in params)
        specs = specs if specs is not None else [None] * len(params)
        return type(params)(map_with_specs(fn, c, s) for c, s in zip(params, specs))
    return fn(params, specs)


def _unstack_specs(specs):
    if isinstance(specs, dict):
        return {k: _unstack_specs(v) for k, v in specs.items()}
    return P(*tuple(specs)[1:])


def apply_tensor_parallel(params: Any, mesh: Optional[Mesh], specs: Any = None,
                          plan: Optional[str] = None, fsdp_plugin=None) -> Any:
    """Each leaf's shard on this rank under ``specs`` (or a registered ``plan``'s
    specs), composed with fsdp as the JAX package composes it: the model's spec first,
    the fsdp axis on the first free dim (``fsdp.get_fsdp_shardings``; no plugin: the
    default FULL_SHARD, which adds nothing on a mesh without an fsdp axis). ``mesh``
    None is one rank: the leaves come back as they are."""
    from .fsdp import shard_params

    if specs is None:
        if plan is None:
            raise ValueError("Pass either a spec pytree or a registered plan name")
        specs = get_tp_plan(plan)(params)
    return shard_params(params, mesh, fsdp_plugin, specs)[0]


def gather_tensor_parallel(params: Any, mesh: Optional[Mesh], specs: Any) -> Any:
    """The full leaves from every rank's shards (collective over each sharded spec's
    axes: every rank calls it). Each rank writes its shard into a zero buffer of the
    full shape and the buffers are summed, which is exact and needs only all-reduce."""

    def gather(leaf, spec):
        if not spec_is_sharded(spec, mesh):
            return leaf
        full_shape = list(leaf.shape)
        axes = set()
        for dim, entry in enumerate(spec):
            names = spec_axes(entry)
            full_shape[dim] *= mesh.axis_size(names) if names else 1
            axes.update(names)
        buf = torch.zeros(full_shape, dtype=leaf.dtype, device=leaf.device)
        buf[_slices(tuple(full_shape), spec, mesh)] = leaf.detach()
        sharded = tuple(a for a in mesh.axis_names if a in axes)
        return all_reduce(buf, "sum", mesh.group(sharded))

    return map_with_specs(gather, params, specs)


# -------------------------------------------------------------------------- collectives
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def group_rank_size(group) -> tuple[int, int]:
    """(this rank's index in ``group``, the group's size); (0, 1) for ``None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` IN PLACE (``op`` ``sum``, ``max`` or ``min``) and
    returned; ``t`` itself for a ``None`` group. ``t`` must be contiguous."""
    if group is not None:
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), "sum", ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicaSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.size = dist.get_world_size(group)
        return all_reduce(x.clone(memory_format=torch.contiguous_format), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over ``group``) into a region each rank works on with its own
    shard: identity forward, the gradient summed over the group in the backward."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's partial ``x``: all-reduce forward, identity
    backward (each rank's partial gets the cotangent of the sum)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def replica_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the batch ranks of ``group`` of every rank's partial ``x``, inside a
    loss that returns the global value on every rank (``models.llama``'s masked mean).
    The train step averages gradients over the batch ranks, as is right for a loss that
    is a mean over this rank's examples; so each rank's partial gets the cotangent of
    the sum times the number of ranks, and the average is the global gradient."""
    return x if group is None else _ReplicaSum.apply(x, group)


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor, group,
                             dtype) -> torch.Tensor:
    """Rows of a vocab-sharded table ``[V/n, D]`` (rank r holds rows ``r·V/n ..``) for
    global ``ids``, in ``dtype``: ids outside this rank's rows give zero rows, then the
    rows are summed over ``group``."""
    rank, _ = group_rank_size(group)
    vl = table.shape[0]
    local = ids.long() - rank * vl
    hit = (local >= 0) & (local < vl)
    rows = torch.nn.functional.embedding(local.clamp(0, vl - 1), table).to(dtype)
    rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    return reduce_from_group(rows, group)


def split_dims(params: Any, specs: Any, mesh: Optional[Mesh], axis: str = TENSOR_AXIS) -> list:
    """Per leaf of ``params`` (in ``tree_leaves`` order), the dim its spec splits over
    the ``axis`` ranks of ``mesh`` (None: no rank of that axis holds a piece of it)."""
    def dim(leaf, spec):
        for d, entry in enumerate(spec or ()):
            if mesh is not None and axis in spec_axes(entry) and mesh.shape[axis] > 1:
                return d
        return -1  # not None: tree_leaves drops None

    return [None if d < 0 else d for d in tree_leaves(map_with_specs(dim, params, specs))]


def gather_split_leaf(leaf: torch.Tensor, dim: Optional[int], mesh: Optional[Mesh],
                      axis: str = TENSOR_AXIS):
    """The whole of a leaf split along ``dim`` over the ``axis`` ranks (a collective of
    that axis's group: every rank calls it); ``leaf`` itself when ``dim`` is None. A
    leaf split over ``(tp, fsdp)`` on one dim gathers over fsdp first (the inner
    index)."""
    if dim is None or mesh is None:
        return leaf
    n = mesh.axis_size(axis)
    full_shape = list(leaf.shape)
    full_shape[dim] *= n
    buf = torch.zeros(full_shape, dtype=leaf.dtype, device=leaf.device)
    k = leaf.shape[dim]
    i = mesh.axis_index(axis)
    buf.narrow(dim, i * k, k).copy_(leaf.detach())
    return all_reduce(buf, "sum", mesh.group(axis))
