"""The process mesh: the port's counterpart of ``accelerate_tpu/parallel/mesh.py``.

In JAX one program drives every device through a named ``Mesh``. Here every process is
one rank of ``torch.distributed``, and :class:`Mesh` lays the ranks out over the six
axes ``(dp, fsdp, tp, sp, pp, ep)`` row-major, the last axis varying fastest, as the
JAX mesh lays out its devices (``np.array(devices).reshape(shape)``). It holds one
process group for each axis set a collective runs over: every axis of size > 1, and the
batch axes ``(dp, fsdp)`` together. An axis set of size 1 has no group (``None``), and
the port's collectives skip it, so a one-process mesh needs no process group at all.

- :class:`MeshConfig` — the axis sizes, one ``-1`` filling the rest, with the JAX
  package's validation errors; ``from_env`` reads ``ACCELERATE_MESH_*``;
  ``from_plugins`` derives the layout from the plugins (the fsdp plugin's ZeRO stage
  gives the fsdp axis every rank left after tp·pp·sp·ep; HYBRID shards within a node).
- :func:`build_mesh` — the mesh over the initialized ``torch.distributed`` world (or
  one process). Every rank must call it, in the same order: it creates the groups.
- :func:`mesh_context` / :func:`current_mesh` — the ambient mesh of a train step (the
  counterparts of ``mesh_context`` and ``current_abstract_mesh``); the model reads it to
  pick its tensor-parallel and batch collectives.
- :class:`P` — a ``PartitionSpec`` mirror: per dimension ``None``, an axis name or a
  tuple of axis names, so ``models.llama.partition_specs`` reads as in JAX.

Not ported: the multi-slice ``dcn_dp`` layout (``from_env`` accepts ``DCN_DP=1`` and
raises on more).
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Union

import torch.distributed as dist

from ..utils.constants import (
    BATCH_AXES,
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MESH_AXIS_NAMES,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    TENSOR_AXIS,
)

__all__ = ["MeshConfig", "Mesh", "P", "build_mesh", "mesh_context", "current_mesh",
           "mesh_batch_size_divisor", "spec_axes"]

Axes = Union[str, tuple]


class P(tuple):
    """A partition spec: one entry per dimension, ``None`` (replicated), an axis name or
    a tuple of axis names (sharded over their product, the first the slowest). A tree of
    specs keeps each ``P`` as one leaf (``utils/tree.py``)."""

    _tree_leaf = True

    def __new__(cls, *partitions):
        return super().__new__(cls, partitions)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry: ``None`` → ``()``, a name → ``(name,)``."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass
class MeshConfig:
    """Degrees of each parallelism axis. ``-1`` on exactly one axis means "fill the
    rest". The product of the sizes must equal the number of processes (after the
    ``-1`` is resolved); the defaults put every process on the data axis."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolved_sizes(self, num_devices: Optional[int] = None) -> dict[str, int]:
        if num_devices is None:
            num_devices = _world()[1]
        sizes = {
            DATA_AXIS: self.dp,
            FSDP_AXIS: self.fsdp,
            TENSOR_AXIS: self.tp,
            SEQUENCE_AXIS: self.sp,
            PIPELINE_AXIS: self.pp,
            EXPERT_AXIS: self.ep,
        }
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
        known_product = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if num_devices % known_product != 0:
                raise ValueError(
                    f"cannot fill axis {unknown[0]!r}: {num_devices} devices not divisible by "
                    f"product of fixed axes {known_product}"
                )
            sizes[unknown[0]] = num_devices // known_product
        elif known_product != num_devices:
            raise ValueError(
                f"mesh axis sizes {sizes} multiply to {known_product} but there are "
                f"{num_devices} devices"
            )
        return sizes

    @classmethod
    def from_env(cls) -> Optional["MeshConfig"]:
        """``ACCELERATE_MESH_{DP,FSDP,TP,SP,PP,EP,DCN_DP}``, or None when none is set
        (unset axes keep their defaults; ``-1`` keeps its meaning). ``DCN_DP`` of 1
        is the single-slice layout every mesh here has (as in JAX); a larger value raises
        ``NotImplementedError``: the multi-slice dp layout is not ported."""
        values = {}
        for field_name in ("dp", "fsdp", "tp", "sp", "pp", "ep", "dcn_dp"):
            raw = os.environ.get(f"ACCELERATE_MESH_{field_name.upper()}")
            if raw is not None:
                values[field_name] = int(raw)
        if not values:
            return None
        dcn_dp = values.pop("dcn_dp", 1)
        if dcn_dp > 1:
            raise NotImplementedError(
                f"ACCELERATE_MESH_DCN_DP={dcn_dp}: the multi-slice dp layout (dcn_dp > 1) "
                "is not ported")
        return cls(**values)

    @classmethod
    def from_plugins(cls, fsdp_plugin=None, tp_plugin=None, pp_plugin=None, sp_plugin=None,
                     ep_plugin=None, num_devices: Optional[int] = None) -> "MeshConfig":
        """The mesh of the active plugins (the JAX package's rule; a plugin is any object
        with the ``tp_size``/``pp_size``/``sp_size``/``ep_size`` attribute). The device
        count is the world size. With an fsdp plugin of ZeRO stage > 0, the fsdp axis
        takes every rank left after tp·pp·sp·ep; a HYBRID strategy shards within a node
        (``gcd(rest, LOCAL_WORLD_SIZE)``, the processes of one node standing for JAX's
        ``local_device_count``) and replicates across nodes over dp. Otherwise dp does."""
        cfg = cls(tp=tp_plugin.tp_size if tp_plugin else 1,
                  pp=pp_plugin.pp_size if pp_plugin else 1,
                  sp=sp_plugin.sp_size if sp_plugin else 1,
                  ep=ep_plugin.ep_size if ep_plugin else 1)
        if num_devices is None:
            num_devices = _world()[1]
        fixed = cfg.tp * cfg.pp * cfg.sp * cfg.ep
        if num_devices % fixed != 0:
            raise ValueError(
                f"tp*pp*sp*ep = {fixed} does not divide the {num_devices} available devices "
                f"(tp={cfg.tp}, pp={cfg.pp}, sp={cfg.sp}, ep={cfg.ep})")
        rest = num_devices // fixed
        if fsdp_plugin is not None and fsdp_plugin.zero_stage > 0:
            from ..utils.dataclasses import FSDPShardingStrategy

            if fsdp_plugin.sharding_strategy in (FSDPShardingStrategy.HYBRID_SHARD,
                                                 FSDPShardingStrategy.HYBRID_SHARD_ZERO2):
                local = max(1, int(os.environ.get("LOCAL_WORLD_SIZE") or num_devices))
                cfg.fsdp = math.gcd(rest, local)
                cfg.dp = rest // cfg.fsdp
            else:
                cfg.fsdp, cfg.dp = rest, 1
        else:
            cfg.dp, cfg.fsdp = rest, 1
        return cfg


def _world() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _axes(axes: Axes) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in MESH_AXIS_NAMES:
            raise ValueError(f"unknown mesh axis {a!r}: expected one of {MESH_AXIS_NAMES}")
    return axes


class Mesh:
    """This rank's place in the mesh and the process groups it belongs to.

    ``shape`` maps every axis name to its size (as the JAX ``mesh.shape``); ``coords``
    maps it to this rank's index. ``group(axes)`` is the process group of the ranks that
    share this rank's coordinates on every other axis (axes of size 1 left out; ``None``
    when none is left); ``axis_index(axes)`` is this rank's row-major index over
    ``axes``."""

    axis_names = MESH_AXIS_NAMES

    def __init__(self, sizes: dict, rank: int = 0, groups: Optional[dict] = None):
        self.shape = {name: int(sizes[name]) for name in MESH_AXIS_NAMES}
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        coords, rest = {}, rank
        for name in reversed(MESH_AXIS_NAMES):
            coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords = {name: coords[name] for name in MESH_AXIS_NAMES}
        self._groups = dict(groups or {})

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def axis_index(self, axes: Axes) -> int:
        index = 0
        for a in _axes(axes):
            index = index * self.shape[a] + self.coords[a]
        return index

    def ranks_along(self, axes: Axes) -> list:
        """The ranks sharing this rank's coordinates off ``axes``, in ``axis_index``
        order."""
        axes = _axes(axes)
        out = []
        for i in range(self.axis_size(axes)):
            coords, rest = dict(self.coords), i
            for a in reversed(axes):
                coords[a] = rest % self.shape[a]
                rest //= self.shape[a]
            out.append(self._rank_of(coords))
        return out

    def _rank_of(self, coords: dict) -> int:
        rank = 0
        for name in MESH_AXIS_NAMES:
            rank = rank * self.shape[name] + coords[name]
        return rank

    def group(self, axes: Axes):
        axes = tuple(a for a in _axes(axes) if self.shape[a] > 1)
        if not axes:
            return None
        if axes not in self._groups:
            raise ValueError(f"the mesh holds no process group over {axes}: build it with "
                             "build_mesh on every rank")
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank})"


def _group_axes(shape: dict) -> list:
    """The axis sets that get a process group: each axis of size > 1, the batch axes
    together when both are > 1, and ``(fsdp, tp)`` when both are > 1 (the ranks holding
    the pieces of a leaf split over both; ``Mesh.group`` drops axes of size 1)."""
    sets = [(name,) for name in MESH_AXIS_NAMES if shape[name] > 1]
    if all(shape[a] > 1 for a in BATCH_AXES):
        sets.append(BATCH_AXES)
    if shape[FSDP_AXIS] > 1 and shape[TENSOR_AXIS] > 1:
        sets.append((FSDP_AXIS, TENSOR_AXIS))
    return sets


def build_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of this rank over the ``torch.distributed`` world (one process when no
    group is initialized). Collective: every rank calls it, in the same order, since it
    creates one process group per partition of every axis set, member or not."""
    config = config or MeshConfig()
    rank, world = _world()
    sizes = config.resolved_sizes(world)
    probe = Mesh(sizes, 0)
    groups = {}
    for axes in _group_axes(probe.shape):
        for member in _partitions(probe, axes):
            group = dist.new_group(member)
            if rank in member:
                groups[axes] = group
    return Mesh(sizes, rank, groups)


def _partitions(mesh: Mesh, axes: tuple) -> list:
    """Every group of ranks along ``axes`` (one per coordinate of the other axes), each
    in ``axis_index`` order, in a fixed order."""
    seen, out = set(), []
    for r in range(mesh.size):
        ranks = tuple(Mesh(mesh.shape, r).ranks_along(axes))
        if ranks not in seen:
            seen.add(ranks)
            out.append(list(ranks))
    return out


_ACTIVE: list = []


@contextlib.contextmanager
def mesh_context(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh`` the ambient mesh inside the block (what the model's forward reads
    to pick its collectives)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Optional[Mesh]:
    """The innermost :func:`mesh_context`'s mesh, or None outside one."""
    return _ACTIVE[-1] if _ACTIVE else None


def mesh_batch_size_divisor(mesh: Mesh) -> int:
    """Global batch must be divisible by this (dp*fsdp)."""
    return mesh.shape[DATA_AXIS] * mesh.shape[FSDP_AXIS]
