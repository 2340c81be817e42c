"""ZeRO/FSDP over the ``fsdp`` mesh axis: the port's counterpart of
``accelerate_tpu/parallel/fsdp.py``, with the collectives GSPMD inserts in JAX written
out as autograd functions.

In JAX a ``NamedSharding`` over the fsdp axis makes XLA emit the FSDP schedule inside
the jitted step. Here every rank holds its pieces as plain tensors, and the train step
(``Accelerator.build_train_step``) moves them:

- ZeRO-3 (FULL_SHARD): a param split over fsdp is gathered where it is used
  (:func:`fsdp_gather`: all-gather forward, reduce-scatter of the gradient backward), so
  its gradient comes out of autograd as this rank's summed piece;
- ZeRO-2 (SHARD_GRAD_OP): params whole, each gradient reduce-scattered
  (:func:`reduce_scatter`) into this rank's piece, which the optimizer updates with its
  piece of the moments; the new params are all-gathered (:func:`all_gather`) in place;
- ZeRO-1: as ZeRO-2, with the accumulation buffers kept whole (a gradient that
  accumulates is averaged whole, and sliced at the apply).

The spec rules are the JAX package's. :func:`infer_fsdp_spec` shards the largest free
dim that divides by the fsdp size, composing with an existing (tensor-parallel) spec,
and leaves below ``min_weight_size`` elements replicated (FSDP's size-based auto-wrap);
:func:`get_fsdp_shardings` gives the param specs (fsdp added only at ZeRO-3),
:func:`get_zero_specs` the ZeRO-1/2 specs of the optimizer state. A spec here is a
``parallel.mesh.P``: the port's sharding is the spec and this rank's index.

Collectives run over an explicit process group (``None``: one rank, the identity), by a
route chosen before the call from the group's backend and where its ranks' tensors
live (:func:`collective_route`), each counted in :data:`STATS` with the bytes it moved:

- ``native``: NCCL, and gloo on CPU tensors, take ``all_gather_into_tensor``/
  ``reduce_scatter_tensor``;
- ``cuda_ipc``: a gloo group over CUDA tensors, whose ranks share one card (where
  NCCL refuses two ranks), exchanges them through device memory: each rank maps every
  other rank's staging buffer through CUDA IPC (made once per group), writes its piece
  into its own, and after a barrier copies the others' (the gather) or sums every
  rank's slice in rank order (the reduce-scatter). gloo itself stages CUDA tensors
  through host memory, at about 0.75 GB/s of all-reduce on an H100's host. A gloo group
  over CUDA tensors on several cards raises: NCCL is the backend there.
"""

from __future__ import annotations

import socket
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.constants import FSDP_AXIS
from ..utils.tree import tree_leaves
from .mesh import Mesh, P, spec_axes

__all__ = [
    "infer_fsdp_spec", "get_fsdp_shardings", "get_zero_specs", "shard_tree",
    "shard_params", "gather_full_params", "fsdp_gather", "reduce_scatter", "all_gather",
    "release_shared",
    "FsdpShard", "materialize", "gathers_fsdp_shards", "STATS", "reset_stats",
    "collective_route",
]


# ------------------------------------------------------------------------------- specs
def infer_fsdp_spec(shape: tuple, fsdp_size: int, min_weight_size: int = 2**10,
                    existing_spec: Optional[P] = None) -> P:
    """Which dim of a leaf of ``shape`` to shard over the fsdp axis: the largest one
    divisible by ``fsdp_size`` that no other axis shards (the first free slot of
    ``existing_spec``); small or indivisible leaves keep ``existing_spec`` (or none)."""
    if fsdp_size <= 1 or int(np.prod(shape)) < min_weight_size:
        return existing_spec if existing_spec is not None else P()
    base = list(existing_spec) if existing_spec is not None else [None] * len(shape)
    for entry in base:
        if FSDP_AXIS in spec_axes(entry):
            return P(*base)
    while len(base) < len(shape):
        base.append(None)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if base[i] is None and shape[i] % fsdp_size == 0:
            base[i] = FSDP_AXIS
            return P(*base)
    return P(*base) if existing_spec is not None else P()


def _plugin(plugin):
    if plugin is None:
        from ..utils.dataclasses import FullyShardedDataParallelPlugin

        plugin = FullyShardedDataParallelPlugin()
    return plugin


def _map_specs(fn, params: Any, specs: Any) -> Any:
    from .tp import map_with_specs

    return map_with_specs(fn, params, specs)


def get_fsdp_shardings(params: Any, mesh: Optional[Mesh], plugin=None, specs: Any = None) -> Any:
    """The spec tree of a (whole) param tree: ``specs`` (the model's tensor-parallel
    plan, or none) with the fsdp axis added by :func:`infer_fsdp_spec` when the plugin
    shards params (ZeRO-3; no plugin: the default, FULL_SHARD, as in JAX)."""
    plugin = _plugin(plugin)
    fsdp_size = mesh.shape[FSDP_AXIS] if mesh is not None and plugin.shards_params else 1
    return _map_specs(lambda leaf, spec: infer_fsdp_spec(
        tuple(leaf.shape), fsdp_size, plugin.min_weight_size, existing_spec=spec),
        params, specs)


def get_zero_specs(tree: Any, mesh: Optional[Mesh], plugin=None, specs: Any = None) -> Any:
    """The ZeRO-1/2 spec tree of any state tree of whole leaves (the optimizer state's
    and the gradients'): the fsdp axis on the free dims of each leaf's existing spec
    (``specs``), whatever the plugin's ``shards_params``."""
    plugin = _plugin(plugin)
    fsdp_size = 1 if mesh is None else mesh.shape[FSDP_AXIS]
    return _map_specs(lambda leaf, spec: infer_fsdp_spec(
        tuple(leaf.shape), fsdp_size, plugin.min_weight_size, existing_spec=spec),
        tree, specs)


def shard_tree(tree: Any, mesh: Optional[Mesh], specs: Any) -> Any:
    """This rank's piece of every leaf of ``tree`` under ``specs`` (copies; a leaf that
    no axis splits comes back as it is)."""
    from .tp import local_shard

    return _map_specs(lambda leaf, spec: local_shard(leaf, spec, mesh), tree, specs)


def _log_sharding_summary(params: Any, specs: Any, mesh: Optional[Mesh]) -> None:
    """How many bytes got partitioned and how many stay replicated (small or
    indivisible leaves), logged once per placement."""
    from ..logging import get_logger
    from .tp import spec_is_sharded

    sharded = replicated = n_repl = 0
    for leaf, spec in zip(tree_leaves(params), tree_leaves(_map_specs(
            lambda leaf, spec: spec if spec is not None else P(), params, specs))):
        nbytes = int(np.prod(tuple(leaf.shape))) * _itemsize(leaf)
        if spec_is_sharded(spec, mesh):
            sharded += nbytes
        else:
            replicated += nbytes
            n_repl += 1
    if mesh is not None and (sharded or replicated):
        get_logger(__name__).info(
            f"param sharding over mesh {mesh.shape}: {sharded / 2**20:.1f} MiB partitioned, "
            f"{replicated / 2**20:.1f} MiB replicated ({n_repl} leaves stay replicated — "
            "small or indivisible)")


def _itemsize(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.element_size()
    return np.dtype(getattr(leaf, "dtype", np.float32)).itemsize


def shard_params(params: Any, mesh: Optional[Mesh], plugin=None, specs: Any = None) -> tuple:
    """``(this rank's pieces, the spec tree)`` of a whole param tree under
    :func:`get_fsdp_shardings` (the ``prepare_model`` counterpart; the caller casts and
    places the pieces)."""
    full_specs = get_fsdp_shardings(params, mesh, plugin, specs)
    _log_sharding_summary(params, full_specs, mesh)
    return shard_tree(params, mesh, full_specs), full_specs


def gather_full_params(params: Any, mesh: Optional[Mesh], specs: Any) -> Any:
    """The whole leaves on the host (CPU tensors) from every rank's pieces under
    ``specs`` (a collective over each sharded spec's axes: every rank calls it)."""
    from ..utils.tree import tree_map
    from .tp import gather_tensor_parallel

    if mesh is not None and specs is not None:
        params = gather_tensor_parallel(params, mesh, specs)
    return tree_map(lambda x: x.detach().cpu() if torch.is_tensor(x) else x, params)


# -------------------------------------------------------------------------- collectives
#: Calls and bytes of each collective route since :func:`reset_stats` (the bytes are a
#: rank's input to the collective: a gathered piece, a gradient before its scatter).
STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()
    for op in ("all_gather", "reduce_scatter"):
        for route in ("", "_via_cuda_ipc"):
            STATS[op + route] = 0
            STATS[op + route + "_bytes"] = 0
    STATS["cuda_ipc_setup_s"] = 0.0  # mapping a group's buffers (once a group)


reset_stats()

#: The most bytes of each rank's CUDA IPC staging buffer (a collective moves larger
#: tensors in pieces of this size); a group's buffers start at IPC_MIN_BYTES and grow,
#: by powers of two, to the largest piece its collectives move.
IPC_BUFFER_BYTES, IPC_MIN_BYTES = 2 << 30, 1 << 20
_ONE_CARD: dict = {}  # (group, device) -> whether every rank of the group is on it
_SHARED: dict = {}  # (group, device) -> _SharedBuffers


def release_shared() -> None:
    """Drop every group's CUDA IPC staging buffers and this rank's mappings of the
    other ranks' (no collective: each rank drops its own, after the last collective's
    fence). Called when the process mesh goes (``AcceleratorState._reset_state``,
    ``destroy_process_group``); a later collective maps new buffers."""
    _SHARED.clear()
    _ONE_CARD.clear()


def collective_route(group, t: torch.Tensor) -> str:
    """The route of a collective over ``group`` on ``t``: ``native`` for NCCL and for
    gloo on CPU tensors, ``cuda_ipc`` for gloo on CUDA tensors, whose ranks must share
    this card (the first such call on a group is itself a collective: the ranks tell
    each other their card)."""
    if dist.get_backend(group) != "gloo" or t.device.type != "cuda":
        return "native"
    key = (group, t.device)
    if key not in _ONE_CARD:
        card = (socket.gethostname(), str(torch.cuda.get_device_properties(t.device).uuid))
        cards = [None] * dist.get_world_size(group)
        dist.all_gather_object(cards, card, group=group)
        _ONE_CARD[key] = all(c == card for c in cards)
    if not _ONE_CARD[key]:
        raise NotImplementedError(
            "fsdp collectives of a gloo group over CUDA tensors need its ranks on one card; "
            "ranks on several cards take the nccl backend")
    return "cuda_ipc"


class _SharedBuffers:
    """One staging buffer a rank on the group's card, each mapped into every rank of
    the group through CUDA IPC (a collective: made at the group's first such call)."""

    def __init__(self, group, device, nbytes: int):
        from torch.multiprocessing.reductions import reduce_tensor

        t0 = time.perf_counter()
        self.group, self.device, self.nbytes = group, device, nbytes
        self.rank, self.n = dist.get_rank(group), dist.get_world_size(group)
        self.own = torch.empty(nbytes, dtype=torch.uint8, device=device)
        handles = [None] * self.n
        dist.all_gather_object(handles, reduce_tensor(self.own), group=group)
        self.bufs = [self.own if r == self.rank else fn(*args)
                     for r, (fn, args) in enumerate(handles)]
        STATS["cuda_ipc_setup_s"] += time.perf_counter() - t0

    def fence(self) -> None:
        """This rank's copies done, then every rank's: a buffer is read only after its
        owner wrote it, and written again only after every reader is done."""
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)


def _shared(group, device, need: int) -> _SharedBuffers:
    """The group's buffers, of ``need`` bytes at least (at most IPC_BUFFER_BYTES): made
    or grown here, a collective (every rank of the group asks for the same ``need``)."""
    key = (group, device)
    want = min(IPC_BUFFER_BYTES, max(IPC_MIN_BYTES, 1 << max(0, need - 1).bit_length()))
    sh = _SHARED.get(key)
    if sh is None or sh.nbytes < want:
        if sh is not None:
            sh.fence()  # no rank reads the old buffers any more
            del _SHARED[key], sh
        _SHARED[key] = _SharedBuffers(group, device, want)
    return _SHARED[key]


def _ipc_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` (contiguous, on the shared card)."""
    sh = _shared(group, x.device, x.numel() * x.element_size())
    out = torch.empty((sh.n, *x.shape), dtype=x.dtype, device=x.device)
    src, dst = x.reshape(-1).view(torch.uint8), out.view(sh.n, -1).view(torch.uint8)
    for start in range(0, src.numel(), sh.nbytes):
        n = min(sh.nbytes, src.numel() - start)
        sh.own[:n].copy_(src[start:start + n])
        sh.fence()
        for r, buf in enumerate(sh.bufs):
            dst[r, start:start + n].copy_(buf[:n])
        sh.fence()
    return out


def _ipc_reduce_scatter(rows: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks of row ``rank`` of every rank's ``rows``
    (``[n, k]``, contiguous, on the shared card), added in rank order."""
    sh = _shared(group, rows.device, rows.numel() * rows.element_size())
    k = rows.shape[1]
    out = torch.empty(k, dtype=rows.dtype, device=rows.device)
    step = sh.nbytes // (sh.n * rows.element_size())
    for start in range(0, k, step):
        m = min(step, k - start)
        staged = sh.own[:sh.n * m * rows.element_size()].view(rows.dtype).view(sh.n, m)
        staged.copy_(rows[:, start:start + m])
        sh.fence()
        for r, buf in enumerate(sh.bufs):
            mine = buf[:sh.n * m * rows.element_size()].view(rows.dtype).view(sh.n, m)[sh.rank]
            if r == 0:
                out[start:start + m].copy_(mine)
            else:
                out[start:start + m].add_(mine)
        sh.fence()
    return out


# torch 2.13 renamed the flat collectives (same arguments); older releases have only
# the first names.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _count(route: str, t: torch.Tensor) -> None:
    STATS[route] += 1
    STATS[route + "_bytes"] += t.numel() * t.element_size()


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from every rank's equal piece of it along ``dim`` (rank ``r``
    holding piece ``r``); ``x`` itself for a ``None`` group."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    x = x.contiguous()
    if collective_route(group, x) == "cuda_ipc":
        _count("all_gather_via_cuda_ipc", x)
        out = _ipc_all_gather(x, group)
    else:
        _count("all_gather", x)
        out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
        _ALL_GATHER(out, x.reshape(-1), group=group)
        out = out.view(n, *x.shape)
    if dim == 0:
        return out.reshape(n * x.shape[0], *x.shape[1:])
    return torch.cat(out.unbind(0), dim=dim)


def reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's piece along ``dim`` of the sum over ``group`` of every rank's whole
    ``g`` (piece ``r`` to rank ``r``); ``g`` itself for a ``None`` group."""
    if group is None:
        return g
    n = dist.get_world_size(group)
    if g.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {g.shape[dim]} does not split over {n} ranks")
    shape = list(g.shape)
    shape[dim] //= n
    rows = (g.contiguous() if dim == 0 else
            torch.stack([c.contiguous() for c in g.chunk(n, dim)])).reshape(n, -1)
    if collective_route(group, g) == "cuda_ipc":
        _count("reduce_scatter_via_cuda_ipc", rows)
        return _ipc_reduce_scatter(rows, group).view(shape)
    _count("reduce_scatter", rows)
    out = torch.empty((rows.shape[1],), dtype=g.dtype, device=g.device)
    _REDUCE_SCATTER(out, rows.reshape(-1), op=dist.ReduceOp.SUM, group=group)
    return out.view(shape)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def fsdp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole leaf from this rank's piece ``x`` along ``dim``: all-gather forward,
    the gradient reduce-scattered (summed over ``group``) backward, so the piece's
    gradient is the sum of every rank's contribution to it."""
    return x if group is None else _FsdpGather.apply(x, dim, group)


# ------------------------------------------------------------------- leaves gathered late
class FsdpShard:
    """A param leaf left as this rank's piece for the model to gather where it uses it
    (:func:`materialize`): ``shard`` (the piece, in the autograd graph), ``dim`` and
    ``group``. The train step hands these to a loss marked by
    :func:`gathers_fsdp_shards` (``models.llama.loss_fn`` is)."""

    __slots__ = ("shard", "dim", "group")

    def __init__(self, shard: torch.Tensor, dim: int, group):
        self.shard, self.dim, self.group = shard, dim, group


def materialize(leaf, dtype: Optional[torch.dtype] = None):
    """The whole tensor of a leaf: an :class:`FsdpShard`'s piece cast to ``dtype`` (a
    floating piece, when given: the bytes gathered are the cast ones, as GSPMD gathers
    the converted operand) and gathered; any other leaf as it is."""
    if not isinstance(leaf, FsdpShard):
        return leaf
    x = leaf.shard
    if dtype is not None and x.is_floating_point() and x.dtype != dtype:
        x = x.to(dtype)
    return fsdp_gather(x, leaf.dim, leaf.group)


def gathers_fsdp_shards(fn):
    """Mark a loss ``fn(params, batch[, rng])`` as one that gathers :class:`FsdpShard`
    leaves itself (through :func:`materialize`, where it uses each); returns ``fn``."""
    fn.gathers_fsdp_shards = True
    return fn
