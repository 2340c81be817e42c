"""Nested-structure operations and host-level collectives: the port's counterpart of
``accelerate_tpu/utils/operations.py``.

Leaves are torch tensors or numpy arrays (a data loader's host batches are numpy until
they are placed). ``recursively_apply`` walks nested lists, tuples, named tuples and
mappings, keeping their types. The collectives run over ``torch.distributed`` (the
world group unless a ``group`` of the port's mesh is named) and are no-ops in one
process, where they return their input. Collective results are tensors on the input's
device (the JAX package returns numpy): ``gather`` concatenates every process's leaf
along dim 0, ``gather_object`` concatenates every process's list, ``reduce`` sums (or
averages) elementwise, ``broadcast``/``broadcast_object_list`` copy one process's
values to all, ``pad_across_processes`` pads each process's leaf to the largest size
along a dim. Under the ``gloo`` backend CUDA tensors travel through host memory.

With ``ACCELERATE_DEBUG_MODE=1`` every collective first gathers the operands' shapes and
raises :class:`DistributedOperationException` when the processes disagree
(``verify_operation``), turning a silent desync or hang into an error.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from .dataclasses import TensorInformation, parse_flag_from_env

__all__ = [
    "is_tensor", "is_namedtuple", "honor_type", "recursively_apply", "send_to_device",
    "get_data_structure", "get_shape", "initialize_tensors", "find_batch_size", "listify",
    "gather", "gather_object", "reduce", "broadcast", "broadcast_object_list",
    "pad_across_processes", "pad_input_tensors", "concatenate", "slice_tensors",
    "convert_to_fp32", "DistributedOperationException",
    "verify_operation",
]


def is_tensor(obj: Any) -> bool:
    return torch.is_tensor(obj) or isinstance(obj, np.ndarray)


def is_namedtuple(obj: Any) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields") and hasattr(obj, "_asdict")


def honor_type(obj, generator):
    """``generator``'s items in ``type(obj)`` (named tuples included)."""
    if is_namedtuple(obj):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def recursively_apply(func: Callable, data: Any, *args, test_type: Callable = is_tensor,
                      error_on_other_type: bool = False, **kwargs):
    """``func`` on every leaf of nested list/tuple/named tuple/Mapping structures that
    passes ``test_type``; other leaves pass through (or raise ``TypeError`` with
    ``error_on_other_type``)."""
    if isinstance(data, (tuple, list)):
        return honor_type(data, (recursively_apply(
            func, o, *args, test_type=test_type, error_on_other_type=error_on_other_type,
            **kwargs) for o in data))
    if isinstance(data, Mapping):
        return type(data)({k: recursively_apply(
            func, v, *args, test_type=test_type, error_on_other_type=error_on_other_type,
            **kwargs) for k, v in data.items()})
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(
            f"Unsupported type {type(data)} passed to {func.__name__}: only nested "
            "list/tuple/dicts of objects satisfying the test_type are supported.")
    return data


def _as_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def send_to_device(tensor, device, non_blocking: bool = False, skip_keys=None):
    """Every leaf as a tensor on ``device`` (numpy leaves become tensors); the values
    under a key named in ``skip_keys``, at any mapping level, are left as they are. A
    non-blocking copy from pageable host memory is synchronous: pin the source to
    overlap it."""
    if isinstance(skip_keys, str):
        skip_keys = [skip_keys]
    skip_keys = set(skip_keys or ())
    device = torch.device(device)

    def walk(obj):
        if isinstance(obj, (tuple, list)):
            return honor_type(obj, (walk(o) for o in obj))
        if isinstance(obj, Mapping):
            return type(obj)({k: (v if k in skip_keys else walk(v)) for k, v in obj.items()})
        if is_tensor(obj):
            return _as_tensor(obj).to(device, non_blocking=non_blocking)
        return obj

    return walk(tensor)


# ------------------------------------------------------------- structure (de)construction
def get_data_structure(data):
    """A tree of :class:`TensorInformation` (shape and dtype) leaves."""

    def info(t):
        t = _as_tensor(t)
        return TensorInformation(shape=tuple(t.shape), dtype=t.dtype)

    return recursively_apply(info, data)


def get_shape(data):
    return recursively_apply(lambda t: list(t.shape), data)


def initialize_tensors(data_structure):
    """Zeros (CPU tensors) shaped by a :func:`get_data_structure` result."""
    return recursively_apply(lambda info: torch.zeros(info.shape, dtype=info.dtype),
                             data_structure,
                             test_type=lambda o: isinstance(o, TensorInformation))


def find_batch_size(data) -> Optional[int]:
    """Dim 0 of the first leaf with at least one dim, or None."""
    if isinstance(data, (tuple, list)):
        for o in data:
            result = find_batch_size(o)
            if result is not None:
                return result
        return None
    if isinstance(data, Mapping):
        for v in data.values():
            result = find_batch_size(v)
            if result is not None:
                return result
        return None
    if is_tensor(data) and data.ndim > 0:
        return int(data.shape[0])
    return None


def listify(data):
    """Tensor leaves as plain (nested) Python lists."""
    return recursively_apply(lambda t: _as_tensor(t).tolist(), data)


# ----------------------------------------------------------------------------- collectives
def _world_size(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` contiguous on a device the group's backend reads: gloo takes CUDA
    tensors through host memory."""
    t = _as_tensor(t).contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def gather(tensor, group=None):
    """Every process's leaves concatenated along dim 0 (0-d leaves stacked); the leaves
    must have one shape on every process (:func:`pad_across_processes` first if not)."""

    def one(x):
        x = _as_tensor(x)
        if _world_size(group) == 1:
            return x
        t = _staged(x, group)
        parts = [torch.empty_like(t) for _ in range(_world_size(group))]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts) if t.dim() else torch.stack(parts)
        return out.to(x.device)

    with verify_operation("gather", tensor):
        return recursively_apply(one, tensor)


def gather_object(object: Any, group=None):
    """Each process passes a list; the result is the concatenation of every process's
    list (one process: ``object`` itself)."""
    n = _world_size(group)
    if n == 1:
        return object
    per_rank = [None] * n
    dist.all_gather_object(per_rank, object, group=group)
    return [x for y in per_rank for x in y]


def reduce(tensor, reduction: str = "mean", scale: float = 1.0, group=None):
    """Elementwise sum (``"sum"``) or mean (``"mean"``) of every process's leaves, times
    ``scale``."""

    def one(x):
        x = _as_tensor(x)
        if _world_size(group) == 1:
            return x * scale
        t = _staged(x, group).clone()
        dist.all_reduce(t, group=group)
        if reduction == "mean":
            t = t / _world_size(group)
        return (t * scale).to(x.device)

    with verify_operation("reduce", tensor):
        return recursively_apply(one, tensor)


def broadcast(tensor, from_process: int = 0, group=None):
    """Process ``from_process``'s leaves on every process (the leaves must have one
    shape and dtype everywhere)."""

    def one(x):
        x = _as_tensor(x)
        if _world_size(group) == 1:
            return x
        t = _staged(x, group).clone()
        dist.broadcast(t, src=from_process, group=group)
        return t.to(x.device)

    with verify_operation("broadcast", tensor):
        return recursively_apply(one, tensor)


def broadcast_object_list(object_list: list, from_process: int = 0, group=None) -> list:
    """``object_list`` overwritten in place by process ``from_process``'s (pickled)."""
    if _world_size(group) > 1:
        dist.broadcast_object_list(object_list, src=from_process, group=group)
    return object_list


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False,
                         group=None):
    """Each leaf padded with ``pad_index`` along ``dim`` to the largest size any process
    holds there (at the start with ``pad_first``)."""

    def one(x):
        x = _as_tensor(x)
        if x.dim() == 0 or _world_size(group) == 1:
            return x
        sizes = gather(torch.tensor([x.shape[dim]], device=x.device), group=group)
        max_size = int(sizes.max())
        if max_size == x.shape[dim]:
            return x
        shape = list(x.shape)
        shape[dim] = max_size - x.shape[dim]
        pad = torch.full(shape, pad_index, dtype=x.dtype, device=x.device)
        return torch.cat([pad, x] if pad_first else [x, pad], dim=dim)

    with verify_operation("pad_across_processes", tensor):
        return recursively_apply(one, tensor)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Leaves padded along ``dim`` to the next multiple of ``num_processes`` by repeating
    their last row (so a model's forward stays well defined)."""

    def one(x):
        if batch_size % num_processes == 0 or x.shape[dim] == 0:
            return x
        target = batch_size + num_processes - batch_size % num_processes
        t = _as_tensor(x)
        last = t.narrow(dim, t.shape[dim] - 1, 1)
        reps = [1] * t.dim()
        reps[dim] = target - t.shape[dim]
        out = torch.cat([t, last.repeat(*reps)], dim=dim)
        return out.numpy() if isinstance(x, np.ndarray) else out

    return recursively_apply(one, tensor)


def concatenate(data, dim: int = 0):
    """Leafwise concatenation of a list of structures (tensors; numpy leaves stay numpy
    when every part is numpy)."""
    if isinstance(data[0], (tuple, list)):
        return honor_type(data[0], (concatenate([d[i] for d in data], dim=dim)
                                    for i in range(len(data[0]))))
    if isinstance(data[0], Mapping):
        return type(data[0])({k: concatenate([d[k] for d in data], dim=dim)
                              for k in data[0].keys()})
    if not is_tensor(data[0]):
        raise TypeError(f"Can only concatenate tensors but got {type(data[0])}")
    if all(isinstance(d, np.ndarray) for d in data):
        return np.concatenate(data, axis=dim)
    return torch.cat([_as_tensor(d) for d in data], dim=dim)


def slice_tensors(data, tensor_slice):
    """``leaf[tensor_slice]`` for every leaf."""
    return recursively_apply(lambda x: x[tensor_slice], data)


# -------------------------------------------------------------------------- dtype conversion
def convert_to_fp32(tensor):
    """Half-precision (fp16, bf16) tensor leaves upcast to fp32; other leaves as they
    are."""
    return recursively_apply(
        lambda x: x.float(), tensor,
        test_type=lambda x: torch.is_tensor(x) and x.dtype in (torch.float16, torch.bfloat16))


# ------------------------------------------------------------------------------ debug mode
class DistributedOperationException(Exception):
    """Processes passed operands of different shapes to one collective."""


class _VerifyOperation:
    def __init__(self, operation: str, tensor):
        self.operation = operation
        self.tensor = tensor

    def __enter__(self):
        if _world_size() == 1 or not parse_flag_from_env("ACCELERATE_DEBUG_MODE"):
            return self
        all_shapes = gather_object([get_shape(self.tensor)])
        if not all(s == all_shapes[0] for s in all_shapes):
            raise DistributedOperationException(
                f"Mismatch in operands for `{self.operation}` across processes: "
                + "; ".join(f"process {i}: {s}" for i, s in enumerate(all_shapes)))
        return self

    def __exit__(self, *exc):
        return False


def verify_operation(operation: str, tensor) -> _VerifyOperation:
    """A context that, in debug mode (``ACCELERATE_DEBUG_MODE=1``) with several
    processes, raises :class:`DistributedOperationException` when the processes'
    operand shapes differ."""
    return _VerifyOperation(operation, tensor)
