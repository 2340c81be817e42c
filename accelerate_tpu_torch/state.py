"""Process and device state singletons (``PartialState``, ``AcceleratorState``,
``GradientState``): the port's counterpart of ``accelerate_tpu/state.py``.

One process: ``torch.distributed`` is not initialized, the world size is 1 and
``distributed_type`` is ``NO``. Several processes (``launchers.notebook_launcher``, or any
launcher that sets ``RANK``/``WORLD_SIZE`` and a rendezvous): ``PartialState`` joins the
process group (the counterpart of ``_maybe_init_distributed``), with an explicit
backend — ``nccl`` for CUDA ranks and ``gloo`` for CPU ranks unless the caller names one
(``backend="gloo"`` where ranks share a card). The device is CUDA unless the caller asks
for the CPU (``cpu=True`` or ``device="cpu"``); with several NCCL ranks it defaults to
``cuda:LOCAL_RANK``; without CUDA and without that request, construction raises; a
re-init that asks for another device raises too. The launcher's environment
(``utils/launch.py``) is read as the JAX package reads it: ``ACCELERATE_USE_CPU`` asks
for the CPU when the caller names no device, ``ACCELERATE_DEBUG_MODE`` sets ``debug``,
and ``ACCELERATE_MIXED_PRECISION`` is the precision when the caller passes none.

Process control (``main_process_first``, ``split_between_processes``, the ``on_*``
decorators, ``print``) follows the JAX package, with every rank a process: the local
index is ``LOCAL_RANK`` (JAX runs one process per host, so its local index is always 0),
so ``local_main_process_first`` orders the processes of a node, and
``split_between_processes`` hands back a tensor's slice as a tensor on its own device
(JAX turns any array into numpy). ``AcceleratorState(mesh_config=...)``
lays the ranks out on a ``parallel.mesh.Mesh`` (also built, all-dp, when several
processes run without a config, as the JAX package always builds one); with one process
and no config there is no mesh. An fsdp plugin (``FullyShardedDataParallelPlugin``) and a tp
plugin (``TensorParallelPlugin``) are kept as ``fsdp_plugin`` and ``tp_plugin``; without
a mesh config they lay several processes out by ``MeshConfig.from_plugins`` (the
launcher's ``ACCELERATE_MESH_*`` then do not apply, as in JAX), and a dp×fsdp mesh
refines ``distributed_type`` to ``FSDP``. A mesh config given beside a tp plugin must
have the plugin's tp size, or construction raises. Each class keeps
the shared-dict singleton of the JAX package: every instance observes one state until
``_reset_state()``.
"""

from __future__ import annotations

import builtins
import datetime
import functools
import os
from contextlib import contextmanager
from typing import Any, Callable, Optional

import numpy as np

import torch
import torch.distributed as dist

from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
)
from .utils.constants import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MESH_AXIS_NAMES,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    TENSOR_AXIS,
)
from .utils.device import resolve_device
from .utils.environment import parse_choice_from_env, parse_flag_from_env

__all__ = ["PartialState", "AcceleratorState", "GradientState", "is_initialized"]


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


class PartialState:
    """Singleton holding process/device topology and process control."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False, device=None, backend: Optional[str] = None,
                 init_method: Optional[str] = None, rank: Optional[int] = None,
                 world_size: Optional[int] = None, timeout_s: Optional[float] = None):
        self.__dict__ = self._shared_state
        if device is None and not cpu:
            cpu = parse_flag_from_env("ACCELERATE_USE_CPU")
        if self.initialized:
            self._check_device(cpu, device)
            return
        self.debug = parse_flag_from_env("ACCELERATE_DEBUG_MODE")
        self.fork_launched = parse_flag_from_env("FORK_LAUNCHED")
        if rank is None:
            rank = _env_int("RANK", 0)
        if world_size is None:
            world_size = _env_int("WORLD_SIZE", 1)
        self.local_process_index = _env_int("LOCAL_RANK", rank)
        if device is None and not cpu and world_size > 1 and backend in (None, "nccl"):
            device = f"cuda:{self.local_process_index}"  # one NCCL rank per card
        self.device = resolve_device("cpu" if cpu else device)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        if dist.is_available() and dist.is_initialized():
            world_size, rank = dist.get_world_size(), dist.get_rank()
            self.backend = dist.get_backend()
        elif world_size > 1:
            self.backend = backend or ("nccl" if self.device.type == "cuda" else "gloo")
            kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
            dist.init_process_group(self.backend, init_method=init_method or "env://",
                                    rank=rank, world_size=world_size, **kw)
        else:
            self.backend = None
        self.num_processes = world_size
        self.process_index = rank
        self.distributed_type = (DistributedType.MULTI_DEVICE if world_size > 1
                                 else DistributedType.NO)

    @property
    def initialized(self) -> bool:
        return self.__dict__.get("num_processes") is not None

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    @property
    def use_distributed(self) -> bool:
        """More than one process (each rank drives one device)."""
        return self.num_processes > 1

    def wait_for_everyone(self) -> None:
        """Barrier across every process (a no-op in one process)."""
        if self.num_processes > 1:
            dist.barrier()

    # ----------------------------------------------------------------- process control
    @contextmanager
    def main_process_first(self):
        """The main process runs the body first, then every other process."""
        with self._first(self.is_main_process):
            yield

    @contextmanager
    def local_main_process_first(self):
        """Each node's local main process (``LOCAL_RANK`` 0) runs the body first, then
        the node's other processes."""
        with self._first(self.is_local_main_process):
            yield

    @contextmanager
    def _first(self, first: bool):
        # Every process calls the barrier once: the others before the body, the first
        # after it.
        if not first:
            self.wait_for_everyone()
        try:
            yield
        finally:
            if first:
                self.wait_for_everyone()

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's contiguous share of ``inputs`` (a list, tuple, numpy array,
        tensor, or a dict of equal-length values, each split): the first ``len %
        num_processes`` processes take one element more. ``apply_padding`` pads the
        shorter shares, so every process gets as many: an array's or a tensor's with the
        global last element (an empty share too), a list's with its own last one. A
        tensor's share stays a tensor on its device, in its dtype."""
        if self.num_processes == 1:
            yield inputs
            return
        if isinstance(inputs, dict):
            lengths = {k: len(v) for k, v in inputs.items()}
            if len(set(lengths.values())) != 1:
                raise ValueError(f"all dict values must have equal length, got {lengths}")
            split = {}
            for key, value in inputs.items():
                with self.split_between_processes(value, apply_padding) as share:
                    split[key] = share
            yield split
            return
        yield _share(inputs, self.process_index, self.num_processes, apply_padding)

    def on_main_process(self, function: Callable) -> Callable:
        """``function`` run on the main process only (None elsewhere)."""
        return _only_if(lambda: self.is_main_process, function)

    def on_local_main_process(self, function: Callable) -> Callable:
        """``function`` run on each node's local main process only."""
        return _only_if(lambda: self.is_local_main_process, function)

    def on_process(self, function: Optional[Callable] = None,
                   process_index: Optional[int] = None):
        """``function`` run on process ``process_index`` only; without ``function``, the
        decorator for that process."""
        if function is None:
            return functools.partial(self.on_process, process_index=process_index)
        return _only_if(lambda: self.process_index == process_index, function)

    def on_last_process(self, function: Callable) -> Callable:
        """``function`` run on the last process only."""
        return _only_if(lambda: self.is_last_process, function)

    def print(self, *args, **kwargs) -> None:
        """``print`` on the main process only."""
        if self.is_main_process:
            builtins.print(*args, **kwargs)

    def destroy_process_group(self) -> None:
        """Leave the process group (a no-op when none is initialized), dropping the
        fsdp collectives' CUDA IPC buffers first."""
        from .parallel.fsdp import release_shared

        release_shared()
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()

    def _check_device(self, cpu: bool, device) -> None:
        """Raise when a re-init asks for another device than the state holds (``None``
        asks for CUDA, as on first init)."""
        if device is None and not cpu:
            cpu = parse_flag_from_env("ACCELERATE_USE_CPU")
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
    """PartialState + the mixed-precision policy + the process mesh."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None,
                 mesh_config=None, backend: Optional[str] = None, fsdp_plugin=None,
                 tp_plugin=None):
        self.__dict__ = self._shared_state
        if self.initialized:
            self._partial._check_device(cpu, device)
            if mixed_precision is not None and mixed_precision != self._mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with mixed_precision="
                    f"{self._mixed_precision!r}; cannot re-init with {mixed_precision!r}. "
                    "Call AcceleratorState._reset_state() first (tests) or create the "
                    "Accelerator once.")
            if mesh_config is not None and mesh_config != self.mesh_config:
                raise ValueError(
                    f"AcceleratorState already initialized with mesh_config="
                    f"{self.mesh_config}; cannot re-init with {mesh_config}. Call "
                    "AcceleratorState._reset_state() first (tests).")
            for name, plugin in (("fsdp_plugin", fsdp_plugin), ("tp_plugin", tp_plugin)):
                if plugin is not None and plugin != getattr(self, name):
                    raise ValueError(
                        f"AcceleratorState already initialized with {name}="
                        f"{getattr(self, name)}; cannot re-init with {plugin}. Call "
                        "AcceleratorState._reset_state() first (tests).")
            return
        from .parallel.mesh import MeshConfig, build_mesh

        partial = PartialState(cpu=cpu, device=device, backend=backend)
        if mixed_precision is None:
            mixed_precision = parse_choice_from_env("ACCELERATE_MIXED_PRECISION", "no")
        precision = str(PrecisionType(mixed_precision))
        # The layout is settled (and may raise) before anything is stored: a failed
        # construction leaves the state uninitialized.
        n = partial.num_processes
        tp_size = 1 if tp_plugin is None else tp_plugin.tp_size
        if mesh_config is None and fsdp_plugin is None and tp_plugin is None:
            mesh_config = MeshConfig.from_env()
        if mesh_config is None and (n > 1 or tp_size > 1):
            mesh_config = (MeshConfig() if fsdp_plugin is None and tp_plugin is None else
                           MeshConfig.from_plugins(fsdp_plugin=fsdp_plugin,
                                                   tp_plugin=tp_plugin, num_devices=n))
        elif tp_plugin is not None and mesh_config is not None:
            mesh_tp = mesh_config.resolved_sizes(n)[TENSOR_AXIS]
            if mesh_tp != tp_size:
                raise ValueError(f"mesh_config {mesh_config} disagrees with tp_plugin "
                                 f"{tp_plugin}: its tp axis is {mesh_tp}, the plugin's "
                                 f"tp_size {tp_size}")
        self._partial = partial
        self._mixed_precision = precision
        self.mixed_precision_policy = MixedPrecisionPolicy.from_precision(precision)
        self.fsdp_plugin = fsdp_plugin
        self.tp_plugin = tp_plugin
        self.mesh_config = mesh_config
        self.mesh = build_mesh(mesh_config) if mesh_config is not None else None
        self.distributed_type = self._refine_distributed_type()

    def _refine_distributed_type(self) -> DistributedType:
        """The JAX package's rule over the mesh's live axes."""
        if self.mesh is None:
            return self._partial.distributed_type
        active = {name for name in MESH_AXIS_NAMES if self.mesh.shape[name] > 1}
        if not active:
            return DistributedType.NO
        if active == {DATA_AXIS}:
            return DistributedType.MULTI_DEVICE
        if FSDP_AXIS in active and active <= {DATA_AXIS, FSDP_AXIS}:
            return DistributedType.FSDP
        if len(active) == 1:
            return {
                TENSOR_AXIS: DistributedType.TP,
                PIPELINE_AXIS: DistributedType.PP,
                SEQUENCE_AXIS: DistributedType.SP,
                EXPERT_AXIS: DistributedType.EP,
            }[next(iter(active))]
        return DistributedType.HYBRID

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
                f"device={self.device}, mesh={self.mesh})")

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = False) -> None:
        from .parallel.fsdp import release_shared

        release_shared()  # the mesh's groups go with the state
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()


class GradientState:
    """Gradient-accumulation bookkeeping singleton: ``sync_gradients`` (is this step an
    optimizer-apply step), the accumulation plugin's settings (``sync_each_batch``: every
    ``Accelerator.accumulate`` entry syncs), and the data loader being
    iterated: ``active_dataloader`` (the innermost one; a stack of references),
    ``in_dataloader``, and that loader's ``end_of_dataloader`` (known before its last
    batch is handed out) and ``remainder`` (the real samples of its last, padded global
    batch, or -1), which ``gather_for_metrics`` reads."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references = [None]
            self.plugin_kwargs = {}
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()

    @property
    def initialized(self) -> bool:
        return "sync_gradients" in self.__dict__

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps", 1)

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin_kwargs.get("adjust_scheduler", True)

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin_kwargs.get("sync_each_batch", False)

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        return self.active_dataloader.remainder if self.in_dataloader else -1

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    def _set_sync_gradients(self, sync_gradients: bool) -> None:
        self.sync_gradients = sync_gradients

    def _add_dataloader(self, dataloader) -> None:
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader) -> None:
        # A loader's generator may be closed after ``_reset_state`` (tests): start over.
        refs = self.__dict__.setdefault("dataloader_references", [None])
        if dataloader in refs:
            refs.remove(dataloader)
        self.active_dataloader = refs[-1]

    def __repr__(self) -> str:
        return (f"GradientState(sync_gradients={self.sync_gradients}, num_steps={self.num_steps}, "
                f"end_of_dataloader={self.end_of_dataloader}, remainder={self.remainder})")

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()


def _only_if(cond: Callable[[], bool], function: Callable) -> Callable:
    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        return function(*args, **kwargs) if cond() else None

    return wrapper


def _share(inputs, index: int, n: int, apply_padding: bool):
    """Process ``index``'s share of a sequence, array or tensor (``split_between_processes``)."""
    length = len(inputs)
    per, extra = divmod(length, n)
    start = index * per + min(index, extra)
    chunk = inputs[start:start + per + (1 if index < extra else 0)]
    if not apply_padding or length == 0:
        return chunk
    short = per + (1 if extra else 0) - len(chunk)
    if torch.is_tensor(chunk):
        if short <= 0:
            return chunk
        return torch.cat([chunk, inputs[-1:].expand(short, *chunk.shape[1:])])
    if hasattr(chunk, "shape"):  # any other array: numpy, as in JAX
        chunk = np.asarray(chunk)
        if short <= 0:
            return chunk
        fill = np.broadcast_to(np.asarray(inputs[-1:]), (short,) + chunk.shape[1:])
        return np.concatenate([chunk, fill], axis=0)
    chunk = list(chunk)  # padded with its own last element, or the global one when empty
    return chunk + [chunk[-1] if chunk else inputs[-1]] * max(short, 0)


def is_initialized() -> bool:
    """True once an ``AcceleratorState`` exists."""
    return AcceleratorState._shared_state != {}
