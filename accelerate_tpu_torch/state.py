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
and ``ACCELERATE_MIXED_PRECISION`` is the precision when the caller passes none. ``AcceleratorState(mesh_config=...)``
lays the ranks out on a ``parallel.mesh.Mesh`` (also built, all-dp, when several
processes run without a config, as the JAX package always builds one); with one process
and no config there is no mesh. An fsdp plugin (``FullyShardedDataParallelPlugin``) is kept
as ``fsdp_plugin``; without a mesh config it lays several processes out by
``MeshConfig.from_plugins`` (the launcher's ``ACCELERATE_MESH_*`` then do not apply, as
in JAX), and a dp×fsdp mesh refines ``distributed_type`` to ``FSDP``. Each class keeps
the shared-dict singleton of the JAX package: every instance observes one state until
``_reset_state()``.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

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

    def wait_for_everyone(self) -> None:
        """Barrier across every process (a no-op in one process)."""
        if self.num_processes > 1:
            dist.barrier()

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
                 mesh_config=None, backend: Optional[str] = None, fsdp_plugin=None):
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
            if fsdp_plugin is not None and fsdp_plugin != self.fsdp_plugin:
                raise ValueError(
                    f"AcceleratorState already initialized with fsdp_plugin="
                    f"{self.fsdp_plugin}; cannot re-init with {fsdp_plugin}. Call "
                    "AcceleratorState._reset_state() first (tests).")
            return
        from .parallel.mesh import MeshConfig, build_mesh

        self._partial = PartialState(cpu=cpu, device=device, backend=backend)
        if mixed_precision is None:
            mixed_precision = parse_choice_from_env("ACCELERATE_MIXED_PRECISION", "no")
        self._mixed_precision = str(PrecisionType(mixed_precision))
        self.mixed_precision_policy = MixedPrecisionPolicy.from_precision(self._mixed_precision)
        self.fsdp_plugin = fsdp_plugin
        if mesh_config is None and fsdp_plugin is None:
            mesh_config = MeshConfig.from_env()
        if mesh_config is None and self._partial.num_processes > 1:
            mesh_config = (MeshConfig() if fsdp_plugin is None else
                           MeshConfig.from_plugins(fsdp_plugin=fsdp_plugin,
                                                   num_devices=self._partial.num_processes))
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
    optimizer-apply step), the accumulation plugin's settings, and the data loader being
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


def is_initialized() -> bool:
    """True once an ``AcceleratorState`` exists."""
    return AcceleratorState._shared_state != {}
