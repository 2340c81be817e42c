"""The Accelerator facade and its train step: the port's counterpart of
``accelerate_tpu/accelerator.py`` for one process on one device.

    acc = Accelerator(mixed_precision="bf16")
    state = acc.create_train_state(params, fused_adamw(1e-4))
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    state, metrics = step(state, batch)        # grad accumulation and clipping inside

The JAX step is one jitted program with its state donated; here the step runs eagerly
and updates the state's tensors IN PLACE (params, optimizer moments, the accumulation
buffer), returning ``(state, metrics)`` all the same. The train state takes ownership of
the params it is given: they are not copied, and the step writes into them.
``jax.value_and_grad`` becomes ``torch.autograd.grad`` over detached views of the leaves.

Mixed precision follows the JAX step: with ``cast_params`` (the default) params are cast
to the compute dtype inside the step, so gradients and master weights stay fp32. Under
bf16 the policy's ``reduce_dtype`` equals the compute dtype, which selects the
``compress_reduce`` branch: gradients are taken w.r.t. the cast tree and upcast
afterwards (identical values; the cast copy is made without autograd).

Several processes (one per rank, e.g. from ``launchers.notebook_launcher``):
``Accelerator(mesh_config=MeshConfig(dp=..., tp=...))`` lays the ranks out on a process
mesh, and ``create_train_state(params, tx, partition_specs=llama.partition_specs(cfg))``
keeps each rank's tensor-parallel shard of every leaf. Every rank is given the whole
global batch (the JAX step's single-controller view) and the step, run under
``parallel.mesh.mesh_context``, takes the rank's slice over the batch axes ``(dp,
fsdp)``. Gradients are averaged over the batch ranks as they come out of autograd (in
the reduce dtype, as the JAX step reduces them), and so is the reported loss: a loss
that is a mean over the rank's examples (a plain ``.mean()``) gives the JAX step's
global mean, the slices being of one size. A loss whose mean is over tokens that the
slices hold in different numbers (``llama.loss_fn``'s masked mean) returns the global
value itself: it sums over the batch ranks with ``parallel.tp.replica_sum``, whose
gradient is scaled for that average. ``max_grad_norm`` clips by the global norm (the
squares of each tp-sharded leaf summed over tp, each replicated leaf counted once), and
the optimizer updates the local shards.

Training I/O: ``prepare`` takes data loaders (``data_loader.prepare_data_loader``: a
``DataLoaderShard`` placing batches on the device, sharded over the batch ranks of a
mesh and gathered back into the global batch the step slices) and stateful schedulers
(``scheduler.AcceleratedScheduler``). ``save_state``/``load_state`` write and restore a
verified checkpoint (``checkpointing``): the train state through a bounded host staging
buffer, loaded IN PLACE into the live state's tensors; with ``ProjectConfiguration``'s
automatic naming, rotation and the fallback to the newest valid checkpoint.
``register_for_checkpointing`` adds objects with ``state_dict``/``load_state_dict``.
``free_memory`` drops the prepared objects and releases ``llama.generate``'s caches (the
JAX package's ``jax.clear_caches()``).

A loss ``loss_fn(params, batch, rng)`` gets a ``torch.Generator`` on the state's device
per micro-step, seeded from (``TrainState.rng``, ``step * accumulation + micro``, and
the batch rank under a mesh): a different stream per micro-step that a resumed run
repeats. JAX folds the same count into a key: the draws match in distribution, not bit
for bit.

Serving: ``build_serving_gateway`` fronts one engine with a ``ServingGateway``, a list
with a ``FleetRouter``, or, when ``GatewayConfig.replica_roles`` is set, with a
``DisaggRouter`` (``Accelerator(gateway_config=...)`` or ``ACCELERATE_GATEWAY``),
sharing the accelerator's telemetry and threading a ``tracer`` through.

Telemetry (``telemetry_config`` or ``ACCELERATE_TELEMETRY``): ``self.telemetry`` is a
``telemetry.Telemetry``; enabled, every train step is bracketed and emits one fenced
step record (the fence waits on a ``torch.cuda.Event`` after the loss, never a copy of
it); disabled, a step pays two attribute reads. Fault injection (``fault_config`` or
``ACCELERATE_FAULTS``): ``self.fault_plan`` draws at ``train.step`` (``nonfinite``
poisons the batch's float leaves with NaN, ``error`` raises ``InjectedFault``,
``crash`` raises ``StageCrashed``); a skipped non-finite step emits a fault record.

The launcher's environment (``commands/launch.py``) is read as the JAX package reads
it: ``ACCELERATE_MIXED_PRECISION`` and ``ACCELERATE_GRADIENT_ACCUMULATION_STEPS`` when the
caller passes none, ``ACCELERATE_USE_CPU`` and ``ACCELERATE_DEBUG_MODE`` through
``state``.

Not ported yet (raise ``NotImplementedError``): fp8 (``mixed_precision="fp8"``),
optimizer/activation offload, ZeRO and every sharding plugin, trackers, the compile
cache, and training over quantized weight leaves (``ops.quantization.QuantizedWeight``:
QLoRA, a frozen int8 base under LoRA adapters). The launcher's variables that ask for
them (``ACCELERATE_USE_FSDP``, ``ACCELERATE_FSDP_*``, ``ACCELERATE_SP_MODE``,
``ACCELERATE_PP_*``, ``ACCELERATE_FP8_*``, ``ACCELERATE_LOG_WITH``) raise too.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import os
from dataclasses import dataclass, replace as dataclass_replace
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .data_loader import (DataLoaderDispatcher, DataLoaderShard, prepare_data_loader,
                          skip_first_batches)
from .ops.quantization import QuantizedWeight
from .optimizer import AcceleratedOptimizer
from .parallel.mesh import mesh_batch_size_divisor, mesh_context
from .parallel.tp import all_reduce, apply_tensor_parallel, split_dims
from .resilience.faults import NonFiniteStepError, StageCrashed
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.constants import BATCH_AXES, TENSOR_AXIS
from .telemetry import FAULT_SCHEMA, Telemetry
from .utils.dataclasses import (
    DataLoaderConfiguration,
    FaultConfig,
    GatewayConfig,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    TelemetryConfig,
)
from .utils.environment import parse_choice_from_env, parse_flag_from_env
from .utils.operations import (gather, gather_object, pad_across_processes, recursively_apply,
                               reduce)
from .utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["Accelerator", "TrainState", "NonFiniteStepError", "cast_floating", "micro_generator"]


def cast_floating(tree: Any, dtype) -> Any:
    """Cast floating leaves of a tree to ``dtype`` (ints/bools untouched)."""
    return tree_map(lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point()
                    else x, tree)


@dataclass
class TrainState:
    """The training carry: everything a train step reads and writes. ``step`` counts
    optimizer steps, ``micro`` the micro-steps since the last apply; ``grad_accum`` holds
    the running gradient sum between sync steps. ``rng`` is the int seed of an rng
    loss's generators (None: the loss gets None). ``tp_dims`` gives, per leaf of
    ``params`` in ``tree_leaves`` order, the dim along which the leaf is this rank's tp
    shard, or None where it is whole (from ``create_train_state``'s ``partition_specs``;
    None: every leaf whole); checkpoints record it, so ``merge-weights`` can put the
    halves back together."""

    params: Any
    opt_state: Any
    step: int = 0
    grad_accum: Any = None
    micro: int = 0
    tp_dims: Optional[list] = None
    rng: Optional[int] = None

    def replace(self, **kwargs) -> "TrainState":
        return dataclass_replace(self, **kwargs)


def _poison_float_leaves(batch):
    """Fault injection: every float leaf of a batch filled with NaN (integer token ids
    pass through: NaN has no integer spelling)."""
    def poison(leaf):
        if torch.is_tensor(leaf):
            return torch.full_like(leaf, float("nan")) if leaf.is_floating_point() else leaf
        arr = np.asarray(leaf)
        return np.full_like(arr, np.nan) if np.issubdtype(arr.dtype, np.floating) else leaf

    return tree_map(poison, batch)


def _refuse_quantized(params) -> None:
    """Training over quantized weight leaves (QLoRA) is not ported: raise."""
    if any(isinstance(leaf, QuantizedWeight) for leaf in tree_leaves(params)):
        raise NotImplementedError(
            "training over quantized weight leaves (QLoRA: a frozen int8 base under "
            "models/lora.py adapters) is not ported yet")


class _TrainStep:
    """Callable produced by ``Accelerator.build_train_step``: an accumulate-only and an
    accumulate+apply step, dispatched host-side from the accumulation counter."""

    def __init__(self, accelerator: "Accelerator", micro_fn, apply_fn, optimizer=None,
                 skip_nonfinite_steps: int = 0):
        self.accelerator = accelerator
        self.micro_fn = micro_fn
        self.apply_fn = apply_fn
        self.optimizer = optimizer
        self.skip_nonfinite_steps = skip_nonfinite_steps
        self.nonfinite_total = 0
        self.nonfinite_consecutive = 0

    def __call__(self, state: TrainState, batch) -> tuple[TrainState, Any]:
        acc = self.accelerator
        # Fault injection (disabled: one attribute read): ``nonfinite`` poisons the
        # batch (the real guard path), ``crash`` raises past the step boundary, any
        # other kind raises its InjectedFault.
        plan = acc.fault_plan
        if plan is not None:
            spec = plan.draw("train.step")
            if spec is not None:
                if spec.kind == "nonfinite":
                    batch = _poison_float_leaves(batch)
                elif spec.kind == "crash":
                    raise StageCrashed("train.step", gang_id=plan.scope or "gang0")
                else:
                    raise plan.fault_for(spec, "train.step")
        # Telemetry bracket: off, two attribute reads (no clock, no synchronization);
        # on, the record is fenced on the loss.
        tel = acc.telemetry
        tel_on = tel is not None and tel.enabled
        if tel_on:
            tel._step_begin()
        try:
            state, metrics = self._dispatch(acc, state, batch)
        except BaseException:
            if tel_on:
                tel._step_abort()  # a failed step must not leak the compile label
            raise
        if tel_on:
            tel._step_end(fence_on=metrics, batch=batch)
        if self.skip_nonfinite_steps:
            self._check_nonfinite(metrics)
        return state, metrics

    def _check_nonfinite(self, metrics) -> None:
        """One boolean read a guarded step: count skipped updates, emit a fault record
        for each, abort after the consecutive budget."""
        if not bool(metrics.get("nonfinite", False)):
            self.nonfinite_consecutive = 0
            return
        self.nonfinite_total += 1
        self.nonfinite_consecutive += 1
        acc = self.accelerator
        tel = acc.telemetry
        if tel is not None and tel.enabled:
            tel.emit({"schema": FAULT_SCHEMA, "site": "train.step", "kind": "nonfinite",
                      "step": acc.step, "consecutive": self.nonfinite_consecutive,
                      "total": self.nonfinite_total})
        if self.nonfinite_consecutive >= self.skip_nonfinite_steps:
            raise NonFiniteStepError(self.nonfinite_consecutive, self.nonfinite_total)

    def _dispatch(self, acc, state: TrainState, batch) -> tuple[TrainState, Any]:
        # From the state's micro count (not a host counter), so a resumed state keeps
        # its place in the accumulation window; the last batch of a prepared data loader
        # applies whatever was accumulated.
        gs = acc.gradient_state
        at_end = gs.sync_with_dataloader and gs.end_of_dataloader
        do_sync = (state.micro + 1) % acc.gradient_accumulation_steps == 0 or at_end
        gs._set_sync_gradients(do_sync)
        if do_sync:
            state, metrics = self.apply_fn(state, batch)
        else:
            state, metrics = self.micro_fn(state, batch)
        acc.step += 1
        if self.optimizer is not None:
            self.optimizer.step()
        return state, metrics


class _FusedTrainStep:
    """M train steps per call (``build_train_step(fused_steps=M)``): the JAX ``lax.scan``
    becomes a plain loop over M batches (a list, or a tree stacked on a leading M dim);
    metrics come back stacked [M, ...]."""

    def __init__(self, accelerator: "Accelerator", micro_fn, apply_fn, fused_steps: int,
                 optimizer=None, pad_grad_norm: bool = False):
        self.accelerator = accelerator
        self.micro_fn = micro_fn
        self.apply_fn = apply_fn
        self.fused_steps = fused_steps
        self.optimizer = optimizer
        self.pad_grad_norm = pad_grad_norm  # micro steps report a 0 norm, as JAX's do

    def _unstack(self, batches) -> list:
        if isinstance(batches, (list, tuple)):
            if len(batches) != self.fused_steps:
                raise ValueError(f"expected {self.fused_steps} batches, got {len(batches)}")
            return list(batches)
        for leaf in tree_leaves(batches):
            if np.ndim(leaf) < 1 or np.shape(leaf)[0] != self.fused_steps:
                raise ValueError(f"pre-stacked batch leaves must have leading dim "
                                 f"{self.fused_steps}, got shape {np.shape(leaf)}")
        return [tree_map(lambda x, i=i: x[i], batches) for i in range(self.fused_steps)]

    def __call__(self, state: TrainState, batches) -> tuple[TrainState, Any]:
        acc = self.accelerator
        accum = acc.gradient_accumulation_steps
        per_step = []
        unstacked = self._unstack(batches)
        tel = acc.telemetry
        tel_on = tel is not None and tel.enabled
        if tel_on:
            tel._step_begin()
        try:
            for batch in unstacked:
                if (state.micro + 1) % accum == 0:
                    state, metrics = self.apply_fn(state, batch)
                else:
                    state, metrics = self.micro_fn(state, batch)
                    if self.pad_grad_norm:
                        metrics["grad_norm"] = torch.zeros((), device=metrics["loss"].device)
                per_step.append(metrics)
        except BaseException:
            if tel_on:
                tel._step_abort()
            raise
        acc.step += self.fused_steps
        if self.optimizer is not None:
            self.optimizer._step_count += self.fused_steps // accum
        acc.gradient_state._set_sync_gradients(self.fused_steps % accum == 0)
        stacked = {k: torch.stack([torch.as_tensor(m[k]) for m in per_step])
                   for k in per_step[0] if k != "aux"}
        if "aux" in per_step[0]:
            stacked["aux"] = [m["aux"] for m in per_step]
        if tel_on:
            # One record a dispatch window of M steps.
            tel._step_end(fence_on=stacked, batch=unstacked[0], n_steps=self.fused_steps)
        return state, stacked


_UNPORTED_ARGS = (
    "fsdp_plugin", "tp_plugin", "pp_plugin", "sp_plugin", "ep_plugin", "megatron_lm_plugin",
    "log_with", "kwargs_handlers", "dynamo_plugin", "compile_cache_config",
)
#: The launcher's variables of features not ported yet (prefixes): a job that asks for
#: one fails here rather than training without it.
_UNPORTED_ENV = ("ACCELERATE_FSDP_", "ACCELERATE_SP_MODE", "ACCELERATE_PP_", "ACCELERATE_FP8_",
                 "ACCELERATE_LOG_WITH")


def _refuse_unported_env() -> None:
    asked = sorted(k for k, v in os.environ.items() if v and k.startswith(_UNPORTED_ENV))
    if parse_flag_from_env("ACCELERATE_USE_FSDP"):
        asked.insert(0, "ACCELERATE_USE_FSDP")
    if asked:
        raise NotImplementedError(
            f"the launcher asked for features that are not ported yet: {asked}")


class Accelerator:
    """One facade for device placement, precision, accumulation and the train step."""

    def __init__(
        self,
        device_placement: bool = True,
        split_batches: bool = False,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: Optional[int] = None,
        cpu: bool = False,
        device=None,
        max_grad_norm: Optional[float] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        mesh_config=None,
        backend: Optional[str] = None,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        rng_types: Optional[list] = None,
        project_dir: Optional[str] = None,
        project_config: Optional[ProjectConfiguration] = None,
        step_scheduler_with_optimizer: bool = True,
        gateway_config: Optional[GatewayConfig] = None,
        telemetry_config: Optional[TelemetryConfig] = None,
        fault_config: Optional[FaultConfig] = None,
        **kwargs,
    ):
        unported = sorted(k for k, v in kwargs.items() if v is not None)
        unknown = sorted(k for k in kwargs if k not in _UNPORTED_ARGS)
        if unknown:
            raise TypeError(f"Accelerator got unexpected arguments {unknown}")
        if unported or not device_placement:
            raise NotImplementedError(
                f"Accelerator arguments {unported or ['device_placement']} are not ported yet")
        _refuse_unported_env()
        if mixed_precision is None:
            mixed_precision = parse_choice_from_env("ACCELERATE_MIXED_PRECISION", "no")
        if mixed_precision == "fp8":
            raise NotImplementedError("mixed_precision='fp8' is not ported yet")
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu, device=device,
                                      mesh_config=mesh_config, backend=backend)
        if gradient_accumulation_plugin is None:
            # An explicit argument (1 included) wins over the launcher's variable.
            if gradient_accumulation_steps is None:
                env_steps = int(os.environ.get("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", "-1"))
                gradient_accumulation_steps = env_steps if env_steps > 0 else 1
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        self.rng_types = rng_types or ["generator"]
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        #: The serving gateway's configuration (``build_serving_gateway``).
        self.gateway_config = gateway_config if gateway_config is not None else GatewayConfig()
        self.step = 0
        self._max_grad_norm = max_grad_norm
        self._models: list = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list = []
        self._dataloaders: list = []
        self._custom_objects: list = []
        self._save_model_hooks: list[Callable] = []
        self._load_model_hooks: list[Callable] = []
        self.checkpoints_quarantined = 0
        #: The last save's and load's seconds and bytes (``checkpointing``).
        self.checkpoint_stats: dict = {"save": {}, "load": {}}
        self._ckpt_staging = None  # the checkpoint staging buffers, made at first use
        #: The step-level telemetry pipeline (off by default: two attribute reads a
        #: step, no file, no synchronization).
        self.telemetry = Telemetry(telemetry_config if telemetry_config is not None
                                   else TelemetryConfig())
        #: The deterministic fault plan (None unless fault injection is enabled).
        self.fault_plan = (fault_config if fault_config is not None
                           else FaultConfig()).build_plan()

    # ------------------------------------------------------------------------ properties
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mesh(self):
        """The process mesh (``parallel.mesh.Mesh``), or None in one process without a
        ``mesh_config``."""
        return self.state.mesh

    @property
    def distributed_type(self):
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def project_dir(self):
        return self.project_configuration.project_dir

    def wait_for_everyone(self) -> None:
        self.state.wait_for_everyone()

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def mixed_precision_policy(self) -> MixedPrecisionPolicy:
        return self.state.mixed_precision_policy

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int):
        self.gradient_state.plugin_kwargs.update({"num_steps": value})

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    # --------------------------------------------------------------------------- prepare
    def prepare(self, *args):
        """Prepare each object, preserving order: data loaders are sharded and place
        their batches on the device, transformations become ``AcceleratedOptimizer``s,
        stateful schedulers ``AcceleratedScheduler``s, param trees move to the device in
        the master dtype, anything else passes through."""
        result = tuple(self._prepare_one(obj) for obj in args)
        return result if len(result) > 1 else result[0]

    def _prepare_one(self, obj):
        if _is_dataloader_like(obj):
            return self.prepare_data_loader(obj)
        if isinstance(obj, AcceleratedOptimizer):
            if obj not in self._optimizers:
                self._optimizers.append(obj)
            return obj
        if hasattr(obj, "init") and hasattr(obj, "update") and not isinstance(obj, type):
            return self.prepare_optimizer(obj)
        if hasattr(obj, "step") and hasattr(obj, "state_dict") and not hasattr(obj, "update"):
            return self.prepare_scheduler(obj)
        if isinstance(obj, dict) and obj and all(torch.is_tensor(x) for x in tree_leaves(obj)):
            return self.prepare_params(obj)
        return obj

    def _batch_group(self):
        """The process group of this rank's batch ranks (None when there is one)."""
        mesh = self.mesh
        if mesh is None or mesh_batch_size_divisor(mesh) == 1:
            return None
        return mesh.group(BATCH_AXES)

    def prepare_data_loader(self, data_loader):
        """A ``DataLoaderShard`` (or ``DataLoaderDispatcher``) over ``data_loader``: each
        batch rank of the mesh loads its shard (the ranks of one tp group the same one),
        placed on the device and gathered into the global batch."""
        if isinstance(data_loader, (DataLoaderShard, DataLoaderDispatcher)):
            self._dataloaders.append(data_loader)
            return data_loader
        cfg, mesh = self.dataloader_config, self.mesh
        prepared = prepare_data_loader(
            data_loader, device=self.device,
            num_processes=1 if mesh is None else mesh_batch_size_divisor(mesh),
            process_index=0 if mesh is None else mesh.axis_index(BATCH_AXES),
            split_batches=cfg.split_batches, rng_types=self.rng_types,
            dispatch_batches=cfg.dispatch_batches, even_batches=cfg.even_batches,
            use_seedable_sampler=cfg.use_seedable_sampler, data_seed=cfg.data_seed,
            non_blocking=cfg.non_blocking, use_stateful_dataloader=cfg.use_stateful_dataloader,
            prefetch_depth=cfg.prefetch_depth, batch_group=self._batch_group())
        self._dataloaders.append(prepared)
        return prepared

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        wrapped = AcceleratedScheduler(scheduler, optimizers=self._optimizers,
                                       step_with_optimizer=self.step_scheduler_with_optimizer,
                                       split_batches=self.dataloader_config.split_batches)
        self._schedulers.append(wrapped)
        return wrapped

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches=num_batches)

    def prepare_params(self, params, partition_specs=None):
        """Params on the device with floating leaves in the policy's param dtype (fp32
        master weights); with ``partition_specs``, each leaf's shard on this rank of the
        mesh (sliced before it is moved or cast). A leaf already there is kept, not
        copied."""
        if partition_specs is not None:
            params = apply_tensor_parallel(params, self.mesh, partition_specs)
        dtype, dev = self.mixed_precision_policy.param_dtype, self.device
        return tree_map(lambda x: x.to(device=dev, dtype=dtype) if x.is_floating_point()
                        else x.to(dev), params)

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if isinstance(optimizer, AcceleratedOptimizer):
            if optimizer not in self._optimizers:
                self._optimizers.append(optimizer)
            return optimizer
        wrapped = AcceleratedOptimizer(optimizer)
        self._optimizers.append(wrapped)
        return wrapped

    def _to_device(self, batch):
        """Batch leaves (numpy arrays or tensors) as tensors on the device; under a mesh,
        this rank's slice of their leading (batch) dim over the batch axes."""
        mesh = self.mesh
        n = 1 if mesh is None else mesh_batch_size_divisor(mesh)

        def local(x):
            x = torch.as_tensor(x)
            if n > 1:
                if x.dim() == 0 or x.shape[0] % n:
                    raise ValueError(f"batch leaf of shape {tuple(x.shape)}: the global batch "
                                     f"must split over dp*fsdp = {n} ranks")
                k = x.shape[0] // n
                x = x[mesh.axis_index(BATCH_AXES) * k:][:k]
            return x.to(self.device)

        return tree_map(local, batch)

    def _mesh_context(self):
        return contextlib.nullcontext() if self.mesh is None else mesh_context(self.mesh)

    # -------------------------------------------------------------------- train state/step
    def create_train_state(self, params, optimizer: Union[AcceleratedOptimizer, Any],
                           rng: Optional[int] = None, partition_specs=None) -> TrainState:
        """The training carry: params prepared (master dtype, on the device; this rank's
        shards under ``partition_specs``), optimizer state initialized from them, an
        accumulation buffer when accumulating; ``rng`` seeds an rng loss's generators."""
        _refuse_quantized(params)
        if rng is not None and not isinstance(rng, (int, np.integer)):
            raise TypeError(f"rng must be an int seed, got {type(rng).__name__}")
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = self.prepare_optimizer(optimizer)
        params = self.prepare_params(params, partition_specs=partition_specs)
        opt_state = optimizer.init(params)
        accum = None
        if self.gradient_accumulation_steps > 1:
            accum = tree_map(torch.zeros_like, params)
        optimizer._opt_state_ref = opt_state
        tp_dims = (None if partition_specs is None
                   else split_dims(params, partition_specs, self.mesh))
        return TrainState(params=params, opt_state=opt_state, step=0, grad_accum=accum, micro=0,
                          tp_dims=tp_dims, rng=None if rng is None else int(rng))

    def build_train_step(
        self,
        loss_fn: Callable,
        optimizer: Optional[Union[AcceleratedOptimizer, Any]] = None,
        max_grad_norm: Optional[float] = None,
        max_grad_value: Optional[float] = None,
        has_aux: bool = False,
        fused_steps: int = 1,
        cast_params: bool = True,
        skip_nonfinite_steps: int = 0,
    ):
        """The training step: ``loss_fn(params, batch)`` (or ``loss_fn(params, batch,
        rng)``, ``rng`` a ``torch.Generator`` of the micro-step) returns a scalar loss, or
        ``(loss, aux)`` with ``has_aux``. Gradients are
        accumulated over ``gradient_accumulation_steps`` calls and averaged; at each sync
        step they are clamped to ``max_grad_value``, clipped to ``max_grad_norm`` (global
        norm; folded into the fused apply as a scale) and applied. ``cast_params=False``
        leaves the cast to the model (llama casts each weight at its use).
        ``skip_nonfinite_steps=K`` skips updates whose loss or gradients are not finite
        (a micro-step's contribution is zeroed) and raises :class:`NonFiniteStepError`
        after K consecutive ones. The step updates its state in place (the JAX step
        donates it)."""
        if skip_nonfinite_steps < 0:
            raise ValueError(f"skip_nonfinite_steps={skip_nonfinite_steps} must be >= 0 "
                             "(0 = off)")
        if skip_nonfinite_steps and fused_steps > 1:
            raise ValueError("skip_nonfinite_steps needs the per-step host check; use "
                             "fused_steps=1")
        if optimizer is None:
            if not self._optimizers:
                raise ValueError("No optimizer prepared; pass one to build_train_step.")
            optimizer = self._optimizers[-1]
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = self.prepare_optimizer(optimizer)
        tx = optimizer.optimizer
        policy = self.mixed_precision_policy
        max_grad_norm = self._max_grad_norm if max_grad_norm is None else max_grad_norm
        accum_steps = self.gradient_accumulation_steps
        wants_rng = _loss_fn_wants_rng(loss_fn)
        compress_reduce = (cast_params and policy.reduce_dtype is not None
                           and policy.reduce_dtype == policy.compute_dtype
                           and policy.compute_dtype != torch.float32)
        self._reduce_compressed = compress_reduce
        guard = skip_nonfinite_steps > 0
        mesh = self.mesh
        batch_group = None if mesh is None else mesh.group(BATCH_AXES)
        n_batch = 1 if batch_group is None else dist.get_world_size(batch_group)
        tp_group = None if mesh is None else mesh.group(TENSOR_AXIS)
        world_group = dist.group.WORLD if mesh is not None and mesh.size > 1 else None

        batch_rank = [] if n_batch == 1 else [mesh.axis_index(BATCH_AXES)]

        def call_loss(params, batch, state: TrainState):
            if wants_rng:
                rng = None if state.rng is None else micro_generator(
                    state.rng, state.step * accum_steps + state.micro, self.device, batch_rank)
                out = loss_fn(params, batch, rng)
            else:
                out = loss_fn(params, batch)
            loss, aux = out if has_aux else (out, None)
            # aux may view the params, which the apply then updates in place: snapshot it.
            aux = tree_map(lambda x: x.detach().clone() if torch.is_tensor(x) else x, aux)
            return loss.float(), aux

        def averaged(x, dtype=None):
            """``x`` averaged over the batch ranks: summed in its own type (in place),
            then divided by their number in ``dtype``."""
            x = all_reduce(x.contiguous(), "sum", batch_group).to(dtype or x.dtype)
            return x if n_batch == 1 else x.div_(n_batch)

        def compute(state: TrainState, batch):
            _refuse_quantized(state.params)
            batch = self._to_device(batch)
            masters = tree_leaves(state.params)
            with self._mesh_context():
                if compress_reduce:
                    # Gradients w.r.t. the cast tree, upcast afterwards: the backward of
                    # the cast IS that upcast, so the values are those of the plain branch.
                    with torch.no_grad():
                        cast = [p.to(policy.compute_dtype) for p in masters]
                    leaves = [c.requires_grad_(True) for c in cast]
                    del cast
                    loss, aux = call_loss(tree_unflatten(state.params, leaves), batch, state)
                    low = list(torch.autograd.grad(loss, leaves, allow_unused=True))
                    del leaves
                    grads = []
                    for i, p in enumerate(masters):
                        g = low[i]
                        low[i] = None  # free each low-precision gradient once upcast
                        grads.append(torch.zeros_like(p) if g is None
                                     else averaged(g, p.dtype))
                else:
                    leaves = [p.detach().requires_grad_(True) for p in masters]
                    tree = tree_unflatten(state.params, leaves)
                    if cast_params:
                        tree = cast_floating(tree, policy.compute_dtype)
                    loss, aux = call_loss(tree, batch, state)
                    grads = [torch.zeros_like(p) if g is None else averaged(g) for g, p in zip(
                        torch.autograd.grad(loss, leaves, allow_unused=True), masters)]
            return averaged(loss.detach().clone().reshape(1))[0], aux, grads

        def micro_step(state: TrainState, batch):
            loss, aux, grads = compute(state, batch)
            metrics = {"loss": loss}
            if guard:
                finite = _all_finite(loss, grads, world_group)
                metrics["nonfinite"] = not finite
                if not finite:  # a non-finite contribution would poison the window
                    grads = [torch.zeros_like(g) for g in grads]
            if state.grad_accum is None:
                accum = tree_unflatten(state.params, grads)
            else:
                accum = state.grad_accum
                with torch.no_grad():
                    for a, g in zip(tree_leaves(accum), grads):
                        a.add_(g)
            if has_aux:
                metrics["aux"] = aux
            return state.replace(grad_accum=accum, micro=state.micro + 1), metrics

        def apply_step(state: TrainState, batch):
            loss, aux, grads = compute(state, batch)
            with torch.no_grad():
                if state.grad_accum is not None:
                    grads = [a + g for a, g in zip(tree_leaves(state.grad_accum), grads)]
                if accum_steps > 1:
                    grads = [g / accum_steps for g in grads]
                metrics = {"loss": loss}
                finite = _all_finite(loss, grads, world_group) if guard else True
                fused_opt = getattr(tx, "fused_apply", None)
                grad_scale = None
                if max_grad_value is not None:
                    grads = [torch.clamp(g, -max_grad_value, max_grad_value) for g in grads]
                if max_grad_norm is not None:
                    gnorm = _global_norm(grads, state.tp_dims, tp_group)
                    scale = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                    metrics["grad_norm"] = gnorm
                    if fused_opt is None:
                        grads = [g * scale for g in grads]
                    else:
                        grad_scale = scale
                new_params, new_opt_state = state.params, state.opt_state
                if finite:
                    grad_tree = tree_unflatten(state.params, grads)
                    if fused_opt is not None:
                        new_params, new_opt_state = fused_opt(
                            grad_tree, state.opt_state, state.params,
                            grad_scale=1.0 if grad_scale is None else grad_scale)
                    else:
                        updates, new_opt_state = tx.update(grad_tree, state.opt_state,
                                                           state.params)
                        for p, u in zip(tree_leaves(state.params), tree_leaves(updates)):
                            p.copy_((p + u).to(p.dtype))
                del grads
                if state.grad_accum is not None:
                    for a in tree_leaves(state.grad_accum):
                        a.zero_()
            if has_aux:
                metrics["aux"] = aux
            if guard:
                metrics["nonfinite"] = not finite
            optimizer._opt_state_ref = new_opt_state
            return state.replace(params=new_params, opt_state=new_opt_state,
                                 step=state.step + (1 if finite else 0), micro=0), metrics

        if fused_steps > 1:
            if fused_steps % accum_steps:
                raise ValueError(f"fused_steps ({fused_steps}) must be a multiple of "
                                 f"gradient_accumulation_steps ({accum_steps})")
            return _FusedTrainStep(self, micro_step, apply_step, fused_steps, optimizer=optimizer,
                                   pad_grad_norm=max_grad_norm is not None)
        return _TrainStep(self, micro_step, apply_step, optimizer=optimizer,
                          skip_nonfinite_steps=skip_nonfinite_steps)

    def build_eval_step(self, eval_fn: Callable) -> Callable:
        """``eval_fn(params, batch) -> outputs`` under ``torch.no_grad`` with the params
        cast to the compute dtype; floating outputs cast to fp32 when the policy's
        output dtype is fp32. Under a mesh the function runs in its context on this
        rank's slice of the batch (outputs are the rank's own)."""
        policy = self.mixed_precision_policy

        def step(params, batch):
            with torch.no_grad(), self._mesh_context():
                out = eval_fn(cast_floating(params, policy.compute_dtype), self._to_device(batch))
                if policy.output_dtype == torch.float32:
                    out = cast_floating(out, torch.float32)
            return out

        return step

    # ------------------------------------------------------------------- collectives
    def gather(self, tensor):
        """Every batch rank's leaves concatenated along dim 0."""
        return gather(tensor, group=self._batch_group())

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """:meth:`gather`, then the duplicate tail of the data loader's last (padded)
        batch dropped: ``GradientState.remainder`` says how many samples are real."""
        try:
            recursively_apply(lambda x: x, input_data, error_on_other_type=True)
            all_tensors = True
        except TypeError:
            all_tensors = False
        group = self._batch_group()
        use_object = use_gather_object or not all_tensors
        data = (gather_object if use_object else gather)(input_data, group=group)
        remainder = self.gradient_state.remainder
        if self.gradient_state.end_of_dataloader and remainder > 0:
            try:
                return data[:remainder] if use_object else recursively_apply(
                    lambda t: t[:remainder], data)
            except (TypeError, IndexError):
                # An unsliceable payload (0-d tensors, objects without __getitem__)
                # comes back untrimmed.
                return data
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return reduce(tensor, reduction=reduction, scale=scale, group=self._batch_group())

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return pad_across_processes(tensor, dim=dim, pad_index=pad_index, pad_first=pad_first,
                                    group=self._batch_group())

    # ----------------------------------------------------------------------- checkpointing
    def register_for_checkpointing(self, *objects):
        """Objects with ``state_dict``/``load_state_dict`` saved and restored with the
        checkpoint (``custom_checkpoint_{i}.pkl``, in registration order)."""
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(
                f"Objects {invalid} lack state_dict/load_state_dict and cannot be registered.")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook: Callable):
        """``hook(models, train_state, output_dir)`` runs at the start of each save."""
        self._save_model_hooks.append(hook)
        return _RemovableHandle(self._save_model_hooks, hook)

    def register_load_state_pre_hook(self, hook: Callable):
        """``hook(models, train_state, input_dir)`` runs before each load restores state."""
        self._load_model_hooks.append(hook)
        return _RemovableHandle(self._load_model_hooks, hook)

    def save_state(self, output_dir: Optional[str] = None,
                   train_state: Optional[TrainState] = None, **save_kwargs) -> str:
        """``checkpointing.save_accelerator_state``; returns the checkpoint's path."""
        from .checkpointing import save_accelerator_state

        return save_accelerator_state(self, output_dir, train_state=train_state, **save_kwargs)

    def load_state(self, input_dir: Optional[str] = None,
                   train_state: Optional[TrainState] = None, **load_kwargs):
        """``checkpointing.load_accelerator_state``: ``train_state`` overwritten in place
        and returned with its counts restored."""
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir, train_state=train_state, **load_kwargs)

    def wait_for_checkpoint(self):
        """Join an in-flight ``save_state(async_save=True)`` and commit it."""
        from .checkpointing import wait_for_async_save

        return wait_for_async_save(self)

    def build_serving_gateway(self, engine, clock=None, tracer=None, engine_factory=None):
        """Front a ``serving.ContinuousBatcher`` with the request gateway of
        ``self.gateway_config``: a ``serving_gateway.ServingGateway`` for one engine; for
        a LIST of engine replicas a ``FleetRouter`` (health routing, per-replica
        breakers, failover; ``engine_factory(rid)`` builds restarts) or, when
        ``replica_roles`` is set, a ``DisaggRouter`` (prefill replicas export KV page
        handoffs, decode replicas adopt them). With the gateway disabled (the default)
        one engine comes back unchanged, and a list raises. The gateway shares this
        accelerator's telemetry; ``tracer`` (a ``telemetry.Tracer``) threads through the
        gateway and every engine that has none."""
        from .serving_gateway import DisaggRouter, FleetRouter, ServingGateway

        config = self.gateway_config
        is_fleet = isinstance(engine, (list, tuple))
        if not config.enabled:
            if is_fleet:
                raise ValueError(
                    "a fleet of engines needs the gateway enabled: there is no bare-engine "
                    "equivalent of a multi-replica router (set GatewayConfig(enabled=True) "
                    "or ACCELERATE_GATEWAY=1)")
            return engine
        kwargs = {} if clock is None else {"clock": clock}
        if is_fleet:
            router = DisaggRouter if config.replica_roles is not None else FleetRouter
            return router(list(engine), config, telemetry=self.telemetry, tracer=tracer,
                          engine_factory=engine_factory, **kwargs)
        return ServingGateway(engine, config, telemetry=self.telemetry, tracer=tracer,
                              **kwargs)

    def free_memory(self, *objects):
        """Drop the prepared objects and release device memory held outside them:
        ``llama.generate``'s caches and decode graphs, and the checkpoint staging
        buffers (the JAX package's ``jax.clear_caches()``). Returns ``objects``."""
        from .generation import release_generate_caches

        self.wait_for_checkpoint()
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self._ckpt_staging = None
        self.step = 0
        release_generate_caches()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return objects

    def clear(self, *objects):
        return self.free_memory(*objects)

    def __repr__(self):
        return (f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r}, "
                f"gradient_accumulation_steps={self.gradient_accumulation_steps})")


class _RemovableHandle:
    def __init__(self, container: list, item):
        self.container = container
        self.item = item

    def remove(self):
        if self.item in self.container:
            self.container.remove(self.item)


def _is_dataloader_like(obj) -> bool:
    if isinstance(obj, (DataLoaderShard, DataLoaderDispatcher, torch.utils.data.DataLoader)):
        return True
    return hasattr(obj, "__iter__") and (hasattr(obj, "batch_sampler") or hasattr(obj, "dataset"))


def micro_generator(seed: int, counter: int, device, extra=()) -> torch.Generator:
    """The ``torch.Generator`` an rng loss gets: on ``device``, seeded from ``seed``, the
    micro-step ``counter`` (``step * accumulation + micro``) and ``extra`` (the batch
    rank under a mesh), mixed by numpy's ``SeedSequence``."""
    mixed = np.random.SeedSequence([int(seed), int(counter), *extra]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def _loss_fn_wants_rng(loss_fn) -> bool:
    try:
        sig = inspect.signature(loss_fn)
    except (TypeError, ValueError):
        return False
    params = [p for p in sig.parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(params) >= 3 or "rng" in sig.parameters


def _all_finite(loss: torch.Tensor, grads, group=None) -> bool:
    """One host sync: loss and every gradient finite (on every rank of ``group``)."""
    finite = torch.isfinite(loss).all()
    for g in grads:
        finite = finite & torch.isfinite(g).all()
    return bool(all_reduce(finite.float().reshape(1), "min", group))


def _global_norm(grads, tp_dims=None, tp_group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32, summed leaf by leaf. Leaves
    with a ``tp_dims`` entry are this rank's tp shards: their squares are summed over
    ``tp_group``; the others are replicated and counted once."""
    sharded = [d is not None for d in tp_dims] if tp_dims else [False] * len(grads)
    squares = [torch.sum(torch.square(g.float())) for g in grads]
    zero = torch.zeros((), dtype=torch.float32, device=squares[0].device if squares else None)
    local = sum((q for q, s in zip(squares, sharded) if s), zero)
    replicated = sum((q for q, s in zip(squares, sharded) if not s), zero)
    if tp_group is None:
        return torch.sqrt(local + replicated)
    return torch.sqrt(all_reduce(local.reshape(1), "sum", tp_group)[0] + replicated)
