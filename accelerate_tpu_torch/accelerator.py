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

fp8 (``mixed_precision="fp8"``, ``kwargs_handlers=[FP8RecipeKwargs(...)]``, or the
launcher's ``ACCELERATE_FP8_*``): the recipe becomes ``ops.fp8``'s process default (the
models' ``use_fp8`` projections read it). With ``use_delayed_scaling`` the train state
carries a ``DelayedScalingState`` (``TrainState.fp8_state``) and the step runs the loss
and its backward inside ``ops.fp8.autoscale_ctx`` with the history's scales (the grad
role's set to NaN: current scaling), then records the forward amaxes and a zero grad
amax; a skipped non-finite step keeps the old state. ``opt_level="O2"`` turns a
``FusedAdamW`` whose moment dtypes were left unset into one with scaled-fp8 moments
when it is prepared (other optimizers keep fp32 state, with a warning).

Frozen leaves: an optimizer with ``frozen_leaves(params)`` (``optim.multi_transform``
with ``set_to_zero`` groups: ``models/lora.lora_optimizer``) marks leaves that take no
update. The step takes no gradient for them (they never enter ``torch.autograd.grad``;
XLA drops their unused gradients under jit), they get no accumulation buffer, and
``create_train_state`` keeps them in the dtype they came in (a bf16 base stays bf16:
there is no master copy to keep for a leaf that never changes). The global norm of
``max_grad_norm`` is then that of the trainable leaves' gradients.

The launcher's environment (``commands/launch.py``) is read as the JAX package reads
it: ``ACCELERATE_MIXED_PRECISION`` and ``ACCELERATE_GRADIENT_ACCUMULATION_STEPS`` when the
caller passes none, ``ACCELERATE_USE_CPU`` and ``ACCELERATE_DEBUG_MODE`` through
``state``, ``ACCELERATE_FP8_*`` through ``FP8RecipeKwargs``.

ZeRO/FSDP (``fsdp_plugin=FullyShardedDataParallelPlugin(...)``, or the launcher's
``ACCELERATE_USE_FSDP``/``ACCELERATE_FSDP_*``; ``parallel/fsdp.py``): the ranks are laid
out by ``MeshConfig.from_plugins`` unless a mesh config is given, and ``prepare_params``
places each rank's pieces (the model's tp spec first, fsdp on the first free dim at
ZeRO-3; a mesh with an fsdp axis and no plugin takes the default FULL_SHARD, as in
JAX). ``TrainState.fsdp_dims`` records the dim each param is split along over fsdp,
``zero_dims`` the dim its optimizer state (and at ZeRO-2 its gradient and accumulation
buffer) is split along when the param itself is whole (ZeRO-1/2). The step gathers a
split param where it is used: a loss marked by ``parallel.fsdp.gathers_fsdp_shards``
(``models.llama.loss_fn`` is) gets ``FsdpShard`` leaves and gathers each layer inside
its remat unit; any other loss gets the whole tree gathered before the call (correct,
with the peak of the whole params). A split param's gradient comes out of the gather's
backward reduce-scattered over fsdp; it is then summed over dp and divided by dp·fsdp.
ZeRO-1/2 reduce-scatter a gradient (ZeRO-1 averages it whole while it accumulates),
update this rank's slice of each param (the fused AdamW kernel runs on the
slices, as on ZeRO-3's shards) and all-gather the new params in place. ``cpu_offload``
keeps the optimizer state and the accumulation buffers in host memory (pinned on
CUDA): ``FusedAdamW`` streams its moments through the card in fixed-size chunks
(``ops.fused_optim.FusedAdamW.fused_apply_offloaded``), any other optimizer fetches its
whole state for the apply and stores it back. ``get_state_dict`` gathers.

The user surface of HF Accelerate's loops (``accumulate``, ``no_sync``, ``autocast``,
``join_uneven_inputs``, ``clip_grad_norm_``/``clip_grad_value_``, ``value_and_grad``,
``set_trigger``/``check_trigger`` and the process control of ``state.PartialState``)
follows the JAX package: ``accumulate()`` decides on the host whether the next step
applies (every ``gradient_accumulation_steps``-th entry, at the end of a prepared data
loader, or every batch with ``sync_each_batch``), and a step built by
``build_train_step`` takes that decision while the context is open; ``no_sync()`` makes
every step inside it accumulate. ``clip_grad_*_`` record a limit that every step built
after the call reads (a step built before is not affected). ``backward`` raises: the
params are a tensor tree that the step's own optimizer updates, so a ``.grad`` that
``loss.backward()`` leaves would reach nothing; ``value_and_grad`` serves manual loops.
``tp_plugin=TensorParallelPlugin(tp_size=n)`` lays the ranks out on a tp axis of ``n``
(``MeshConfig.from_plugins``), as ``mesh_config=MeshConfig(tp=n)`` does.

Not ported yet (raise ``NotImplementedError``): activation offload, the pp/sp/ep and
Megatron plugins, the multi-slice ``dcn_dp`` layout, trackers, the compile cache, and
kwargs handlers other than ``FP8RecipeKwargs``. The launcher's variables that ask for
them (``ACCELERATE_SP_MODE``, ``ACCELERATE_PP_*``, ``ACCELERATE_LOG_WITH``) raise too. A
train state over quantized weight leaves raises as well: the JAX step cannot
differentiate them either (see ``_refuse_quantized``).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import inspect
import math
import os
import weakref
from dataclasses import dataclass, replace as dataclass_replace
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .data_loader import (DataLoaderDispatcher, DataLoaderShard, prepare_data_loader,
                          skip_first_batches)
from .ops.quantization import QuantizedWeight
from .optimizer import AcceleratedOptimizer
from .parallel.fsdp import (FsdpShard, all_gather, fsdp_gather, get_zero_specs,
                            reduce_scatter, shard_params)
from .parallel.mesh import mesh_batch_size_divisor, mesh_context, spec_axes
from .parallel.tp import all_reduce, split_dims
from .resilience.faults import NonFiniteStepError, StageCrashed
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.constants import BATCH_AXES, DATA_AXIS, FSDP_AXIS, PIPELINE_AXIS, TENSOR_AXIS
from .telemetry import FAULT_SCHEMA, Telemetry
from .utils.dataclasses import (
    DataLoaderConfiguration,
    FaultConfig,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GatewayConfig,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    TelemetryConfig,
    TensorParallelPlugin,
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
    halves back together. ``fsdp_dims`` (same order): the dim along which the leaf is
    this rank's fsdp piece (ZeRO-3, or a spec naming fsdp), its moments and
    accumulation buffer pieces alike; ``zero_dims``: the dim along which a whole leaf's
    optimizer state (and at ZeRO-2 its accumulation buffer) is this rank's slice
    (ZeRO-1/2). ``fp8_state`` is the ``ops.fp8.DelayedScalingState`` of a
    delayed-scaling fp8 recipe (None otherwise)."""

    params: Any
    opt_state: Any
    step: int = 0
    grad_accum: Any = None
    micro: int = 0
    tp_dims: Optional[list] = None
    rng: Optional[int] = None
    fp8_state: Any = None
    fsdp_dims: Optional[list] = None
    zero_dims: Optional[list] = None

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
    """A train state over quantized weight leaves raises, as in the JAX package."""
    if any(isinstance(leaf, QuantizedWeight) for leaf in tree_leaves(params)):
        raise NotImplementedError(
            "a train state over quantized weight leaves (QLoRA through the train state) "
            "is not supported: the JAX package cannot train one either (its step takes "
            "gradients of every leaf, and int8 leaves have none). Train adapters over an "
            "int8 base in the closure form: a train state of the adapters alone and a "
            "loss that closes over the frozen quantized base (gradients reach the "
            "adapters through quant_matmul's backward)")


class _Box:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _leaves_like(tree, like) -> list:
    """The leaves of ``tree`` at the positions of ``like``'s leaves (``tree_leaves``
    order), None where ``tree`` holds None."""
    return [box.value for box in tree_leaves(tree_map(lambda _, t: _Box(t), like, tree))]


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
        # Inside ``accumulate()``/``no_sync()`` the context has decided. Outside, from
        # the state's micro count (not a host counter), so a resumed state keeps its
        # place in the accumulation window; the last batch of a prepared data loader
        # applies whatever was accumulated.
        gs = acc.gradient_state
        if acc._in_accumulate_ctx:
            do_sync = gs.sync_gradients
        else:
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
    "pp_plugin", "sp_plugin", "ep_plugin", "megatron_lm_plugin",
    "log_with", "dynamo_plugin", "compile_cache_config",
)
#: The launcher's variables of features not ported yet (prefixes): a job that asks for
#: one fails here rather than training without it.
_UNPORTED_ENV = ("ACCELERATE_SP_MODE", "ACCELERATE_PP_", "ACCELERATE_LOG_WITH")


def _refuse_unported_env() -> None:
    asked = sorted(k for k, v in os.environ.items() if v and k.startswith(_UNPORTED_ENV))
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
        kwargs_handlers: Optional[list] = None,
        fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
        tp_plugin: Optional[TensorParallelPlugin] = None,
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
        #: The fp8 recipe (``FP8RecipeKwargs``), or None when fp8 is off.
        self.fp8_recipe = None
        for handler in kwargs_handlers or ():
            if not isinstance(handler, FP8RecipeKwargs):
                raise NotImplementedError(
                    f"kwargs handler {type(handler).__name__} is not ported yet "
                    "(FP8RecipeKwargs is)")
            self.fp8_recipe = handler
        if mixed_precision == "fp8" and self.fp8_recipe is None:
            self.fp8_recipe = FP8RecipeKwargs()
        if self.fp8_recipe is not None:
            # The process default every fp8_dot without an explicit format reads.
            from .ops.fp8 import set_default_recipe

            set_default_recipe(self.fp8_recipe.fp8_format, self.fp8_recipe.margin)
        if fsdp_plugin is None and parse_flag_from_env("ACCELERATE_USE_FSDP"):
            fsdp_plugin = FullyShardedDataParallelPlugin()
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu, device=device,
                                      mesh_config=mesh_config, backend=backend,
                                      fsdp_plugin=fsdp_plugin, tp_plugin=tp_plugin)
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
        self._max_grad_value: Optional[float] = None
        self._in_accumulate_ctx = False
        self._accumulate_count = 0
        #: ``set_trigger``'s flag on this process (None: not set since the last check).
        self.flag_tensor = None
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
        #: The spec tree and fsdp dims of the last ``prepare_params`` (None: whole leaves).
        self._param_specs = None
        # The last prepare_params' sharded layout: (its pieces' shapes, tp dims, fsdp
        # dims) per leaf; None when it placed every leaf whole.
        self._prepared_layout = None
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
    def fsdp_plugin(self) -> Optional[FullyShardedDataParallelPlugin]:
        return self.state.fsdp_plugin

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def project_dir(self):
        return self.project_configuration.project_dir

    # Pipeline parallelism is not ported (no pp plugin; the launcher's ACCELERATE_PP_*
    # raise): the pipeline settings are those of a mesh without a pipeline.
    @property
    def num_microbatches(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[PIPELINE_AXIS]

    @property
    def pp_schedule(self) -> str:
        return "gpipe"

    @property
    def virtual_stages(self) -> int:
        return 1

    # ------------------------------------------------------------------- process control
    def wait_for_everyone(self) -> None:
        self.state.wait_for_everyone()

    def print(self, *args, **kwargs) -> None:
        self.state.print(*args, **kwargs)

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.split_between_processes(inputs, apply_padding=apply_padding)

    def main_process_first(self):
        return self.state.main_process_first()

    def local_main_process_first(self):
        return self.state.local_main_process_first()

    def on_main_process(self, function: Callable) -> Callable:
        return self.state.on_main_process(function)

    def on_local_main_process(self, function: Callable) -> Callable:
        return self.state.on_local_main_process(function)

    def on_process(self, function: Optional[Callable] = None,
                   process_index: Optional[int] = None):
        return self.state.on_process(function, process_index=process_index)

    def on_last_process(self, function: Callable) -> Callable:
        return self.state.on_last_process(function)

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

    def prepare_params(self, params, partition_specs=None, frozen=None):
        """Params on the device with floating leaves in the policy's param dtype (fp32
        master weights); under a mesh, each leaf's piece on this rank (sliced before it
        is moved or cast): ``partition_specs`` (the model's tp plan) first, then the
        fsdp axis on the first free dim when the fsdp plugin shards params (ZeRO-3; a
        mesh with an fsdp axis and no plugin: the default FULL_SHARD). ``frozen`` (per
        leaf, ``tree_leaves`` order): leaves that keep their dtype. A leaf already
        there is kept, not copied."""
        mesh = self.mesh
        self._param_specs = partition_specs
        if mesh is not None and (partition_specs is not None or mesh.shape[FSDP_AXIS] > 1):
            params, self._param_specs = shard_params(params, mesh, self.fsdp_plugin,
                                                     partition_specs)
        self._prepared_layout = None if self._param_specs is None else (
            [tuple(x.shape) if torch.is_tensor(x) else None for x in tree_leaves(params)],
            split_dims(params, self._param_specs, mesh),
            split_dims(params, self._param_specs, mesh, FSDP_AXIS))
        dtype, dev = self.mixed_precision_policy.param_dtype, self.device
        leaves = tree_leaves(params)
        keep = frozen or [False] * len(leaves)
        return tree_unflatten(params, [
            x.to(device=dev, dtype=dtype) if x.is_floating_point() and not k else x.to(dev)
            for x, k in zip(leaves, keep)])

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if isinstance(optimizer, AcceleratedOptimizer):
            if optimizer not in self._optimizers:
                self._optimizers.append(optimizer)
            return optimizer
        wrapped = AcceleratedOptimizer(self._apply_fp8_opt_level(optimizer))
        self._optimizers.append(wrapped)
        return wrapped

    def _apply_fp8_opt_level(self, optimizer):
        """``FP8RecipeKwargs(opt_level="O2")``: a ``FusedAdamW`` whose moment dtypes were
        left unset stores both moments as scaled e4m3 (``ScaledAdamState``); explicit
        dtypes win, and other optimizers keep fp32 state (with a warning)."""
        recipe = self.fp8_recipe
        if recipe is None or recipe.opt_level != "O2":
            return optimizer
        from .ops.fused_optim import FusedAdamW

        if isinstance(optimizer, FusedAdamW):
            if optimizer.mu_dtype is None and optimizer.nu_dtype is None:
                return dataclass_replace(optimizer, mu_dtype=torch.float8_e4m3fn,
                                         nu_dtype=torch.float8_e4m3fn)
            return optimizer
        from .logging import get_logger

        get_logger(__name__).warning(
            "FP8RecipeKwargs(opt_level='O2') needs the fused optimizer "
            "(ops.fused_optim.fused_adamw) to carry low-precision moments; "
            f"{type(optimizer).__name__} keeps fp32 optimizer state.")
        return optimizer

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
        frozen = _frozen_leaves(optimizer.optimizer, params)
        params = self.prepare_params(params, partition_specs=partition_specs, frozen=frozen)
        specs, mesh, plugin = self._param_specs, self.mesh, self.fsdp_plugin
        _, tp_dims, fsdp_dims = self._prepared_layout or (None, None, None)
        zero_dims = None
        if (plugin is not None and plugin.shards_optimizer and not plugin.shards_params
                and mesh is not None and mesh.shape[FSDP_AXIS] > 1):
            # ZeRO-1/2: the optimizer state's specs from the whole leaves' shapes (as JAX
            # infers them on global arrays), composed with the params' own specs.
            whole = tree_unflatten(params, [
                torch.empty(_whole_shape(p, spec, mesh), device="meta")
                for p, spec in zip(tree_leaves(params), _spec_leaves(params, specs))])
            zspecs = get_zero_specs(whole, mesh, plugin, specs)
            zero_dims = [None if f or (fsdp_dims and fsdp_dims[i] is not None) else d
                         for i, (d, f) in enumerate(zip(
                             split_dims(whole, zspecs, mesh, FSDP_AXIS), frozen))]
        leaves = tree_leaves(params)
        # What the optimizer updates: a ZeRO-1/2 leaf's slice, every other leaf itself.
        own = tree_unflatten(params, [_zero_slice(p, d, mesh) for p, d in
                                      zip(leaves, zero_dims or [None] * len(leaves))])
        offload = plugin is not None and plugin.cpu_offload
        opt_state = (_offload_init(optimizer.optimizer, own, self.device) if offload
                     else optimizer.init(own))
        accum = None
        if self.gradient_accumulation_steps > 1:
            shards_grads = plugin is not None and plugin.shards_grads
            bufs = [None if f else _zeros_like(o if shards_grads else p, offload)
                    for p, o, f in zip(leaves, tree_leaves(own), frozen)]
            accum = tree_unflatten(params, bufs)
        optimizer._opt_state_ref = opt_state
        fp8_state = None
        if self.fp8_recipe is not None and self.fp8_recipe.use_delayed_scaling:
            from .ops.fp8 import DelayedScalingState

            fp8_state = DelayedScalingState.init(self.fp8_recipe.amax_history_len, self.device)
        return TrainState(params=params, opt_state=opt_state, step=0, grad_accum=accum, micro=0,
                          tp_dims=tp_dims, rng=None if rng is None else int(rng),
                          fp8_state=fp8_state, fsdp_dims=fsdp_dims, zero_dims=zero_dims)

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
        norm; folded into the fused apply as a scale) and applied. Either limit left
        None takes the value of the last ``clip_grad_value_``/``clip_grad_norm_`` call
        (or the constructor's ``max_grad_norm``). Inside ``accumulate()`` or
        ``no_sync()`` the context decides whether a call applies; an apply before the
        window is full still divides the sum by ``gradient_accumulation_steps``.
        ``cast_params=False`` leaves the cast to the model (llama casts each weight at
        its use).
        ``skip_nonfinite_steps=K`` skips updates whose loss or gradients are not finite
        (a micro-step's contribution is zeroed) and raises :class:`NonFiniteStepError`
        after K consecutive ones. The step updates its state in place (the JAX step
        donates it). Under ZeRO-3 a loss marked by ``parallel.fsdp.gathers_fsdp_shards``
        (``models.llama.loss_fn``) gets ``FsdpShard`` leaves and gathers each where it
        uses it; any other loss gets the whole tree gathered before the call."""
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
        max_grad_value = self._max_grad_value if max_grad_value is None else max_grad_value
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
        dp_group = None if mesh is None else mesh.group(DATA_AXIS)
        fsdp_group = None if mesh is None else mesh.group(FSDP_AXIS)
        world_group = dist.group.WORLD if mesh is not None and mesh.size > 1 else None
        plugin = self.fsdp_plugin
        # A ZeRO-1/2 leaf's gradient is reduce-scattered into this rank's slice (ZeRO-2;
        # ZeRO-1 too when nothing accumulates: the slice is all its update reads), or
        # averaged whole and sliced at the apply (ZeRO-1's whole accumulation buffers).
        scatter = plugin is not None and (plugin.shards_grads or accum_steps == 1)
        offload = plugin is not None and plugin.cpu_offload
        lazy_gather = getattr(loss_fn, "gathers_fsdp_shards", False)

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

        def averaged(x, dtype=None, group=batch_group):
            """``x`` averaged over the batch ranks: summed over ``group`` in its own type
            (in place), then divided by their number in ``dtype``."""
            x = all_reduce(x.contiguous(), "sum", group).to(dtype or x.dtype)
            return x if n_batch == 1 else x.div_(n_batch)

        def reduced(g, i: int, state: TrainState, dtype=None):
            """Leaf ``i``'s gradient averaged over the batch ranks. A piece of an fsdp-split
            param came out of its gather's backward summed over fsdp: it is summed over
            dp only; a ZeRO-1/2 leaf's gradient is reduce-scattered over fsdp first (ZeRO-1
            only when nothing accumulates)."""
            if state.fsdp_dims and state.fsdp_dims[i] is not None:
                return averaged(g, dtype, dp_group)
            if scatter and state.zero_dims and state.zero_dims[i] is not None:
                return averaged(reduce_scatter(g, state.zero_dims[i], fsdp_group), dtype,
                                dp_group)
            return averaged(g, dtype)

        def gathered(x, i: int, state: TrainState):
            """What the loss gets for leaf ``i``: an fsdp piece gathered (or, for a loss
            that gathers itself, wrapped as an ``FsdpShard``), any other leaf as it is."""
            d = state.fsdp_dims[i] if state.fsdp_dims else None
            if d is None or fsdp_group is None:
                return x
            return FsdpShard(x, d, fsdp_group) if lazy_gather else fsdp_gather(x, d, fsdp_group)

        recipe = self.fp8_recipe

        def fp8_scope(state: TrainState):
            """The delayed-scaling context of a step (a null one without fp8 state)."""
            if state.fp8_state is None:
                return contextlib.nullcontext()
            from .ops.fp8 import autoscale_ctx, delayed_scales

            scales = delayed_scales(state.fp8_state, recipe.fp8_format, recipe.margin,
                                    recipe.amax_compute_algo)
            # The grad role stays on current scaling: no observed cotangent amax exists
            # at this level (the cotangent is quantized inside fp8_dot's backward).
            return autoscale_ctx(torch.cat([scales[:2], torch.full_like(scales[2:], math.nan)]))

        def compute(state: TrainState, batch):
            """(loss, aux, per-leaf gradients with None for frozen leaves, new fp8 state)."""
            _refuse_quantized(state.params)
            batch = self._to_device(batch)
            masters = tree_leaves(state.params)
            frozen = _frozen_leaves(tx, state.params)
            train = [i for i, f in enumerate(frozen) if not f]
            grads = [None] * len(masters)
            new_fp8 = None
            # The fp8 context stays open across the backward: a checkpointed block's
            # recomputed fp8_dot must take the forward's scales.
            with self._mesh_context(), fp8_scope(state) as fp8_ctx:
                if compress_reduce and state.fp8_state is None:
                    # Gradients w.r.t. the cast tree, upcast afterwards: the backward of
                    # the cast IS that upcast, so the values are those of the plain branch.
                    # An fsdp piece is cast before its gather: the bytes gathered (and the
                    # gradient reduce-scattered) are the compute type's.
                    with torch.no_grad():
                        leaves = [p.to(policy.compute_dtype) for p in masters]
                    for i in train:
                        leaves[i] = leaves[i].detach().requires_grad_(True)
                    loss, aux = call_loss(tree_unflatten(state.params, [
                        gathered(x, i, state) for i, x in enumerate(leaves)]), batch, state)
                    low = list(torch.autograd.grad(loss, [leaves[i] for i in train],
                                                   allow_unused=True))
                    del leaves
                    for j, i in enumerate(train):
                        g = low[j]
                        low[j] = None  # free each low-precision gradient once upcast
                        grads[i] = (reduced(g, i, state, masters[i].dtype) if g is not None
                                    else _zero_grad(masters[i], i, state, scatter, mesh))
                else:
                    leaves = [p.detach().requires_grad_(not f) for p, f in zip(masters, frozen)]
                    used = leaves
                    if cast_params:
                        used = [x.to(policy.compute_dtype) if x.is_floating_point() else x
                                for x in leaves]
                    tree = tree_unflatten(state.params, [gathered(x, i, state)
                                                         for i, x in enumerate(used)])
                    del used
                    loss, aux = call_loss(tree, batch, state)
                    del tree
                    for i, g in zip(train, torch.autograd.grad(
                            loss, [leaves[i] for i in train], allow_unused=True)):
                        grads[i] = (reduced(g, i, state) if g is not None
                                    else _zero_grad(masters[i], i, state, scatter, mesh))
                if fp8_ctx is not None:
                    amax = fp8_ctx["amax"]
                    new_fp8 = state.fp8_state.update(amax[0], amax[1], torch.zeros_like(amax[0]))
            return averaged(loss.detach().clone().reshape(1))[0], aux, grads, new_fp8

        def each(fn, grads):
            """``fn`` over the gradients that exist (frozen leaves have None)."""
            return [None if g is None else fn(g) for g in grads]

        def micro_step(state: TrainState, batch):
            loss, aux, grads, new_fp8 = compute(state, batch)
            metrics = {"loss": loss}
            if guard:
                finite = _all_finite(loss, grads, world_group)
                metrics["nonfinite"] = not finite
                if not finite:  # a non-finite contribution would poison the window
                    grads = each(torch.zeros_like, grads)
            if state.grad_accum is None:
                accum = tree_unflatten(state.params, grads)
            else:
                accum = state.grad_accum
                with torch.no_grad():
                    for a, g in zip(_leaves_like(accum, state.params), grads):
                        if g is not None:
                            if a.device == g.device:
                                a.add_(g)
                            else:  # cpu_offload: the buffer streams through the card
                                a.copy_(a.to(g.device, non_blocking=True) + g)
            if has_aux:
                metrics["aux"] = aux
            return state.replace(grad_accum=accum, micro=state.micro + 1,
                                 fp8_state=new_fp8), metrics

        def apply_step(state: TrainState, batch):
            loss, aux, grads, new_fp8 = compute(state, batch)
            with torch.no_grad():
                if state.grad_accum is not None:
                    grads = [g if g is None else a.to(g.device, non_blocking=True) + g
                             for a, g in zip(_leaves_like(state.grad_accum, state.params),
                                             grads)]
                if accum_steps > 1:
                    grads = each(lambda g: g / accum_steps, grads)
                zero_dims = state.zero_dims or [None] * len(grads)
                if not scatter:  # ZeRO-1 accumulating: the whole averaged gradient, sliced
                    grads = [_zero_slice(g, d, mesh) for g, d in zip(grads, zero_dims)]
                groups = _split_groups(state, mesh)
                metrics = {"loss": loss}
                finite = _all_finite(loss, grads, world_group) if guard else True
                fused_opt = getattr(tx, "fused_apply", None)
                grad_scale = None
                if max_grad_value is not None:
                    grads = each(lambda g: torch.clamp(g, -max_grad_value, max_grad_value),
                                 grads)
                if max_grad_norm is not None:
                    gnorm = _global_norm(grads, groups)
                    scale = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                    metrics["grad_norm"] = gnorm
                    if fused_opt is None:
                        grads = each(lambda g: g * scale, grads)
                    else:
                        grad_scale = scale
                new_params, new_opt_state = state.params, state.opt_state
                if finite:
                    grad_tree = tree_unflatten(state.params, grads)
                    masters = tree_leaves(state.params)
                    # What this rank updates: a ZeRO-1/2 leaf's slice, any other leaf itself.
                    own = tree_unflatten(state.params, [
                        _zero_slice(p, d, mesh) for p, d in zip(masters, zero_dims)])
                    if fused_opt is not None:
                        # A split leaf's scaled-fp8 moments take the amax of its group.
                        kw = dict(grad_scale=1.0 if grad_scale is None else grad_scale,
                                  groups=groups)
                        if offload:
                            new_opt_state = tx.fused_apply_offloaded(
                                grad_tree, state.opt_state, own, **kw)[1]
                        else:
                            new_opt_state = fused_opt(grad_tree, state.opt_state, own, **kw)[1]
                    else:
                        opt_state = (_fetch_tree(state.opt_state, self.device) if offload
                                     else state.opt_state)
                        updates, new_opt_state = tx.update(grad_tree, opt_state, own)
                        if offload:
                            new_opt_state = _store_tree(state.opt_state, new_opt_state)
                        for p, u in zip(tree_leaves(own), _leaves_like(updates, own)):
                            if u is not None:  # a frozen leaf's update is None
                                p.copy_((p + u).to(p.dtype))
                    for p, o, d in zip(masters, tree_leaves(own), zero_dims):
                        if d is not None:  # ZeRO-1/2: every rank's new slice, in place
                            p.copy_(all_gather(o, d, fsdp_group))
                del grads
                if state.grad_accum is not None:
                    for a in tree_leaves(state.grad_accum):
                        a.zero_()
            if has_aux:
                metrics["aux"] = aux
            if guard:
                metrics["nonfinite"] = not finite
            if not finite:  # a skipped step keeps its fp8 history too
                new_fp8 = state.fp8_state
            optimizer._opt_state_ref = new_opt_state
            return state.replace(params=new_params, opt_state=new_opt_state,
                                 step=state.step + (1 if finite else 0), micro=0,
                                 fp8_state=new_fp8), metrics

        if fused_steps > 1:
            if fused_steps % accum_steps:
                raise ValueError(f"fused_steps ({fused_steps}) must be a multiple of "
                                 f"gradient_accumulation_steps ({accum_steps})")
            return _FusedTrainStep(self, micro_step, apply_step, fused_steps, optimizer=optimizer,
                                   pad_grad_norm=max_grad_norm is not None)
        return _TrainStep(self, micro_step, apply_step, optimizer=optimizer,
                          skip_nonfinite_steps=skip_nonfinite_steps)

    # -------------------------------------------------- accumulation and sync contexts
    @contextlib.contextmanager
    def accumulate(self, *models):
        """Gradient-accumulation context: counts its entries and sets ``sync_gradients``
        on every ``gradient_accumulation_steps``-th one, at the end of a prepared data
        loader (``sync_with_dataloader``) or on each one (``sync_each_batch``). A step
        built by ``build_train_step`` called inside applies exactly when it is set."""
        self._accumulate_count += 1
        gs = self.gradient_state
        do_sync = (self._accumulate_count % self.gradient_accumulation_steps == 0
                   or (gs.sync_with_dataloader and gs.end_of_dataloader)
                   or gs.sync_each_batch)
        gs._set_sync_gradients(do_sync)
        self._in_accumulate_ctx = True
        try:
            yield
        finally:
            self._in_accumulate_ctx = False

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """Every step called inside only accumulates (its gradient is added to the
        state's accumulation buffer, nothing is applied); ``sync_gradients`` is back to
        its value on exit."""
        gs = self.gradient_state
        prev = gs.sync_gradients
        gs._set_sync_gradients(False)
        self._in_accumulate_ctx = True
        try:
            yield
        finally:
            gs._set_sync_gradients(prev)
            self._in_accumulate_ctx = False

    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A context for loops written against HF Accelerate: the train step casts to
        the compute dtype itself, so this one does nothing (as in JAX)."""
        yield

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches: Optional[bool] = None):
        """Prepared data loaders already even out the ranks' batches
        (``even_batches``); ``even_batches`` given here overrides that for the block."""
        cfg = self.dataloader_config
        prev = cfg.even_batches
        if even_batches is not None:
            cfg.even_batches = even_batches
        try:
            yield
        finally:
            cfg.even_batches = prev

    # ------------------------------------------------------------------ gradient utilities
    def backward(self, loss, **kwargs):
        raise RuntimeError(
            "The params are a tensor tree that the train step's own optimizer updates: a "
            ".grad left by loss.backward() would reach nothing. Use `step = "
            "accelerator.build_train_step(loss_fn)` and call `state, metrics = step(state, "
            "batch)` — or `accelerator.value_and_grad(loss_fn)` for manual loops.")

    def value_and_grad(self, loss_fn: Callable, has_aux: bool = False) -> Callable:
        """``fn(params, *args, **kwargs) -> (loss, grads)`` (``((loss, aux), grads)``
        with ``has_aux``): ``loss_fn`` on the params cast to the policy's compute dtype,
        its gradients with respect to the params' floating leaves taken by
        ``torch.autograd`` through that cast, so each comes back in its leaf's dtype
        (None for other leaves; zeros for a leaf the loss does not use). The caller's
        tensors are not modified; the loss runs in the mesh's context."""
        policy = self.mixed_precision_policy

        def wrapped(params, *args, **kwargs):
            leaves = tree_leaves(params)
            train = [i for i, x in enumerate(leaves)
                     if torch.is_tensor(x) and x.is_floating_point()]
            with torch.enable_grad(), self._mesh_context():
                own = list(leaves)
                for i in train:
                    own[i] = leaves[i].detach().requires_grad_(True)
                out = loss_fn(cast_floating(tree_unflatten(params, own), policy.compute_dtype),
                              *args, **kwargs)
                loss, aux = out if has_aux else (out, None)
                got = torch.autograd.grad(loss, [own[i] for i in train], allow_unused=True)
            grads = [None] * len(leaves)
            for i, g in zip(train, got):
                grads[i] = torch.zeros_like(leaves[i]) if g is None else g
            loss = loss.detach()
            grads = tree_unflatten(params, grads)
            if not has_aux:
                return loss, grads
            aux = tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, aux)
            return (loss, aux), grads

        return wrapped

    def clip_grad_norm_(self, max_grad_norm: float) -> None:
        """Clip by the global norm at ``max_grad_norm`` in every train step built after
        this call (the norm is in each step's ``grad_norm`` metric)."""
        self._max_grad_norm = float(max_grad_norm)

    def clip_grad_value_(self, clip_value: float) -> None:
        """Clamp every gradient element to ``[-clip_value, clip_value]`` in every train
        step built after this call, before any global-norm clip (the order a torch user
        calls the pair in)."""
        self._max_grad_value = float(clip_value)

    def set_trigger(self) -> None:
        """Raise this process's flag: the next ``check_trigger`` is True on every
        process."""
        self.flag_tensor = 1

    def check_trigger(self) -> bool:
        """Whether any process called ``set_trigger`` since the last check, on every
        process (a sum over all of them; a collective: every process calls it); the flag
        is cleared. The flag is a tensor on the device under NCCL, on the CPU under gloo
        (which would stage a CUDA tensor through host memory)."""
        dev = self.device if self.state.backend == "nccl" else torch.device("cpu")
        local = torch.tensor([float(self.flag_tensor or 0)], device=dev)
        fired = bool(reduce(local, reduction="sum")[0] > 0)
        self.flag_tensor = None
        return fired

    def build_eval_step(self, eval_fn: Callable) -> Callable:
        """``eval_fn(params, batch) -> outputs`` under ``torch.no_grad`` with the params
        cast to the compute dtype; floating outputs cast to fp32 when the policy's
        output dtype is fp32. Under a mesh the function runs in its context on this
        rank's slice of the batch (outputs are the rank's own); fsdp pieces are
        gathered first: a ``TrainState``'s by its own ``fsdp_dims``, a params tree by
        the last ``prepare_params`` layout, which its leaves' shapes must match."""
        policy = self.mixed_precision_policy

        def step(params, batch):
            with torch.no_grad(), self._mesh_context():
                params, _, fsdp_dims = self._split_layout(params)
                params = cast_floating(params, policy.compute_dtype)
                if fsdp_dims is not None and self.mesh is not None:
                    group = self.mesh.group(FSDP_AXIS)
                    params = tree_unflatten(params, [
                        x if d is None else fsdp_gather(x, d, group)
                        for x, d in zip(tree_leaves(params), fsdp_dims)])
                out = eval_fn(params, self._to_device(batch))
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

    # ------------------------------------------------------------------------ model utils
    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        return model

    def get_state_dict(self, model, unwrap: bool = True):
        """The whole (unsharded) params on the host: every rank's tp and fsdp pieces
        gathered (a collective: every rank calls it). ``model`` is a ``TrainState``
        (gathered by its own ``tp_dims``/``fsdp_dims``) or a params tree of the last
        ``prepare_params`` layout (its leaves' shapes must match those pieces)."""
        from .checkpointing import _whole_leaf

        params, tp_dims, fsdp_dims = self._split_layout(model)
        leaves = tree_leaves(params)
        none = [None] * len(leaves)
        return tree_unflatten(params, [
            _whole_leaf(x, (t, f), self.mesh).detach().cpu() if torch.is_tensor(x) else x
            for x, t, f in zip(leaves, tp_dims or none, fsdp_dims or none)])

    def _split_layout(self, tree) -> tuple:
        """(params, tp dims, fsdp dims) of a tree handed in for gathering: a
        ``TrainState`` carries its own dims; a params tree takes the last
        ``prepare_params`` layout, and raises unless its leaves' shapes are that
        layout's pieces (a tree prepared earlier, or whole params, would gather by the
        wrong dims)."""
        if isinstance(tree, TrainState):
            return tree.params, tree.tp_dims, tree.fsdp_dims
        if self._prepared_layout is None or self.mesh is None:
            return tree, None, None
        shapes, tp_dims, fsdp_dims = self._prepared_layout
        got = [tuple(x.shape) if torch.is_tensor(x) else None for x in tree_leaves(tree)]
        if got != shapes:
            raise ValueError(
                f"these params ({len(got)} leaves) are not the pieces of the last "
                f"prepare_params layout ({len(shapes)} leaves, shapes differ at leaf "
                f"{next((i for i, (a, b) in enumerate(zip(got, shapes)) if a != b), min(len(got), len(shapes)))}); "
                "pass the TrainState, whose dims travel with it")
        return tree, tp_dims, fsdp_dims

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


def _frozen_leaves(tx, params) -> list:
    """Per leaf of ``params``: whether ``tx`` leaves it frozen (``frozen_leaves``, e.g.
    ``optim.multi_transform``'s ``set_to_zero`` groups); no leaf otherwise."""
    fn = getattr(tx, "frozen_leaves", None)
    return list(fn(params)) if fn is not None else [False] * len(tree_leaves(params))


def _all_finite(loss: torch.Tensor, grads, group=None) -> bool:
    """One host sync: loss and every gradient finite (on every rank of ``group``)."""
    finite = torch.isfinite(loss).all()
    for g in grads:
        if g is not None:
            finite = finite & torch.isfinite(g).all()
    return bool(all_reduce(finite.float().reshape(1), "min", group))


def _global_norm(grads, groups=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf that has a gradient, in fp32, summed
    leaf by leaf. ``groups`` (per leaf): the process group over whose ranks the leaf's
    gradient is split (tp, fsdp, or both): the squares of each group's leaves are summed
    over it; a leaf with None is replicated and counted once."""
    groups = groups or [None] * len(grads)
    squares = [(torch.sum(torch.square(g.float())), grp)
               for g, grp in zip(grads, groups) if g is not None]
    zero = torch.zeros((), dtype=torch.float32, device=squares[0][0].device if squares else None)
    replicated = sum((q for q, grp in squares if grp is None), zero)
    buckets: dict = {}
    for q, grp in squares:
        if grp is not None:
            buckets.setdefault(grp, []).append(q)
    sharded = sum((all_reduce(sum(qs, zero).reshape(1), "sum", grp)[0]
                   for grp, qs in buckets.items()), zero)
    return torch.sqrt(sharded + replicated)


def _split_groups(state: TrainState, mesh) -> Optional[list]:
    """Per param leaf, the process group of the mesh axes its gradient (and optimizer
    state) is split over at the apply: tp (``tp_dims``), fsdp (``fsdp_dims`` or
    ``zero_dims``), or both; None for a whole leaf. None when nothing is split."""
    if mesh is None:
        return None
    n = len(tree_leaves(state.params))
    tp = state.tp_dims or [None] * n
    fs = state.fsdp_dims or [None] * n
    zd = state.zero_dims or [None] * n
    out = []
    for t, f, z in zip(tp, fs, zd):
        axes = tuple(a for a, on in ((FSDP_AXIS, f is not None or z is not None),
                                     (TENSOR_AXIS, t is not None)) if on)
        out.append(mesh.group(axes) if axes else None)
    return out if any(g is not None for g in out) else None


def _spec_leaves(params, specs) -> list:
    """The specs of ``params``' leaves in ``tree_leaves`` order (None: whole)."""
    if specs is None:
        return [None] * len(tree_leaves(params))
    from .parallel.tp import map_with_specs

    return [b.value for b in tree_leaves(map_with_specs(lambda _, sp: _Box(sp), params, specs))]


def _whole_shape(leaf, spec, mesh) -> tuple:
    """The whole leaf's shape from this rank's piece and its spec."""
    shape = list(leaf.shape)
    for d, entry in enumerate(spec or ()):
        shape[d] *= mesh.axis_size(spec_axes(entry)) if spec_axes(entry) else 1
    return tuple(shape)


def _zero_slice(x, dim: Optional[int], mesh):
    """This rank's fsdp slice of ``x`` along ``dim`` (a contiguous copy); ``x`` itself
    when ``dim`` or ``x`` is None."""
    if dim is None or x is None:
        return x
    n = mesh.shape[FSDP_AXIS]
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(FSDP_AXIS) * k, k).contiguous()


def _zero_grad(master, i: int, state: TrainState, scatter: bool, mesh):
    """The zero gradient of a leaf the loss did not use, in the shape ``reduced`` gives."""
    d = state.zero_dims[i] if state.zero_dims and scatter else None
    return torch.zeros_like(master if d is None else _zero_slice(master, d, mesh))


def _zeros_like(x: torch.Tensor, on_host: bool) -> torch.Tensor:
    """Zeros of ``x``'s shape and type: beside ``x``, or (``on_host``) in host memory,
    pinned when ``x`` lies on CUDA."""
    if not on_host:
        return torch.zeros_like(x)
    return host_zeros(x.shape, x.dtype, pin=x.device.type == "cuda")


def host_zeros(shape, dtype, pin: bool) -> torch.Tensor:
    """Zeros in host memory; ``pin``: page-locked, allocated by the driver at the exact
    size (``cuMemHostAlloc``, freed with ``cuMemFreeHost`` when the last view goes) and
    zeroed by copies from a zero buffer on the card. The caching pinned allocator
    rounds each block up to a power of two (Llama-3-8B's 64.2 GB of moments would take
    76 GB), and registering pageable memory in place pins at under half the rate."""
    if not pin:
        return torch.zeros(shape, dtype=dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = math.prod(shape) * itemsize
    if not nbytes:
        return torch.empty(shape, dtype=dtype)
    driver = _cuda_driver()
    ptr = ctypes.c_void_p()
    err = driver.cuMemHostAlloc(ctypes.byref(ptr), ctypes.c_size_t(nbytes), 1)  # PORTABLE
    if err != 0:
        raise RuntimeError(f"cuMemHostAlloc of {nbytes} bytes failed: CUDA error {err}")
    raw = (ctypes.c_uint8 * nbytes).from_address(ptr.value)
    weakref.finalize(raw, driver.cuMemFreeHost, ctypes.c_void_p(ptr.value))
    flat = torch.frombuffer(raw, dtype=torch.uint8)  # holds ``raw`` while it lives
    zero = torch.zeros(min(nbytes, 256 << 20), dtype=torch.uint8, device="cuda")
    for start in range(0, nbytes, zero.numel()):
        n = min(zero.numel(), nbytes - start)
        flat[start:start + n].copy_(zero[:n], non_blocking=True)
    torch.cuda.current_stream().synchronize()
    return flat.view(dtype).view(shape)


_DRIVER = []


def _cuda_driver() -> ctypes.CDLL:
    """The CUDA driver library, for the host allocations of ``host_zeros``."""
    if not _DRIVER:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuMemHostAlloc.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
                                       ctypes.c_uint]
        lib.cuMemHostAlloc.restype = ctypes.c_int
        lib.cuMemFreeHost.argtypes = [ctypes.c_void_p]
        lib.cuMemFreeHost.restype = ctypes.c_int
        _DRIVER.append(lib)
    return _DRIVER[0]


def _offload_init(tx, params, device) -> Any:
    """``cpu_offload``'s optimizer state, made in host memory (pinned on CUDA). An Adam
    state (``optim.AdamState``, ``ops.fused_optim.ScaledAdamState``) is made there
    directly from the params' shapes (zero moments, unit scales), so the device never
    holds it; any other optimizer's state is initialized beside the params and moved
    leaf by leaf."""
    from .ops.fused_optim import ScaledAdamState
    from .optim import AdamState

    pin = device.type == "cuda"
    meta = tx.init(tree_map(lambda p: p.to("meta") if torch.is_tensor(p) else p, params))
    if isinstance(meta, (AdamState, ScaledAdamState)) and meta.count == 0:
        def zeros(m):
            return host_zeros(m.shape, m.dtype, pin)

        fields = {"mu": tree_map(zeros, meta.mu), "nu": tree_map(zeros, meta.nu)}
        for name in ("mu_scale", "nu_scale"):
            if getattr(meta, name, None) is not None:
                fields[name] = tree_map(lambda m: zeros(m).add_(1), getattr(meta, name))
        return meta._replace(**fields)
    return _store_tree(None, tx.init(params), pin)


def _fetch_tree(tree, device):
    """A host-resident state tree's tensors copied to ``device``."""
    return tree_map(lambda x: x.to(device, non_blocking=True) if torch.is_tensor(x) else x,
                    tree)


def _store_tree(host, tree, pin: Optional[bool] = None):
    """``tree``'s tensors written into ``host``'s (in place: they stay pinned), or, with
    no ``host``, moved to host memory (pinned when ``pin``); plain values as ``tree``'s."""
    if host is None:
        return tree_map(lambda x: host_zeros(x.shape, x.dtype, pin).copy_(x)
                        if torch.is_tensor(x) else x, tree)
    return tree_map(lambda h, x: h.copy_(x) if torch.is_tensor(h) else x, host, tree)
