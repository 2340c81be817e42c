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

Not ported yet (raise ``NotImplementedError``): fp8 (``mixed_precision="fp8"``),
optimizer/activation offload, ZeRO and every sharding plugin, data loaders, telemetry,
fault injection, the compile cache, and training over quantized weight leaves
(``ops.quantization.QuantizedWeight``: QLoRA, a frozen int8 base under LoRA adapters).
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass, replace as dataclass_replace
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .ops.quantization import QuantizedWeight
from .optimizer import AcceleratedOptimizer
from .parallel.mesh import mesh_batch_size_divisor, mesh_context
from .parallel.tp import all_reduce, apply_tensor_parallel, sharded_leaves
from .state import AcceleratorState, GradientState
from .utils.constants import BATCH_AXES, TENSOR_AXIS
from .utils.dataclasses import GradientAccumulationPlugin, MixedPrecisionPolicy
from .utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["Accelerator", "TrainState", "NonFiniteStepError", "cast_floating"]


def cast_floating(tree: Any, dtype) -> Any:
    """Cast floating leaves of a tree to ``dtype`` (ints/bools untouched)."""
    return tree_map(lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point()
                    else x, tree)


@dataclass
class TrainState:
    """The training carry: everything a train step reads and writes. ``step`` counts
    optimizer steps, ``micro`` the micro-steps since the last apply; ``grad_accum`` holds
    the running gradient sum between sync steps. ``tp_sharded`` flags, per leaf of
    ``params`` in ``tree_leaves`` order, the leaves that are this rank's tp shards
    (from ``create_train_state``'s ``partition_specs``; None: every leaf whole)."""

    params: Any
    opt_state: Any
    step: int = 0
    grad_accum: Any = None
    micro: int = 0
    tp_sharded: Optional[list] = None

    def replace(self, **kwargs) -> "TrainState":
        return dataclass_replace(self, **kwargs)


class NonFiniteStepError(RuntimeError):
    """Training aborted: ``skip_nonfinite_steps`` consecutive-skip budget hit."""

    def __init__(self, consecutive: int, total: int):
        super().__init__(f"{consecutive} consecutive non-finite training steps ({total} total "
                         "skipped) — loss/grads are diverging, aborting")
        self.consecutive = consecutive
        self.total = total


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
        self.micro_count = 0
        self.skip_nonfinite_steps = skip_nonfinite_steps
        self.nonfinite_total = 0
        self.nonfinite_consecutive = 0

    def __call__(self, state: TrainState, batch) -> tuple[TrainState, Any]:
        state, metrics = self._dispatch(self.accelerator, state, batch)
        if self.skip_nonfinite_steps:
            self._check_nonfinite(metrics)
        return state, metrics

    def _check_nonfinite(self, metrics) -> None:
        if not bool(metrics.get("nonfinite", False)):
            self.nonfinite_consecutive = 0
            return
        self.nonfinite_total += 1
        self.nonfinite_consecutive += 1
        if self.nonfinite_consecutive >= self.skip_nonfinite_steps:
            raise NonFiniteStepError(self.nonfinite_consecutive, self.nonfinite_total)

    def _dispatch(self, acc, state: TrainState, batch) -> tuple[TrainState, Any]:
        do_sync = (self.micro_count + 1) % acc.gradient_accumulation_steps == 0
        acc.gradient_state._set_sync_gradients(do_sync)
        if do_sync:
            state, metrics = self.apply_fn(state, batch)
            self.micro_count = 0
        else:
            state, metrics = self.micro_fn(state, batch)
            self.micro_count += 1
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
        for batch in self._unstack(batches):
            if (state.micro + 1) % accum == 0:
                state, metrics = self.apply_fn(state, batch)
            else:
                state, metrics = self.micro_fn(state, batch)
                if self.pad_grad_norm:
                    metrics["grad_norm"] = torch.zeros((), device=metrics["loss"].device)
            per_step.append(metrics)
        acc.step += self.fused_steps
        if self.optimizer is not None:
            self.optimizer._step_count += self.fused_steps // accum
        acc.gradient_state._set_sync_gradients(self.fused_steps % accum == 0)
        stacked = {k: torch.stack([torch.as_tensor(m[k]) for m in per_step])
                   for k in per_step[0] if k != "aux"}
        if "aux" in per_step[0]:
            stacked["aux"] = [m["aux"] for m in per_step]
        return state, stacked


_UNPORTED_ARGS = (
    "dataloader_config", "fsdp_plugin", "tp_plugin", "pp_plugin", "sp_plugin",
    "ep_plugin", "megatron_lm_plugin", "rng_types", "log_with", "project_dir",
    "project_config", "kwargs_handlers", "dynamo_plugin", "telemetry_config",
    "step_scheduler_with_optimizer",
    "compile_cache_config", "gateway_config", "fault_config",
)


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
        **kwargs,
    ):
        unported = sorted(k for k, v in kwargs.items() if v is not None)
        unknown = sorted(k for k in kwargs if k not in _UNPORTED_ARGS)
        if unknown:
            raise TypeError(f"Accelerator got unexpected arguments {unknown}")
        if unported or not device_placement or split_batches:
            raise NotImplementedError(
                f"Accelerator arguments {unported or ['device_placement/split_batches']} "
                "are not ported yet")
        if mixed_precision == "fp8":
            raise NotImplementedError("mixed_precision='fp8' is not ported yet")
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu, device=device,
                                      mesh_config=mesh_config, backend=backend)
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps or 1)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.step = 0
        self._max_grad_norm = max_grad_norm
        self._optimizers: list[AcceleratedOptimizer] = []

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
        """Prepare each object, preserving order: transformations become
        ``AcceleratedOptimizer``s, param trees move to the device in the master dtype,
        anything else passes through."""
        result = tuple(self._prepare_one(obj) for obj in args)
        return result if len(result) > 1 else result[0]

    def _prepare_one(self, obj):
        if isinstance(obj, AcceleratedOptimizer):
            if obj not in self._optimizers:
                self._optimizers.append(obj)
            return obj
        if type(obj).__module__.startswith("torch.utils.data"):
            raise NotImplementedError("data loaders are not ported yet")
        if hasattr(obj, "init") and hasattr(obj, "update") and not isinstance(obj, type):
            return self.prepare_optimizer(obj)
        if isinstance(obj, dict) and obj and all(torch.is_tensor(x) for x in tree_leaves(obj)):
            return self.prepare_params(obj)
        return obj

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
                           partition_specs=None) -> TrainState:
        """The training carry: params prepared (master dtype, on the device; this rank's
        shards under ``partition_specs``), optimizer state initialized from them, an
        accumulation buffer when accumulating."""
        _refuse_quantized(params)
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = self.prepare_optimizer(optimizer)
        params = self.prepare_params(params, partition_specs=partition_specs)
        opt_state = optimizer.init(params)
        accum = None
        if self.gradient_accumulation_steps > 1:
            accum = tree_map(torch.zeros_like, params)
        optimizer._opt_state_ref = opt_state
        tp_sharded = (None if partition_specs is None
                      else sharded_leaves(params, partition_specs, self.mesh))
        return TrainState(params=params, opt_state=opt_state, step=0, grad_accum=accum, micro=0,
                          tp_sharded=tp_sharded)

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
        """The training step: ``loss_fn(params, batch)`` returns a scalar loss, or
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
        if _loss_fn_wants_rng(loss_fn):
            raise NotImplementedError("loss functions that take an rng are not ported yet")
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

        def call_loss(params, batch):
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
                    loss, aux = call_loss(tree_unflatten(state.params, leaves), batch)
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
                    loss, aux = call_loss(tree, batch)
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
                    gnorm = _global_norm(grads, state.tp_sharded, tp_group)
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

    def __repr__(self):
        return (f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r}, "
                f"gradient_accumulation_steps={self.gradient_accumulation_steps})")


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


def _global_norm(grads, sharded=None, tp_group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32, summed leaf by leaf. Leaves
    flagged in ``sharded`` are this rank's tp shards: their squares are summed over
    ``tp_group``; the others are replicated and counted once."""
    sharded = sharded or [False] * len(grads)
    squares = [torch.sum(torch.square(g.float())) for g in grads]
    zero = torch.zeros((), dtype=torch.float32, device=squares[0].device if squares else None)
    local = sum((q for q, s in zip(squares, sharded) if s), zero)
    replicated = sum((q for q, s in zip(squares, sharded) if not s), zero)
    if tp_group is None:
        return torch.sqrt(local + replicated)
    return torch.sqrt(all_reduce(local.reshape(1), "sum", tp_group)[0] + replicated)
