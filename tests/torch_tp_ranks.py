"""Rank functions of the port's multi-process tests, run by ``notebook_launcher`` in
spawned gloo ranks on the CPU. This module imports torch, numpy and the port only, so
a spawned rank never loads jax; the tests hand every input in as numpy arrays made from
a seed, and each function returns plain numbers and numpy arrays."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch


def _threads() -> None:
    torch.set_num_threads(1)  # several ranks share the test worker's cores


def loaded_modules(prefixes) -> list:
    """The modules of ``sys.modules`` under any of ``prefixes``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in prefixes)


def raise_on_rank(bad: int) -> int:
    """This rank's index, after raising on rank ``bad``."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == bad:
        raise ValueError(f"rank {bad} was told to fail")
    return rank


def fused_xent_tp(x, w, t, cot, softcaps) -> dict:
    """``fused_cross_entropy_tp`` of ``sum(nll * cot)`` over the world's ranks (one tp
    group, rank r holding columns ``r·V/n ..`` of w): per softcap, nll, dx and the
    gathered dw, and the jax modules this rank loaded."""
    import torch.distributed as dist

    from accelerate_tpu_torch.ops.fused_xent import fused_cross_entropy_tp
    from accelerate_tpu_torch.parallel.tp import all_reduce

    _threads()
    group = dist.group.WORLD
    rank, n = dist.get_rank(), dist.get_world_size()
    vl = w.shape[1] // n
    out = {}
    for cap in softcaps:
        xt = torch.tensor(x).requires_grad_()
        ws = torch.tensor(w[:, rank * vl:(rank + 1) * vl]).requires_grad_()
        nll = fused_cross_entropy_tp(xt, ws, torch.tensor(t), group=group, softcap=cap)
        (nll * torch.tensor(cot)).sum().backward()
        dw = torch.zeros(w.shape)
        dw[:, rank * vl:(rank + 1) * vl] = ws.grad
        out[cap] = {"nll": nll.detach().numpy(), "dx": xt.grad.numpy(),
                    "dw": all_reduce(dw, "sum", group).numpy()}
    out["jax_modules"] = loaded_modules(("jax", "jaxlib", "accelerate_tpu"))
    return out


def _config(cfg_kw: dict):
    from accelerate_tpu_torch.models import llama

    return dataclasses.replace(llama.CONFIGS["tiny"], **{"dtype": torch.float32, **cfg_kw})


def _local_batch(batch: dict, mesh) -> dict:
    from accelerate_tpu_torch.parallel.mesh import mesh_batch_size_divisor
    from accelerate_tpu_torch.utils.constants import BATCH_AXES

    n = mesh_batch_size_divisor(mesh)
    i = mesh.axis_index(BATCH_AXES)
    return {k: torch.tensor(v[i * (len(v) // n):(i + 1) * (len(v) // n)])
            for k, v in batch.items()}


def loss_and_grads(np_params, batch, cases: dict, mesh_kw: dict) -> dict:
    """Per case ``{name: cfg overrides}``: ``llama.loss_fn`` on this rank's slice of the
    batch and shards of the params (``partition_specs``) under the mesh, its gradients
    averaged over the batch ranks (as the train step averages them) and gathered; plus
    how often the single-shard fused kernel's entry point ran."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import common
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
    from accelerate_tpu_torch.parallel import MeshConfig, mesh_batch_size_divisor, mesh_context
    from accelerate_tpu_torch.parallel.tp import all_reduce
    from accelerate_tpu_torch.utils.constants import BATCH_AXES
    from accelerate_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    _threads()
    mesh = Accelerator(device="cpu", mesh_config=MeshConfig(**mesh_kw)).mesh
    calls = []
    kernel = common.fused_cross_entropy

    def counted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)

    common.fused_cross_entropy = counted
    out = {}
    for name, cfg_kw in cases.items():
        cfg = _config(cfg_kw)
        specs = llama.partition_specs(cfg)
        params = params_from_jax(np_params[name], cfg, device="cpu",
                                 master_dtype=torch.float32, mesh=mesh, specs=specs)
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        calls.clear()
        with mesh_context(mesh):
            loss = llama.loss_fn(params, _local_batch(batch, mesh), cfg)
        n = mesh_batch_size_divisor(mesh)
        grads = [all_reduce(g, "sum", mesh.group(BATCH_AXES)) / n
                 for g in torch.autograd.grad(loss, leaves)]
        out[name] = {"loss": float(loss.detach()), "kernel_calls": len(calls),
                     "grads": params_to_numpy(tree_unflatten(params, grads), mesh=mesh,
                                              specs=specs)}
    common.fused_cross_entropy = kernel
    return out


def train_steps(np_params, batches, cfg_kw: dict, mesh_kw: dict, lr: float,
                max_grad_norm: float) -> dict:
    """``Accelerator.build_train_step`` over ``llama.loss_fn`` with ``fused_adamw``, the
    params placed by ``create_train_state(partition_specs=...)``: per step the loss, the
    global grad norm and the gathered params."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.parallel import MeshConfig

    _threads()
    cfg = _config(cfg_kw)
    acc = Accelerator(device="cpu", mesh_config=MeshConfig(**mesh_kw))
    specs = llama.partition_specs(cfg)
    state = acc.create_train_state(
        params_from_jax(np_params, cfg, device="cpu", master_dtype=torch.float32),
        fused_adamw(lr), partition_specs=specs)
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg),
                                max_grad_norm=max_grad_norm)
    out = {"losses": [], "grad_norms": [], "params": [],
           "distributed_type": str(acc.distributed_type)}
    for batch in batches:
        state, metrics = step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["params"].append(params_to_numpy(state.params, mesh=acc.mesh, specs=specs))
    return out


def mean_loss_train_steps(np_params, batches, mesh_kw: dict, lr: float,
                          max_grad_norm: float) -> dict:
    """``Accelerator.build_train_step`` over a loss that knows nothing of the mesh: the
    plain mean of a linear model's squared error over this rank's rows, with
    ``optim.adamw``; per step the loss, the grad norm and the params."""
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.parallel import MeshConfig

    _threads()
    acc = Accelerator(device="cpu", mesh_config=MeshConfig(**mesh_kw))
    state = acc.create_train_state({k: torch.tensor(v) for k, v in np_params.items()},
                                   optim.adamw(lr))

    def loss_fn(p, b):
        return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()

    step = acc.build_train_step(loss_fn, max_grad_norm=max_grad_norm)
    out = {"losses": [], "grad_norms": [], "params": []}
    for batch in batches:
        state, metrics = step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["params"].append({k: v.detach().numpy().copy() for k, v in state.params.items()})
    return out


def collectives(seed: int) -> dict:
    """The host-level collectives of ``utils.operations`` on this rank's inputs (made
    from ``seed`` and the rank): gather (a 2-D leaf and a 0-d one), gather_object,
    reduce (sum, mean, scaled), broadcast, broadcast_object_list, pad_across_processes
    (at the end and first), ``set_seed(device_specific=True)`` then
    ``synchronize_rng_states`` (Python, numpy, torch and a generator), and debug mode's
    refusal of mismatched shapes."""
    import os

    import torch.distributed as dist

    from accelerate_tpu_torch.utils import operations as ops

    _threads()
    rank = dist.get_rank()
    rng = np.random.default_rng(seed + rank)
    x = torch.tensor(rng.standard_normal((2, 3)).astype(np.float32))
    out = {
        "x": x.numpy(),
        "gather": ops.gather({"x": x, "s": torch.tensor(float(rank))}),
        "gather_object": ops.gather_object([{"rank": rank}]),
        "reduce_sum": ops.reduce(x, "sum").numpy(),
        "reduce_mean": ops.reduce(x, "mean").numpy(),
        "reduce_scaled": ops.reduce(x, "sum", scale=0.5).numpy(),
        "broadcast": ops.broadcast({"x": x.clone()}, from_process=1)["x"].numpy(),
        "objects": ops.broadcast_object_list([rank, f"from {rank}"], from_process=1),
        "pad": ops.pad_across_processes(torch.full((rank + 1, 2), rank + 1)).numpy(),
        "pad_first": ops.pad_across_processes(torch.full((2, rank + 2), rank + 1), dim=1,
                                              pad_index=-1, pad_first=True).numpy(),
    }
    out = {k: (v if not isinstance(v, dict) else
               {kk: vv.numpy() if torch.is_tensor(vv) else vv for kk, vv in v.items()})
           for k, v in out.items()}
    import random

    from accelerate_tpu_torch.utils.random import set_seed, synchronize_rng_states

    set_seed(100, device_specific=True)  # a seed of its own on each rank
    out["own_draw"] = float(torch.rand(1))
    synchronize_rng_states(["python", "numpy", "torch"])
    gen = torch.Generator().manual_seed(rank)
    synchronize_rng_states(["generator"], generator=gen)
    out["synced_draws"] = [random.random(), float(np.random.rand()), float(torch.rand(1)),
                           float(torch.rand(1, generator=gen))]
    os.environ["ACCELERATE_DEBUG_MODE"] = "1"
    try:
        ops.gather(torch.zeros(rank + 1))
        out["debug_mode"] = "no error"
    except ops.DistributedOperationException as e:
        out["debug_mode"] = str(e)
    finally:
        del os.environ["ACCELERATE_DEBUG_MODE"]
    return out


def dispatched_batches(n: int, batch_size: int, split_batches: bool) -> dict:
    """A ``DataLoaderDispatcher`` over ``n`` rows (only rank 0 reads): this rank's
    batches, and the gradient state's end flag and remainder at each."""
    from accelerate_tpu_torch.data_loader import DataLoader, prepare_data_loader
    from accelerate_tpu_torch.state import GradientState

    _threads()

    class Rows:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"x": np.float32(i), "y": np.arange(i, i + 2)}

    loader = prepare_data_loader(DataLoader(Rows(), batch_size=batch_size), device="cpu",
                                 dispatch_batches=True, split_batches=split_batches)
    gs = GradientState()
    out = {"x": [], "y": [], "end": [], "remainder": [], "len": len(loader)}
    for batch in loader:
        out["x"].append(batch["x"].numpy())
        out["y"].append(batch["y"].numpy())
        out["end"].append(gs.end_of_dataloader)
        out["remainder"].append(gs.remainder)
    return out


def accelerator_loader(n: int, batch_size: int, mesh_kw: dict) -> dict:
    """``Accelerator.prepare`` of a data loader under a mesh: the global batches each
    rank sees, ``gather_for_metrics`` of the rank's slice of each (trimmed at the
    end), and ``reduce`` of the rank index."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.data_loader import DataLoader
    from accelerate_tpu_torch.parallel import MeshConfig
    from accelerate_tpu_torch.parallel.mesh import mesh_batch_size_divisor
    from accelerate_tpu_torch.utils.constants import BATCH_AXES

    _threads()

    class Rows:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"x": np.float32(i)}

    acc = Accelerator(device="cpu", mesh_config=MeshConfig(**mesh_kw))
    loader = acc.prepare(DataLoader(Rows(), batch_size=batch_size))
    k, i = mesh_batch_size_divisor(acc.mesh), acc.mesh.axis_index(BATCH_AXES)
    out = {"batches": [], "metrics": []}
    for batch in loader:
        x = batch["x"]
        out["batches"].append(x.numpy())
        per = x.shape[0] // k
        out["metrics"].append(acc.gather_for_metrics(x[i * per:(i + 1) * per]).numpy())
    out["reduce"] = float(acc.reduce(torch.tensor(float(i))))
    return out


def tp_checkpoint_round_trip(np_params, batches, cfg_kw: dict, mesh_kw: dict, lr: float,
                             directory: str) -> dict:
    """A tp train state saved after one step (each rank its own shards), trained on,
    loaded back in place and trained again: per phase the losses, whether the reloaded
    shards equal the saved ones, the files in the state directory, the shards' shapes
    and the whole params at the save."""
    import os

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.parallel import MeshConfig
    from accelerate_tpu_torch.utils.tree import tree_leaves

    _threads()
    cfg = _config(cfg_kw)
    acc = Accelerator(device="cpu", mesh_config=MeshConfig(**mesh_kw))
    specs = llama.partition_specs(cfg)
    state = acc.create_train_state(
        params_from_jax(np_params, cfg, device="cpu", master_dtype=torch.float32),
        fused_adamw(lr), partition_specs=specs)
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    state, _ = step(state, batches[0])
    path = acc.save_state(os.path.join(directory, "ckpt"), train_state=state)
    saved = [t.clone() for t in tree_leaves(state.params)]
    saved_whole = params_to_numpy(state.params, mesh=acc.mesh, specs=specs)
    first = []
    for batch in batches[1:]:
        state, m = step(state, batch)
        first.append(float(m["loss"]))
    state = acc.load_state(path, train_state=state)
    restored = all(torch.equal(a, b) for a, b in zip(saved, tree_leaves(state.params)))
    again = []
    for batch in batches[1:]:
        state, m = step(state, batch)
        again.append(float(m["loss"]))
    files = sorted(os.listdir(os.path.join(path, "sharded_state")))
    shards = [tuple(t.shape) for t in tree_leaves(state.params)]
    return {"first": first, "again": again, "restored": restored, "files": files,
            "shards": shards, "step": state.step, "saved_whole": saved_whole}


def fp8_lora_steps(np_params, batches, cfg_kw: dict, mesh_kw, lr: float,
                   plugin_kw=None) -> dict:
    """``Accelerator.build_train_step`` over ``llama.loss_fn`` for a ``use_fp8`` config
    (delayed scaling, ``fused_adamw`` with O2's scaled-fp8 moments) or a LoRA one (``lora_optimizer(adamw)``), on
    the mesh of ``mesh_kw`` with ``partition_specs`` (None: one process): per step the
    loss and the gathered params; the last amax history; whether the adapters moved
    and the base stayed. ``plugin_kw``: a ``FullyShardedDataParallelPlugin`` (ZeRO)."""
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama, lora
    from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.parallel import MeshConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
    from accelerate_tpu_torch.utils.dataclasses import (FP8RecipeKwargs,
                                                        FullyShardedDataParallelPlugin)

    _threads()
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    # A tp-sharded head takes the vocab-sharded CE; one process the chunked one.
    tp = mesh_kw is not None and mesh_kw.get("tp", 1) > 1
    cfg = _config({**cfg_kw, "attn_impl": "xla", "loss_impl": "fused_tp" if tp else "auto"})
    handlers = ([FP8RecipeKwargs(use_delayed_scaling=True, amax_history_len=4, opt_level="O2")]
                if cfg.use_fp8 else None)
    acc = Accelerator(device="cpu", kwargs_handlers=handlers,
                      mesh_config=None if mesh_kw is None else MeshConfig(**mesh_kw),
                      fsdp_plugin=None if plugin_kw is None
                      else FullyShardedDataParallelPlugin(**plugin_kw))
    tx = lora.lora_optimizer(optim.adamw(lr)) if cfg.lora_rank else fused_adamw(lr)
    state = acc.create_train_state(
        params_from_jax(np_params, cfg, device="cpu", master_dtype=torch.float32), tx,
        partition_specs=None if mesh_kw is None else llama.partition_specs(cfg))
    specs = acc._param_specs  # the placed specs: the plan's, with fsdp where ZeRO-3 adds it
    first = params_to_numpy(state.params, mesh=acc.mesh, specs=specs)
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg))
    out = {"losses": [], "params": []}
    for batch in batches:
        state, metrics = step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        out["params"].append(params_to_numpy(state.params, mesh=acc.mesh, specs=specs))
    if state.fp8_state is not None:
        out["history"] = state.fp8_state.history.numpy().copy()
    last = out["params"][-1]["layers"]
    out["adapters_moved"] = any(not np.array_equal(a[k], b[k]) for a, b in
                                zip(first["layers"], last) for k in a if "_lora_" in k)
    out["base_unchanged"] = all(np.array_equal(a[k], b[k]) for a, b in
                                zip(first["layers"], last) for k in a if "_lora_" not in k)
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    return out


def _reset_accelerator_state() -> None:
    """A fresh ``AcceleratorState``/``GradientState`` (the process group stays)."""
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()


def _resident_bytes(state) -> int:
    """Bytes of this rank's params, optimizer moments and accumulation buffers."""
    from accelerate_tpu_torch.utils.tree import tree_leaves

    trees = (state.params, state.opt_state, state.grad_accum)
    return sum(t.numel() * t.element_size() for tree in trees for t in tree_leaves(tree)
               if torch.is_tensor(t) and t.dim() > 0)


def zero_problem_steps(np_params, batch, cases: dict) -> dict:
    """Per case ``{name: {"mesh", "plugin", "accum", "steps", "opt", "clip"}}``: the JAX
    ZeRO test's two-layer problem trained through ``Accelerator.build_train_step`` on
    the case's mesh with ``FullyShardedDataParallelPlugin(**plugin)`` (None: no
    plugin): per step the loss (and grad norm), the whole params after the last step
    (``get_state_dict``), the state's splits, resident bytes and where the moments
    live."""
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.parallel import MeshConfig
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin
    from accelerate_tpu_torch.utils.tree import tree_leaves

    _threads()
    out = {}
    for name, case in cases.items():
        _reset_accelerator_state()
        plugin = (None if case.get("plugin") is None
                  else FullyShardedDataParallelPlugin(**case["plugin"]))
        acc = Accelerator(device="cpu", fsdp_plugin=plugin,
                          mesh_config=None if case.get("mesh") is None
                          else MeshConfig(**case["mesh"]),
                          gradient_accumulation_steps=case.get("accum", 1))
        tx = fused_adamw(1e-2) if case.get("opt") == "fused" else optim.adamw(1e-2)
        state = acc.create_train_state({k: torch.tensor(v) for k, v in np_params.items()}, tx)

        def loss_fn(p, b):
            h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
            return torch.mean((h @ p["w2"] - b["y"]) ** 2)

        step = acc.build_train_step(loss_fn, max_grad_norm=case.get("clip"))
        res = {"losses": [], "grad_norms": []}
        for _ in range(case.get("steps", 4) * case.get("accum", 1)):
            state, metrics = step(state, batch)
            res["losses"].append(float(metrics["loss"]))
            if "grad_norm" in metrics:
                res["grad_norms"].append(float(metrics["grad_norm"]))
        res["params"] = {k: v.numpy().copy() for k, v in acc.get_state_dict(state.params).items()}
        # The TrainState gathers by its own dims; whole params are not this layout's pieces
        # wherever fsdp splits a leaf.
        res["state_dict_of_state_equal"] = all(
            torch.equal(v, acc.get_state_dict(state)[k]) for k, v in
            acc.get_state_dict(state.params).items())
        try:
            acc.get_state_dict({k: torch.tensor(v) for k, v in np_params.items()})
            res["whole_params_refused"] = False
        except ValueError:
            res["whole_params_refused"] = True
        res["fsdp_dims"], res["zero_dims"] = state.fsdp_dims, state.zero_dims
        res["resident_bytes"] = _resident_bytes(state)
        res["param_shapes"] = {k: tuple(v.shape) for k, v in state.params.items()}
        res["mu_shapes"] = {k: tuple(v.shape) for k, v in state.opt_state.mu.items()}
        res["accum_shapes"] = (None if state.grad_accum is None else
                               {k: tuple(v.shape) for k, v in state.grad_accum.items()})
        res["distributed_type"] = str(acc.distributed_type)
        res["mesh"] = None if acc.mesh is None else dict(acc.mesh.shape)
        res["moments_on"] = sorted({str(t.device) for t in tree_leaves(state.opt_state.mu)})
        out[name] = res
    _reset_accelerator_state()
    return out


def _plain_specs(specs):
    """A spec tree with each ``P`` as a plain tuple (a ``P`` does not survive pickling)."""
    from accelerate_tpu_torch.utils.tree import tree_map

    return tree_map(lambda spec: ("P", *spec), specs)


def fsdp_llama_steps(np_params, batches, cfg_kw: dict, mesh_kw: dict, plugin_kw: dict,
                     lr: float, clip, lazy: bool = True, tp_specs: bool = False) -> dict:
    """``Accelerator.build_train_step`` over ``llama.loss_fn`` (marked to gather its
    ``FsdpShard`` leaves itself when ``lazy``, else wrapped in a plain lambda: the
    whole-tree gather) with ``fused_adamw`` under ``FullyShardedDataParallelPlugin(
    **plugin_kw)`` on the mesh of ``mesh_kw`` (``tp_specs``: the model's
    ``partition_specs`` too): per step the loss, the grad norm and the whole params;
    the placed specs, the collective routes taken and the kernel's (CPU) calls."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.parallel import MeshConfig, fsdp
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    _threads()
    _reset_accelerator_state()
    cfg = _config(cfg_kw)
    acc = Accelerator(device="cpu", mesh_config=MeshConfig(**mesh_kw),
                      fsdp_plugin=FullyShardedDataParallelPlugin(**plugin_kw))
    state = acc.create_train_state(
        params_from_jax(np_params, cfg, device="cpu", master_dtype=torch.float32),
        fused_adamw(lr), partition_specs=llama.partition_specs(cfg) if tp_specs else None)
    loss = (fsdp.gathers_fsdp_shards(lambda p, b: llama.loss_fn(p, b, cfg)) if lazy
            else (lambda p, b: llama.loss_fn(p, b, cfg)))
    step = acc.build_train_step(loss, max_grad_norm=clip)
    fsdp.reset_stats()
    out = {"losses": [], "grad_norms": [], "params": [],
           "specs": _plain_specs(acc._param_specs), "distributed_type": str(acc.distributed_type),
           "fsdp_dims": state.fsdp_dims, "resident_bytes": _resident_bytes(state)}
    for batch in batches:
        state, metrics = step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        whole = acc.get_state_dict(state.params)
        out["params"].append({"embed": whole["embed"].numpy().copy(),
                              "ln_f": whole["ln_f"].numpy().copy(),
                              "layers": [{k: v.numpy().copy() for k, v in layer.items()}
                                         for layer in whole["layers"]],
                              **({"lm_head": whole["lm_head"].numpy().copy()}
                                 if "lm_head" in whole else {})})
    out["stats"] = dict(fsdp.STATS)
    _reset_accelerator_state()
    return out


def whole_state(acc, state) -> dict:
    """``{path: numpy}`` of every tensor leaf of a train state, each gathered whole from
    the ranks' pieces (a collective), and its plain values as they are."""
    from accelerate_tpu_torch import checkpointing as ck

    flat = ck._flat_state(state)
    split = ck._split_dims(state, flat, acc.mesh)
    return {p: (ck._whole_leaf(v, split.get(p, (None, None)), acc.mesh).numpy().copy()
                if torch.is_tensor(v) else v) for p, v in flat.items()}


def fsdp_checkpoint_round_trip(np_params, batch, directory: str, one_dir: str) -> dict:
    """The ZeRO test's problem on dp1×fsdp2 (``fused_adamw``, ``min_weight_size=1``):

    - ``full``: ZeRO-3, FULL_STATE_DICT saved after a step (into ``full`` and
      ``switch``), two more steps, loaded back in place, the two steps again; then a
      SHARDED save into ``switch``, loaded back;
    - ``sharded``: ZeRO-3 saved SHARDED after a step (for the one-process reshard and
      ``merge-weights``), with the whole state at the save;
    - ``from_one``: ``one_dir`` (a one-process ZeRO-0 checkpoint) loaded into a ZeRO-3
      and a ZeRO-1 state (the reshard from 1 to 2 ranks), their whole states.
    """
    import os

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.parallel import MeshConfig
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    _threads()

    def setup(stage, sdt="SHARDED_STATE_DICT"):
        _reset_accelerator_state()
        acc = Accelerator(device="cpu", mesh_config=MeshConfig(dp=1, fsdp=2),
                          fsdp_plugin=FullyShardedDataParallelPlugin(
                              zero_stage=stage, min_weight_size=1, state_dict_type=sdt))
        state = acc.create_train_state({k: torch.tensor(v) for k, v in np_params.items()},
                                       fused_adamw(1e-2))

        def loss_fn(p, b):
            h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
            return torch.mean((h @ p["w2"] - b["y"]) ** 2)

        return acc, state, acc.build_train_step(loss_fn)

    out = {}
    acc, state, step = setup(3, "FULL_STATE_DICT")
    state, m = step(state, batch)
    path = acc.save_state(os.path.join(directory, "full"), train_state=state)
    switch = acc.save_state(os.path.join(directory, "switch"), train_state=state)
    saved = whole_state(acc, state)
    first = []
    for _ in range(2):
        state, m = step(state, batch)
        first.append(float(m["loss"]))
    files_full = sorted(os.listdir(path))
    state = acc.load_state(path, train_state=state)
    restored = whole_state(acc, state)
    again = []
    for _ in range(2):
        state, m = step(state, batch)
        again.append(float(m["loss"]))
    acc.fsdp_plugin.state_dict_type = "SHARDED_STATE_DICT"
    acc.save_state(switch, train_state=state)
    switched = whole_state(acc, state)
    files_switched = sorted(os.listdir(switch))
    state = acc.load_state(switch, train_state=state)
    out["full"] = {"saved": saved, "restored": restored, "first": first, "again": again,
                   "files_full": files_full, "files_switched": files_switched,
                   "switched": switched, "reloaded": whole_state(acc, state)}

    acc, state, step = setup(3)
    state, _ = step(state, batch)
    acc.save_state(os.path.join(directory, "sharded"), train_state=state)
    out["sharded"] = {"saved": whole_state(acc, state), "losses": []}
    for _ in range(2):
        state, m = step(state, batch)
        out["sharded"]["losses"].append(float(m["loss"]))

    out["from_one"] = {}
    for stage in (3, 1):
        acc, state, step = setup(stage)
        state = acc.load_state(one_dir, train_state=state)
        loaded = whole_state(acc, state)
        state, m = step(state, batch)
        out["from_one"][stage] = {"loaded": loaded, "loss": float(m["loss"]),
                                  "stats": acc.checkpoint_stats["load"]}
    _reset_accelerator_state()
    return out


def _share_to_plain(share):
    """A ``split_between_processes`` share as plain values: a tensor as
    ``("tensor", dtype, values)``, a dict value by value."""
    if isinstance(share, dict):
        return {k: _share_to_plain(v) for k, v in share.items()}
    if torch.is_tensor(share):
        return ("tensor", str(share.dtype), share.numpy().copy())
    return share


def process_control(order_file: str, split_cases: dict) -> dict:
    """The process control of ``Accelerator``/``PartialState`` on this rank: the order
    in which the ranks write to ``order_file`` inside ``main_process_first`` and
    ``local_main_process_first`` (the first process sleeps before its write, so an
    unordered body would let another rank write first), this rank's share of each
    ``split_cases`` input with and without padding, the ``on_*`` decorators, and
    ``check_trigger`` twice after rank 1's ``set_trigger``."""
    import time

    from accelerate_tpu_torch.accelerator import Accelerator

    _threads()
    _reset_accelerator_state()
    acc = Accelerator(device="cpu")
    rank = acc.process_index
    out = {"rank": rank, "local_process_index": acc.local_process_index,
           "is_last_process": acc.is_last_process, "use_distributed": acc.use_distributed}
    for name, first in (("main_process_first", acc.is_main_process),
                        ("local_main_process_first", acc.is_local_main_process)):
        with getattr(acc, name)():
            if first:
                time.sleep(0.5)
            with open(f"{order_file}.{name}", "a") as f:
                f.write(f"{rank}\n")
        acc.wait_for_everyone()
    out["split"] = {}
    for kind, inputs in split_cases.items():
        for padding in (False, True):
            value = torch.tensor(inputs) if kind.startswith("tensor") else inputs
            with acc.split_between_processes(value, apply_padding=padding) as share:
                out["split"][kind, padding] = _share_to_plain(share)
    out["on"] = {"main": acc.on_main_process(lambda: rank)(),
                 "local_main": acc.on_local_main_process(lambda: rank)(),
                 "process_1": acc.on_process(process_index=1)(lambda: rank)(),
                 "last": acc.on_last_process(lambda: rank)()}
    if rank == 1:
        acc.set_trigger()
    out["trigger"] = [acc.check_trigger(), acc.check_trigger()]
    _reset_accelerator_state()
    return out


def tp_plugin_steps(np_params, batches, cfg_kw: dict, lr: float, max_grad_norm: float) -> dict:
    """``train_steps``' llama run on a tp axis of the world's size, built twice: through
    ``Accelerator(tp_plugin=TensorParallelPlugin(tp_size=n))`` and through
    ``mesh_config=MeshConfig(tp=n)``; per route the mesh's sizes, the distributed type
    and the losses and grad norms of each step. Then a ``mesh_config`` that disagrees
    with the plugin: the error it raises, and whether the state stayed uninitialized."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.parallel import MeshConfig
    from accelerate_tpu_torch.state import AcceleratorState
    from accelerate_tpu_torch.utils.dataclasses import TensorParallelPlugin

    import torch.distributed as dist

    _threads()
    n = dist.get_world_size()
    cfg = _config(cfg_kw)
    out = {}
    for route, kw in (("tp_plugin", {"tp_plugin": TensorParallelPlugin(tp_size=n)}),
                      ("mesh_config", {"mesh_config": MeshConfig(dp=1, tp=n)})):
        _reset_accelerator_state()
        acc = Accelerator(device="cpu", **kw)
        state = acc.create_train_state(
            params_from_jax(np_params, cfg, device="cpu", master_dtype=torch.float32),
            fused_adamw(lr), partition_specs=llama.partition_specs(cfg))
        step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg),
                                    max_grad_norm=max_grad_norm)
        run = {"mesh": dict(acc.mesh.shape), "distributed_type": str(acc.distributed_type),
               "losses": [], "grad_norms": []}
        for batch in batches:
            state, metrics = step(state, batch)
            run["losses"].append(float(metrics["loss"]))
            run["grad_norms"].append(float(metrics["grad_norm"]))
        out[route] = run
    _reset_accelerator_state()
    try:
        Accelerator(device="cpu", tp_plugin=TensorParallelPlugin(tp_size=n),
                    mesh_config=MeshConfig(dp=n))
        out["disagreeing"] = None
    except ValueError as e:
        out["disagreeing"] = str(e)
    out["left_uninitialized"] = "_partial" not in AcceleratorState._shared_state
    _reset_accelerator_state()
    return out


def run_all(jobs) -> list:
    """Each ``(function name, args)`` of ``jobs`` in turn, in one spawn of the ranks:
    their results in order."""
    return [globals()[name](*args) for name, args in jobs]
