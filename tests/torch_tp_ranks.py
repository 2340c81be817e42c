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
    shards equal the saved ones, the files in the state directory and the shards'
    shapes."""
    import os

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax
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
            "shards": shards, "step": state.step}


def run_all(jobs) -> list:
    """Each ``(function name, args)`` of ``jobs`` in turn, in one spawn of the ranks:
    their results in order."""
    return [globals()[name](*args) for name, args in jobs]
