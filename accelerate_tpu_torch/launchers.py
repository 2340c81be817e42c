"""Function launchers: ``notebook_launcher`` and ``debug_launcher``, the port's
counterparts of ``accelerate_tpu/launchers.py``.

In JAX one process drives every local chip, so the JAX launcher spawns processes only
to simulate several hosts. Here every rank is a process: ``notebook_launcher`` spawns
``num_processes`` of them on this node with ``torch.multiprocessing`` (the ``spawn``
start method, since the parent may already hold a CUDA context), each a
``utils.launch.PrepareForLaunch`` that sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``,
joins the process group with the device and backend the caller names
(``state.PartialState``) and runs ``function(*args)``; the ranks' results come back in
rank order. The rendezvous is a ``FileStore`` in a fresh temporary directory on one node
(launches running side by side never share one) and ``tcp://master_addr:port`` across
``num_nodes`` nodes, where node ``node_rank`` runs global ranks
``node_rank × num_processes`` onwards.

A rank that raises fails the attempt: the other ranks are stopped. With
``max_restarts`` the whole group is launched again on a fresh rendezvous (a new
directory, or a new port when none was given), as JAX relaunches on a fresh coordinator;
once the budget is spent the rank's traceback is raised in the parent with every rank's
exit code.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Optional, Sequence, Union

import torch
import torch.multiprocessing as mp

from .utils.environment import patch_environment
from .utils.launch import PrepareForLaunch
from .utils.other import get_free_port

__all__ = ["notebook_launcher", "debug_launcher"]

DeviceArg = Union[None, str, torch.device, Sequence]


def _child(index: int, prepared: PrepareForLaunch, args: tuple, result_dir: str) -> None:
    result = prepared(index, *args)
    with open(os.path.join(result_dir, f"{index}.pkl"), "wb") as f:
        pickle.dump(result, f)


def notebook_launcher(function, args: tuple = (), num_processes: Optional[int] = None,
                      mixed_precision: str = "no", use_port: Union[str, int, None] = None,
                      master_addr: str = "127.0.0.1", node_rank: int = 0, num_nodes: int = 1,
                      max_restarts: int = 0, *, device: DeviceArg = None,
                      backend: Optional[str] = None,
                      timeout_s: Optional[float] = None) -> list:
    """Run ``function(*args)`` in ``num_processes`` ranks on this node and return their
    results (a list in rank order; they must pickle). ``device``: one device for every
    rank, or a list with one per rank; ``None`` is CUDA (``cuda:LOCAL_RANK`` under NCCL).
    ``backend``: ``nccl`` by default for CUDA ranks, ``gloo`` for CPU ranks; name ``gloo``
    where ranks share a card. ``timeout_s`` bounds every collective. ``mixed_precision``
    is written to ``ACCELERATE_MIXED_PRECISION``, which the ranks inherit.
    ``max_restarts``: failed attempts relaunched, each on a fresh rendezvous. With one
    process on one node the function runs in this process, which joins no group."""
    if mixed_precision and mixed_precision != "no":
        os.environ["ACCELERATE_MIXED_PRECISION"] = str(mixed_precision).lower()
    if (not num_processes or num_processes == 1) and num_nodes == 1:
        return [function(*args)]
    if not 0 <= node_rank < num_nodes:
        raise ValueError(f"node_rank={node_rank} is not in [0, {num_nodes})")
    world = num_processes * num_nodes
    for attempt in range(max_restarts + 1):
        tmp = tempfile.mkdtemp(prefix="accelerate_tpu_torch_launch_")
        if num_nodes > 1:
            port = use_port if use_port is not None and attempt == 0 else get_free_port()
            init_method = f"tcp://{master_addr}:{port}"
        else:
            init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        prepared = PrepareForLaunch(function, num_processes, init_method, num_nodes=num_nodes,
                                    node_rank=node_rank, device=device, backend=backend,
                                    timeout_s=timeout_s)
        try:
            ctx = mp.start_processes(_child, args=(prepared, tuple(args), tmp),
                                     nprocs=num_processes, join=False, start_method="spawn")
            try:
                while not ctx.join():
                    pass
            except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
                codes = [p.exitcode for p in ctx.processes]
                rank = node_rank * num_processes + err.error_index
                if attempt < max_restarts:
                    print(f"[notebook_launcher] rank {rank} failed, exit codes {codes}; "
                          f"restart {attempt + 1}/{max_restarts}", flush=True)
                    continue
                raise RuntimeError(
                    f"rank {rank} of {world} failed (exit codes {codes}, attempt "
                    f"{attempt + 1}/{max_restarts + 1}):\n{err}") from err
            results = []
            for index in range(num_processes):
                with open(os.path.join(tmp, f"{index}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    raise AssertionError("unreachable")


def debug_launcher(function, args: tuple = (), num_processes: int = 2) -> list:
    """CPU ranks over gloo for tests: ``notebook_launcher`` with
    ``ACCELERATE_USE_CPU=true``."""
    with patch_environment(ACCELERATE_USE_CPU="true"):
        return notebook_launcher(function, args, num_processes=num_processes, device="cpu",
                                 backend="gloo")
