"""Function launcher: ``notebook_launcher``, the port's counterpart of
``accelerate_tpu/launchers.py``.

In JAX one process drives every local chip, so the JAX launcher spawns processes only
to simulate several hosts. Here every rank is a process: ``notebook_launcher`` spawns
``num_processes`` of them with ``torch.multiprocessing`` (the ``spawn`` start method,
since the parent may already hold a CUDA context), gives each ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK`` and a rendezvous (a ``FileStore`` in a fresh temporary directory, so
launches running side by side never share one), joins the process group in each rank
with the device and backend the caller names (``state.PartialState``), runs
``function(*args)`` there and returns the ranks' results in rank order. A rank that
raises fails the call: the other ranks are stopped and the rank's traceback is raised
in the parent.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Optional, Sequence, Union

import torch
import torch.multiprocessing as mp

__all__ = ["notebook_launcher"]

DeviceArg = Union[None, str, torch.device, Sequence]


def _rank_device(device: DeviceArg, index: int):
    if isinstance(device, (list, tuple)):
        return device[index]
    return device


def _child(index: int, function, args: tuple, world: int, init_method: str, device: DeviceArg,
           backend: Optional[str], timeout_s: Optional[float], result_dir: str) -> None:
    os.environ.update(RANK=str(index), WORLD_SIZE=str(world), LOCAL_RANK=str(index))
    from .state import PartialState

    state = PartialState(device=_rank_device(device, index), backend=backend,
                         init_method=init_method, rank=index, world_size=world,
                         timeout_s=timeout_s)
    try:
        result = function(*args)
        with open(os.path.join(result_dir, f"{index}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        state.destroy_process_group()


def notebook_launcher(function, args: tuple = (), num_processes: Optional[int] = None, *,
                      device: DeviceArg = None, backend: Optional[str] = None,
                      timeout_s: Optional[float] = None) -> list:
    """Run ``function(*args)`` in ``num_processes`` ranks and return their results (a
    list in rank order; they must pickle). ``device``: one device for every rank, or a
    list with one per rank; ``None`` is CUDA (``cuda:RANK`` under NCCL). ``backend``:
    ``nccl`` by default for CUDA ranks, ``gloo`` for CPU ranks; name ``gloo`` where ranks
    share a card. ``timeout_s`` bounds every collective. With ``num_processes`` None or 1 the
    function runs in this process, which joins no group."""
    if not num_processes or num_processes == 1:
        return [function(*args)]
    tmp = tempfile.mkdtemp(prefix="accelerate_tpu_torch_launch_")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    try:
        mp.start_processes(
            _child, args=(function, tuple(args), num_processes, init_method, device, backend,
                          timeout_s, tmp),
            nprocs=num_processes, join=True, start_method="spawn")
        results = []
        for index in range(num_processes):
            with open(os.path.join(tmp, f"{index}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
        raise RuntimeError(f"rank {err.error_index} of {num_processes} failed:\n{err}") from err
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
