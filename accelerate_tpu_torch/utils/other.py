"""Miscellaneous helpers: the port's copies of ``accelerate_tpu/utils/other.py``'s
``get_free_port``, ``is_port_in_use``, ``convert_bytes``, ``merge_dicts`` and ``save``."""

from __future__ import annotations

import os
import pickle
import socket
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .operations import _world_size
from .tree import tree_leaves

__all__ = ["get_free_port", "is_port_in_use", "convert_bytes", "merge_dicts", "save"]


def convert_bytes(size: float) -> str:
    """A byte count in human units."""
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if size < 1024.0:
            return f"{round(size, 2)} {unit}"
        size /= 1024.0
    return f"{round(size, 2)} PB"


def get_free_port() -> int:
    """An unused TCP port for a single-host rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def is_port_in_use(port: Optional[int] = None) -> bool:
    """True if ``port`` (default 29500) is already bound on localhost: a stale
    rendezvous before a launch."""
    if port is None:
        port = 29500
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        return s.connect_ex(("localhost", int(port))) == 0


def merge_dicts(source: dict, destination: dict) -> dict:
    """Merge ``source`` into ``destination``, recursively."""
    for key, value in source.items():
        if isinstance(value, dict) and isinstance(destination.get(key), dict):
            merge_dicts(value, destination[key])
        else:
            destination[key] = value
    return destination


def _is_arrays_tree(obj: Any) -> bool:
    leaves = tree_leaves(obj)
    return len(leaves) > 0 and all(torch.is_tensor(x) or isinstance(x, np.ndarray)
                                   for x in leaves)


def save(obj, f, save_on_each_node: bool = False, safe_serialization: bool = True) -> None:
    """Save ``obj`` once (the main process) or once per node (each node's local main
    process), then wait for every process. A tree of tensors or arrays goes to
    safetensors (``/``-joined keys), anything else is pickled; the write is atomic (a
    temporary file, then a rename)."""
    from ..state import PartialState

    st = PartialState._shared_state  # one process until a state is initialised
    key = "local_process_index" if save_on_each_node else "process_index"
    should_write = st.get(key, 0) == 0
    if should_write:
        f = Path(f)
        f.parent.mkdir(parents=True, exist_ok=True)
        tmp = f.with_name(f.name + ".tmp")
        if safe_serialization and _is_arrays_tree(obj):
            from .serialization import save_pytree_safetensors

            save_pytree_safetensors(obj, tmp)
        else:
            with open(tmp, "wb") as fh:
                pickle.dump(obj, fh)
        os.replace(tmp, f)
    if _world_size() > 1:
        dist.barrier()
