"""Sharded safetensors checkpoints: the port's copy of the part of
``accelerate_tpu/utils/modeling.py`` that writes and streams them —
``save_sharded_checkpoint`` with ``convert_file_size_to_int``, ``named_parameters`` and
``iter_safetensors`` (``utils/serialization.read_safetensors``).

Leaves are addressed by ``/``-joined key paths (``utils/serialization.py``'s convention).
The big-model placement half of the JAX module (device maps, memory budgets, offload)
is not ported.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Union

import torch

from .constants import SAFE_WEIGHTS_INDEX_NAME, SAFE_WEIGHTS_NAME
from .serialization import flatten_pytree, read_safetensors, save_pytree_safetensors

__all__ = ["named_parameters", "convert_file_size_to_int", "save_sharded_checkpoint",
           "iter_safetensors"]

#: ``(name, tensor)`` one at a time, each over one copy-on-write map of the file.
iter_safetensors = read_safetensors


def named_parameters(tree: Any) -> dict[str, Any]:
    """A params tree flattened to ``{'a/b/c': leaf}``."""
    return flatten_pytree(tree)


def _leaf_size(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return int(getattr(leaf, "nbytes", 0))


def convert_file_size_to_int(size: Union[int, str]) -> int:
    """``"6GB"``/``"6GiB"``-style sizes in bytes."""
    if isinstance(size, int):
        return size
    mult = {
        "TIB": 2**40, "GIB": 2**30, "MIB": 2**20, "KIB": 2**10,
        "TB": 10**12, "GB": 10**9, "MB": 10**6, "KB": 10**3,
    }
    s = size.upper().strip()
    for suffix, m in mult.items():
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * m)
    try:
        return int(s)
    except ValueError:
        raise ValueError(f"`size` {size!r} is not in a valid format.") from None


def save_sharded_checkpoint(tree: Any, save_dir: Union[str, Path],
                            max_shard_size: Union[int, str] = "5GB") -> dict:
    """Write a tree as ``model.safetensors`` when it fits one shard of
    ``max_shard_size``, else as ``model-00001-of-0000N.safetensors`` files and
    ``model.safetensors.index.json`` (``weight_map`` keyed by ``/``-joined paths), the
    leaves split in flattening order; returns the index."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    limit = convert_file_size_to_int(max_shard_size)
    flat = named_parameters(tree)

    shards: list[dict[str, Any]] = [{}]
    shard_bytes = 0
    for name, leaf in flat.items():
        size = _leaf_size(leaf)
        if shard_bytes + size > limit and shards[-1]:
            shards.append({})
            shard_bytes = 0
        shards[-1][name] = leaf
        shard_bytes += size

    if len(shards) == 1:
        save_pytree_safetensors(shards[0], save_dir / SAFE_WEIGHTS_NAME)
        return {"weight_map": {k: SAFE_WEIGHTS_NAME for k in flat}}

    weight_map = {}
    total = sum(_leaf_size(v) for v in flat.values())
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_pytree_safetensors(shard, save_dir / fname)
        for k in shard:
            weight_map[k] = fname
    index = {"metadata": {"total_size": total}, "weight_map": weight_map}
    with open(save_dir / SAFE_WEIGHTS_INDEX_NAME, "w") as f:
        json.dump(index, f, indent=2)
    return index
