"""``python -m accelerate_tpu_torch merge-weights``: a checkpoint's train state as
consolidated safetensors, the port's counterpart of ``accelerate_tpu/commands/merge.py``.

The JAX command restores an orbax ``sharded_state`` tree; this one reads the port's own
byte format (``checkpointing``: ``sharded_state/rank{r}.json`` indexes and their
``rank{r}_{i:05d}.bin`` files) with no process group and no device. Each leaf is rebuilt
from its bytes; a leaf split over the tp ranks is put back together by concatenating one
shard per tp index along the dim the index records. The params (or, with
``--full-state``, the whole train state: moments, accumulation buffer and counts) are
written by ``utils.modeling.save_sharded_checkpoint`` under the JAX params tree's names
(``layers/0/wq``), one ``model.safetensors`` or several shards with an index.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..utils.constants import SHARDED_STATE_DIR
from ..utils.modeling import save_sharded_checkpoint
from ..utils.tree import listify_int_dicts, unflatten_to_nested_dict

__all__ = ["merge_command", "merge_command_parser", "merge_weights", "read_sharded_state"]


def merge_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Merge an accelerate_tpu_torch checkpoint into consolidated safetensors."
    if subparsers is not None:
        parser = subparsers.add_parser("merge-weights", description=description)
    else:
        parser = argparse.ArgumentParser("python -m accelerate_tpu_torch merge-weights",
                                         description=description)
    parser.add_argument("checkpoint_dir",
                        help="Checkpoint dir (containing sharded_state/) or sharded_state itself.")
    parser.add_argument("output_dir", help="Where to write model.safetensors[.index.json].")
    parser.add_argument("--max-shard-size", "--max_shard_size", default="5GB")
    parser.add_argument("--full-state", "--full_state", action="store_true",
                        help="Export the whole train state (optimizer moments, counters) "
                             "instead of only the params.")
    parser.add_argument("--params-only", "--params_only", action="store_true",
                        help="No-op (params only is the default; see --full-state).")
    if subparsers is not None:
        parser.set_defaults(func=merge_command)
    return parser


def _read_leaf(state_dir: Path, index: dict, leaf: dict) -> torch.Tensor:
    """One rank's leaf from its files, as a CPU tensor."""
    buf = bytearray(leaf["nbytes"])
    fb, pos, end = index["file_bytes"], leaf["offset"], leaf["offset"] + leaf["nbytes"]
    view = memoryview(buf)
    while pos < end:
        i, off = divmod(pos, fb)
        n = min(end - pos, fb - off)
        with open(state_dir / f"rank{index['rank']}_{i:05d}.bin", "rb") as f:
            f.seek(off)
            f.readinto(view[pos - leaf["offset"]:pos - leaf["offset"] + n])
        pos += n
    dtype = getattr(torch, leaf["dtype"])
    t = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
    return t.view(dtype).reshape(leaf["shape"])


def read_sharded_state(checkpoint_dir, prefix: str = "") -> dict:
    """``{path: whole tensor or plain value}`` of a checkpoint's train state, every
    rank's shards put back together (paths as the checkpoint's index names them:
    ``params/layers/0/wq``, ``opt_state/...``, ``step``); only the paths that start with
    ``prefix`` are read."""
    path = Path(checkpoint_dir)
    if (path / SHARDED_STATE_DIR).is_dir():
        path = path / SHARDED_STATE_DIR
    first = json.loads((path / "rank0.json").read_text())
    indexes = [first] + [json.loads((path / f"rank{r}.json").read_text())
                         for r in range(1, first["world"])]
    # One rank per tp index holds each shard of a split leaf (the others repeat it).
    by_tp = {}
    for index in indexes:
        tp = index.get("tp") or {"size": 1, "index": 0}
        by_tp.setdefault(tp["index"], index)
    tp_ranks = [by_tp[i] for i in sorted(by_tp)]
    out = {}
    for k, leaf in enumerate(first["leaves"]):
        if not leaf["path"].startswith(prefix):
            continue
        if "value" in leaf:
            out[leaf["path"]] = leaf["value"]
            continue
        dim = leaf.get("split")
        if dim is None:
            out[leaf["path"]] = _read_leaf(path, first, leaf)
        else:
            out[leaf["path"]] = torch.cat(
                [_read_leaf(path, index, index["leaves"][k]) for index in tp_ranks], dim=dim)
    return out


def _tree(flat: dict) -> dict:
    """Flat ``/`` paths back into the nested tree (lists for integer keys), so the
    export's leaf order is the tree's (``layers/2`` before ``layers/10``)."""
    return listify_int_dicts(unflatten_to_nested_dict(flat))


def merge_weights(checkpoint_dir: str, output_dir: str, max_shard_size: str = "5GB",
                  params_only: bool = True) -> dict:
    """Rebuild the checkpoint's whole tensors on the host and write consolidated
    safetensors; returns the index (``weight_map``)."""
    if params_only:
        flat = {p.removeprefix("params/"): v
                for p, v in read_sharded_state(checkpoint_dir, "params/").items()}
    else:
        flat = {p: (v if torch.is_tensor(v) else torch.tensor(v))
                for p, v in read_sharded_state(checkpoint_dir).items() if v is not None}
    return save_sharded_checkpoint(_tree(flat), output_dir, max_shard_size=max_shard_size)


def merge_command(args) -> dict:
    index = merge_weights(args.checkpoint_dir, args.output_dir,
                          max_shard_size=args.max_shard_size, params_only=not args.full_state)
    n = len(set(index["weight_map"].values()))
    print(f"Merged checkpoint written to {args.output_dir} ({n} safetensors file(s)).")
    return index
