"""``python -m accelerate_tpu_torch merge-weights``: a checkpoint's train state as
consolidated safetensors, the port's counterpart of ``accelerate_tpu/commands/merge.py``.

The JAX command restores an orbax ``sharded_state`` tree; this one reads the port's own
byte format (``checkpointing``: ``sharded_state/rank{r}.json`` indexes and their
``rank{r}_{i:05d}.bin`` files, or a FULL_STATE_DICT ``model_full.pkl``) with no process
group and no device. Each leaf is rebuilt from its bytes; a leaf split over the tp or
fsdp ranks (or both) is put back together by placing one piece per distinct place the
index records (the tp and fsdp split dims and indexes). The params (or, with
``--full-state``, the whole train state: moments, accumulation buffer and counts) are
written by ``utils.modeling.save_sharded_checkpoint`` under the JAX params tree's names
(``layers/0/wq``), one ``model.safetensors`` or several shards with an index.
"""

from __future__ import annotations

import argparse
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


def read_sharded_state(checkpoint_dir, prefix: str = "") -> dict:
    """``{path: whole tensor or plain value}`` of a checkpoint's train state, every
    rank's pieces put back together (paths as the checkpoint's index names them:
    ``params/layers/0/wq``, ``opt_state/...``, ``step``); only the paths that start with
    ``prefix`` are read. A FULL_STATE_DICT checkpoint (``model_full.pkl``) is read from
    its one file."""
    from ..checkpointing import (FULL_STATE_NAME, leaf_box, leaf_whole_shape, read_full_index,
                                 read_full_leaf, read_leaf, saved_indexes)

    path = Path(checkpoint_dir)
    if not (path / SHARDED_STATE_DIR).is_dir() and (path / FULL_STATE_NAME).exists():
        index = read_full_index(path)
        return {p: e["value"] if "value" in e else read_full_leaf(path, index, p)
                for p, e in index["leaves"].items() if p.startswith(prefix)}
    if (path / SHARDED_STATE_DIR).is_dir():
        path = path / SHARDED_STATE_DIR
    indexes = saved_indexes(path)
    out = {}
    for k, leaf in enumerate(indexes[0]["leaves"]):
        if not leaf["path"].startswith(prefix):
            continue
        if "value" in leaf:
            out[leaf["path"]] = leaf["value"]
            continue
        whole = torch.empty(leaf_whole_shape(leaf, indexes[0]),
                            dtype=getattr(torch, leaf["dtype"]))
        seen = []
        # One rank per distinct piece (the others repeat it): each is put in its place.
        for index in indexes:
            piece_leaf = index["leaves"][k]
            piece_box = leaf_box(piece_leaf, index)
            if piece_box in seen:
                continue
            seen.append(piece_box)
            whole[tuple(slice(s, s + n) for s, n in piece_box)] = read_leaf(
                path, index, piece_leaf)
        out[leaf["path"]] = whole
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
