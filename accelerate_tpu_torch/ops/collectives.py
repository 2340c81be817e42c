"""The cross-engine KV page transfer of disaggregated serving, with its byte and time
accounting: ``TransferStats``, ``tree_bytes`` and ``kv_page_transfer``, the port's
counterparts of ``accelerate_tpu/ops/collectives.py:151-292``.

The JAX call is ``jax.device_put`` of the page block onto the decode replica's
placement. Here the block is a list of per-layer dicts of tensors (what
``ContinuousBatcher.export_page_block`` gathers), and the move is ``Tensor.to`` on the
destination device: a peer copy between two cards, nothing at all when both replicas
live on one device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..telemetry.schemas import SERVING_HANDOFF_SCHEMA
from ..utils.tree import tree_leaves, tree_map

__all__ = ["TransferStats", "tree_bytes", "kv_page_transfer"]


@dataclasses.dataclass
class TransferStats:
    """Running byte/time accounting over transfers (one edge's, or a router's whole
    history); ``summary()`` is the ``stats()``-shaped dict."""

    count: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def record(self, nbytes: int, dur_s: float) -> None:
        self.count += 1
        self.bytes += int(nbytes)
        self.seconds += float(dur_s)

    def summary(self) -> dict:
        return {"transfers": self.count, "transfer_bytes": self.bytes,
                "transfer_s": round(self.seconds, 6)}


def tree_bytes(tree) -> int:
    """Total payload bytes of a tree (dicts, lists, tuples) of tensors."""
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(tree))


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def kv_page_transfer(block, *, src_replica: int, dst_replica: int, uid=None,
                     pages: Optional[int] = None, device=None,
                     stats: Optional[TransferStats] = None, telemetry=None):
    """Move one KV page block across the prefill → decode replica boundary →
    ``(block, nbytes, dur_s)``.

    ``device`` is the decode replica's device; None keeps the block where it is. When
    the block already lives there (both replicas on one card: the same-process case,
    as the JAX package's default placement) the move is a no-op: no byte moves, the
    block comes back as it was and ``dur_s`` is 0.0. To another device it is a peer
    copy (``Tensor.to``) that either lands every tensor there or raises; every device
    involved is synchronized before the clock starts and again before it stops, so
    ``dur_s`` is the copy itself, not the dispatch or earlier queued work.

    Every call records into ``stats`` and, when ``telemetry`` is enabled, emits one
    ``serving.handoff/v1`` record (source and destination replica, uid, pages, bytes,
    seconds). ``nbytes`` is the block's payload: the port's block holds only the
    handoff's real pages, where the JAX block is table-width."""
    nbytes = tree_bytes(block)
    leaves = tree_leaves(block)
    dst = None if device is None else torch.device(device)
    if dst is not None and dst.type == "cuda" and dst.index is None:
        dst = torch.device("cuda", torch.cuda.current_device())
    if dst is None or all(t.device == dst for t in leaves):
        dur = 0.0
        out = block
    else:
        devices = {t.device for t in leaves} | {dst}
        _sync(devices)
        t0 = time.perf_counter()
        out = tree_map(lambda t: t.to(dst), block)
        _sync(devices)
        dur = time.perf_counter() - t0
        moved = [t for t in tree_leaves(out) if t.device != dst]
        if moved:
            raise RuntimeError(f"kv_page_transfer: {len(moved)} tensors did not land on {dst}")
    if stats is not None:
        stats.record(nbytes, dur)
    if telemetry is not None and getattr(telemetry, "enabled", False):
        telemetry.emit({
            "schema": SERVING_HANDOFF_SCHEMA, "src_replica": int(src_replica),
            "dst_replica": int(dst_replica), "uid": uid, "pages": pages,
            "nbytes": nbytes, "dur_s": round(dur, 6),
        })
    return out, nbytes, dur
