"""Sequence packing: variable-length samples into fixed-shape rows (the port's
counterpart of ``accelerate_tpu/ops/packing.py``, host data code, no device kernel).

Padding every sequence to ``max_seq`` wastes compute in proportion to the padding
fraction, often 2-3x on instruction-tuning mixtures. Packing concatenates several
sequences per row with segment ids; the models keep attention inside each segment
(``models.llama.forward_hidden``'s ``segment_ids``: in the flash kernels' segment route
on the card) and restart positions per segment. llama consumes ``segment_ids``/
``positions`` directly (:func:`pack_sequences`); :func:`pack_seq2seq` lays out
(encoder, decoder) pairs with matching segment numbers.

The first-fit bin assignment and scatter run natively (``native/packing.cpp``, the
port's own copy, built by ``g++`` into ``build/native/`` at first use and loaded through
``native.load_native``), with a pure-Python version that gives the same bits: the tests
hold C++ == Python on random corpora. ``use_native=True`` raises when the library cannot
be built or loaded; ``None`` takes it when it loads.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

__all__ = ["pack_sequences", "pack_seq2seq", "packed_batch_iterator", "native_available"]

_lock = threading.Lock()
_lib = None
_build_failed = False


def _configure(lib: ctypes.CDLL) -> None:
    lib.pack_sequences_ffit.restype = ctypes.c_longlong
    lib.pack_sequences_ffit.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]


def _load_native():
    """The native packer, built once per process; None when no toolchain works."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            from ..native import load_native

            _lib = load_native("packing", _configure)
            _build_failed = _lib is None
    return _lib


def native_available() -> bool:
    return _load_native() is not None


# The first-fit scan appears three times: _pack_python (single capacity, mirrors
# native/packing.cpp bit for bit), pack_seq2seq (dual enc/dec capacity) and
# packed_batch_iterator (online, emits mid-stream). They carry different bin state; a
# change to the fit policy or the segment numbering changes all three (the tests hold
# native == Python and each variant against the JAX package's).
def _pack_python(flat, offsets, capacity, max_bins):
    """Reference implementation: must match native/packing.cpp bit for bit."""
    used: list[int] = []
    n_segs: list[int] = []
    assignments = []  # (bin, start, seg, seq_index, length)
    for i in range(len(offsets) - 1):
        length = int(offsets[i + 1] - offsets[i])
        if length > capacity or length < 0:
            return None
        if length == 0:
            continue
        bin_id = next((b for b in range(len(used)) if used[b] + length <= capacity), -1)
        if bin_id < 0:
            if len(used) >= max_bins:
                return None
            used.append(0)
            n_segs.append(0)
            bin_id = len(used) - 1
        n_segs[bin_id] += 1
        assignments.append((bin_id, used[bin_id], n_segs[bin_id], i, length))
        used[bin_id] += length
    n_bins = len(used)
    tokens = np.zeros((n_bins, capacity), np.int32)
    segments = np.zeros((n_bins, capacity), np.int32)
    positions = np.zeros((n_bins, capacity), np.int32)
    for bin_id, start, seg, i, length in assignments:
        tokens[bin_id, start:start + length] = flat[offsets[i]:offsets[i] + length]
        segments[bin_id, start:start + length] = seg
        positions[bin_id, start:start + length] = np.arange(length, dtype=np.int32)
    return tokens, segments, positions


def pack_sequences(
    sequences: Sequence[np.ndarray],
    seq_len: int,
    max_bins: Optional[int] = None,
    use_native: Optional[bool] = None,
) -> dict:
    """Pack variable-length int sequences into fixed [n_bins, seq_len] rows (first-fit).

    Returns ``{"tokens", "segment_ids", "positions"}`` int32 arrays. ``segment_ids`` is 0 on
    padding and 1..k per packed sequence within a row; ``positions`` restart at 0 per
    segment (feed them to the model so RoPE/causality are per-sequence). Raises
    ``ValueError`` if any sequence exceeds ``seq_len``.
    """
    seqs = [np.asarray(s, np.int32).ravel() for s in sequences]
    flat = np.concatenate(seqs) if seqs else np.zeros((0,), np.int32)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    if max_bins is None:
        # First-fit leaves at most one bin ≤ half full, so bins ≤ 2·total/capacity + 1;
        # len(seqs) also bounds it (one bin per sequence worst case).
        total = int(offsets[-1])
        max_bins = max(1, min(len(seqs), 2 * -(-total // max(seq_len, 1)) + 1))
    lib = _load_native() if use_native in (None, True) else None
    if use_native is True and lib is None:
        raise RuntimeError("native packer requested but unavailable (no g++?)")
    if lib is not None:
        out_t = np.zeros((max_bins, seq_len), np.int32)
        out_s = np.zeros((max_bins, seq_len), np.int32)
        out_p = np.zeros((max_bins, seq_len), np.int32)
        flat_c = np.ascontiguousarray(flat)
        n_bins = lib.pack_sequences_ffit(
            flat_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seqs), seq_len,
            out_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_bins,
        )
        if n_bins < 0:
            raise ValueError(
                f"packing failed: a sequence exceeds seq_len={seq_len} or max_bins="
                f"{max_bins} is too small"
            )
        # Copy: slicing a view would pin the whole [max_bins, seq_len] allocation.
        result = (
            out_t[:n_bins].copy(), out_s[:n_bins].copy(), out_p[:n_bins].copy()
        )
    else:
        packed = _pack_python(flat, offsets, seq_len, max_bins)
        if packed is None:
            raise ValueError(
                f"packing failed: a sequence exceeds seq_len={seq_len} or max_bins="
                f"{max_bins} is too small"
            )
        result = packed
    tokens, segments, positions = result
    return {"tokens": tokens, "segment_ids": segments, "positions": positions}


def pack_seq2seq(
    inputs: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    enc_len: int,
    dec_len: int,
    max_bins: Optional[int] = None,
) -> dict:
    """Pack (encoder input, decoder target) PAIRS into aligned fixed-shape rows (first-fit).

    Pair ``i`` goes to a row only when BOTH its sides fit; the pair receives the SAME
    segment number on the encoder and decoder side of that row, which is what lets
    cross-attention match decoder segment k to encoder segment k (``models/t5`` packed
    path). Returns ``{"input_ids", "enc_segment_ids", "labels", "dec_segment_ids"}``
    int32 arrays of widths ``enc_len`` / ``dec_len``; padding slots are 0 with segment 0
    (``labels`` padding is -100, the ignored-label convention).
    """
    if len(inputs) != len(targets):
        raise ValueError(f"{len(inputs)} inputs vs {len(targets)} targets")
    ins = [np.asarray(s, np.int32).ravel() for s in inputs]
    tgts = [np.asarray(s, np.int32).ravel() for s in targets]
    if max_bins is None:
        max_bins = max(1, len(ins))
    enc_used: list[int] = []
    dec_used: list[int] = []
    n_segs: list[int] = []
    assignments = []
    for i, (src, tgt) in enumerate(zip(ins, tgts)):
        if len(src) > enc_len or len(tgt) > dec_len:
            raise ValueError(
                f"pair {i} exceeds capacity (input {len(src)}>{enc_len} or "
                f"target {len(tgt)}>{dec_len})"
            )
        if len(src) == 0 and len(tgt) == 0:
            continue
        if len(src) == 0 or len(tgt) == 0:
            # Dropping only one side would silently discard the other's tokens — surface
            # the malformed pair instead (oversize pairs raise too).
            raise ValueError(f"pair {i} has an empty side (input {len(src)}, target {len(tgt)})")
        bin_id = next(
            (
                b
                for b in range(len(enc_used))
                if enc_used[b] + len(src) <= enc_len and dec_used[b] + len(tgt) <= dec_len
            ),
            -1,
        )
        if bin_id < 0:
            if len(enc_used) >= max_bins:
                raise ValueError(f"max_bins={max_bins} too small")
            enc_used.append(0)
            dec_used.append(0)
            n_segs.append(0)
            bin_id = len(enc_used) - 1
        n_segs[bin_id] += 1
        assignments.append((bin_id, enc_used[bin_id], dec_used[bin_id], n_segs[bin_id], i))
        enc_used[bin_id] += len(src)
        dec_used[bin_id] += len(tgt)
    n_bins = len(enc_used)
    input_ids = np.zeros((n_bins, enc_len), np.int32)
    enc_seg = np.zeros((n_bins, enc_len), np.int32)
    labels = np.full((n_bins, dec_len), -100, np.int32)
    dec_seg = np.zeros((n_bins, dec_len), np.int32)
    for bin_id, e0, d0, seg, i in assignments:
        src, tgt = ins[i], tgts[i]
        input_ids[bin_id, e0:e0 + len(src)] = src
        enc_seg[bin_id, e0:e0 + len(src)] = seg
        labels[bin_id, d0:d0 + len(tgt)] = tgt
        dec_seg[bin_id, d0:d0 + len(tgt)] = seg
    return {
        "input_ids": input_ids,
        "enc_segment_ids": enc_seg,
        "labels": labels,
        "dec_segment_ids": dec_seg,
    }


def packed_batch_iterator(
    documents,
    seq_len: int,
    rows_per_batch: int,
    drop_last: bool = False,
):
    """Stream variable-length docs into fixed-shape packed batches (online first-fit).

    Maintains up to ``rows_per_batch`` open rows; each incoming document goes to the first
    open row it fits (first-fit). When a document fits no open row and all rows are open,
    the batch is emitted and a fresh one starts — so every yielded batch is exactly
    ``[rows_per_batch, seq_len]`` (the final partial batch pads with empty rows unless
    ``drop_last``). This is the data-layer integration of ``pack_sequences``: wrap the
    per-process document stream AFTER sharding (each process packs its own shard) and feed
    the yielded dicts straight to a packed-aware ``loss_fn``.
    """
    def emit(bins):
        tokens = np.zeros((rows_per_batch, seq_len), np.int32)
        segments = np.zeros((rows_per_batch, seq_len), np.int32)
        positions = np.zeros((rows_per_batch, seq_len), np.int32)
        for r, docs in enumerate(bins):
            at = 0
            for s, doc in enumerate(docs, start=1):
                n = len(doc)
                tokens[r, at:at + n] = doc
                segments[r, at:at + n] = s
                positions[r, at:at + n] = np.arange(n, dtype=np.int32)
                at += n
        return {"tokens": tokens, "segment_ids": segments, "positions": positions}

    bins: list[list[np.ndarray]] = []
    used: list[int] = []
    for doc in documents:
        doc = np.asarray(doc, np.int32).ravel()
        if len(doc) > seq_len:
            raise ValueError(f"document of {len(doc)} tokens exceeds seq_len={seq_len}")
        if len(doc) == 0:
            continue
        row = next((b for b in range(len(bins)) if used[b] + len(doc) <= seq_len), -1)
        if row < 0:
            if len(bins) < rows_per_batch:
                bins.append([])
                used.append(0)
                row = len(bins) - 1
            else:
                yield emit(bins)
                bins, used = [[]], [0]
                row = 0
        bins[row].append(doc)
        used[row] += len(doc)
    if bins and not drop_last:
        yield emit(bins)
