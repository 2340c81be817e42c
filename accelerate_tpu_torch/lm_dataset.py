"""Indexed LM pretraining dataset: the port's counterpart of
``accelerate_tpu/lm_dataset.py`` (host work in numpy, the hot loops in C++).

- A corpus is one flat int32 token array, memmapped from a ``.bin`` file
  (:func:`write_token_file` writes one).
- Sample ``i`` is the ``[seq_len + 1]`` window at ``order[i] * seq_len`` (the extra
  token is the shifted target; consecutive windows overlap by one token).
- Each epoch's order is a splitmix64 Fisher–Yates shuffle seeded from (seed, epoch),
  the same on every process, so ``BatchSamplerShard`` slices it disjointly.
- Batches are gathered by ``native/lmdata.cpp`` (a multithreaded copy), with a numpy
  path that gives the same bytes on hosts without ``g++``.

``TokenDataset`` is map-style and composes with ``prepare_data_loader``;
:meth:`TokenDataset.iter_batches` is the fast path, one native call per batch.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional

import numpy as np

from .native import load_native

__all__ = ["TokenDataset", "write_token_file", "native_available"]

_lock = threading.Lock()
_lib = None
_build_failed = False


def _configure(lib: ctypes.CDLL) -> None:
    lib.lm_shuffle.restype = None
    lib.lm_shuffle.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint64]
    lib.lm_gather.restype = ctypes.c_int64
    lib.lm_gather.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]


def _load_native():
    """The native library, built once per process; None when no toolchain works."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = load_native("lmdata", _configure)
            _build_failed = _lib is None
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def _splitmix64(state: int) -> tuple[int, int]:
    """One splitmix64 step, as ``native/lmdata.cpp`` takes it."""
    mask = (1 << 64) - 1
    state = (state + 0x9E3779B97F4A7C15) & mask
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return state, z ^ (z >> 31)


def _shuffle_py(idx: np.ndarray, seed: int) -> None:
    state = seed
    for i in range(len(idx) - 1, 0, -1):
        state, r = _splitmix64(state)
        j = r % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]


def write_token_file(tokens, path: str) -> None:
    """Write token ids as the flat int32 ``.bin`` layout ``TokenDataset`` reads (through
    a temporary file renamed into place)."""
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        arr.tofile(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class TokenDataset:
    """Map-style dataset over a token corpus: ``source`` is a path to a flat int32
    ``.bin`` file (memmapped) or an integer array. :meth:`set_epoch` reshuffles the
    window order deterministically (the same order on every process)."""

    def __init__(self, source, seq_len: int, seed: int = 0, shuffle: bool = True):
        if isinstance(source, (str, os.PathLike)):
            self.tokens = np.memmap(source, dtype=np.int32, mode="r")
        else:
            self.tokens = np.ascontiguousarray(np.asarray(source, dtype=np.int32))
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        n = (len(self.tokens) - 1) // self.seq_len
        if n < 1:
            raise ValueError(f"corpus of {len(self.tokens)} tokens holds no [{seq_len + 1}] window")
        self._n = n
        self._order = np.arange(n, dtype=np.int64)
        self._epoch: Optional[int] = None
        if self.shuffle:
            self.set_epoch(0)

    def set_epoch(self, epoch: int) -> None:
        """The window order of ``epoch`` (the same on every process)."""
        if not self.shuffle or epoch == self._epoch:
            return
        self._order = np.arange(self._n, dtype=np.int64)
        seed = (self.seed * 1_000_003 + epoch + 1) & ((1 << 64) - 1)
        lib = _load_native()
        if lib is not None:
            lib.lm_shuffle(self._order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           self._n, ctypes.c_uint64(seed))
        else:
            _shuffle_py(self._order, seed)
        self._epoch = epoch

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, index: int) -> dict:
        start = int(self._order[index]) * self.seq_len
        # A copy, not a view of the read-only memmap: a batch built from it may be
        # written to (and torch would wrap a view without copying).
        return {"tokens": np.array(self.tokens[start:start + self.seq_len + 1])}

    def iter_batches(self, batch_size: int, rank: int = 0, world_size: int = 1,
                     drop_last: bool = True) -> Iterator[dict]:
        """One native gather per global batch of ``batch_size`` windows, in epoch order,
        sliced to rows ``[rank * per_rank, (rank + 1) * per_rank)``. With
        ``world_size > 1`` a last partial global batch is always dropped."""
        if batch_size % world_size:
            raise ValueError(f"batch_size {batch_size} not divisible by world {world_size}")
        per_rank = batch_size // world_size
        width = self.seq_len + 1
        lib = _load_native()
        tok = self.tokens
        keep_partial = not drop_last and world_size == 1
        stop = self._n if keep_partial else self._n - batch_size + 1
        for base in range(0, stop, batch_size):
            rows = self._order[base:base + batch_size]
            starts = np.ascontiguousarray(rows[rank * per_rank:(rank + 1) * per_rank]
                                          * self.seq_len)
            out = np.empty((len(starts), width), dtype=np.int32)
            if lib is not None:
                rc = lib.lm_gather(tok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tok),
                                   starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                   len(starts), width,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                if rc != 0:
                    raise IndexError("window out of corpus bounds")
            else:
                for r, s in enumerate(starts):
                    out[r] = tok[s:s + width]
            yield {"tokens": out}
