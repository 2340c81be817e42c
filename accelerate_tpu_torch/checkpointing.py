"""Checkpoint and resume: the port's counterpart of ``accelerate_tpu/checkpointing.py``.

The directory contract and file names are the JAX package's:

    checkpoint_dir/
        sharded_state/rank{r}.json        each rank's index: leaves, dtypes, shapes, offsets,
                                           the dim a tp-split leaf is split along
        sharded_state/rank{r}_{i:05d}.bin each rank's train state, as byte files
        scheduler.json                     step, iteration, optimizer/scheduler/loader states
        sampler.json                       the data loaders' positions
        random_states_{rank}.pkl           Python, numpy and torch (CPU, CUDA) rng states
        custom_checkpoint_{i}.pkl          registered objects' ``state_dict()``
        model.safetensors                  ``safe_serialization``: the whole params
        manifest.sha256.json               every file's sha256, written after they land
        COMMITTED                          the validity marker, written last (tmp + rename)

A train state (``accelerator.TrainState``: params, optimizer state, step, accumulation
buffer, micro count, rng seed) is a stream of bytes per rank: its tensor leaves in
``utils.tree`` order, cut into files of ``FILE_BYTES`` so that several threads write,
hash and read them at once; its plain values (counts, the seed) go into the index.
Each rank writes only its own shards (a tp rank holds its halves of the projections).

Bytes move between the device and the files through a bounded staging buffer:
``STAGING_BUFFERS`` pinned host buffers of one file each, filled by
``non_blocking`` copies straight from the leaves' memory, so a save or a load allocates
no device memory. A save waits for each buffer's copy event before its bytes are
written. An async save (``async_save=True``) copies every file's bytes on into host
memory before it returns, so the next in-place train step cannot change what is
written; only the disk writes and the hashing run on in background threads, and the
manifest and marker are written when :func:`wait_for_async_save` joins them (every save
and load calls it first). ``hashlib`` and file I/O release the GIL, so the threads hash
and write in parallel.

A load verifies the checkpoint (every file's sha256 against the manifest), then copies
the bytes **in place** into the live state's tensors, their paths, dtypes and shapes
checked first, and returns the state with its plain values restored. A checkpoint saved
on another mesh shape raises (the JAX restore reshards). With automatic naming the
newest checkpoint that verifies is loaded; invalid ones (uncommitted, corrupt) are moved
under ``checkpoints/quarantined/`` and counted in ``checkpoints_quarantined``. An
explicit ``input_dir`` that fails verification raises :class:`CheckpointCorruptError`.

``safe_serialization=True`` also exports the params as ``model.safetensors`` (whole
tensors: under tp each split leaf is gathered first, a collective every rank joins, and
the main process writes), through the port's own safetensors writer
(``utils/serialization.py``), under the JAX params tree's names.

Fault injection (``Accelerator.fault_plan``, site ``ckpt.save``): every rank draws once a
save, after its data files have landed and before the commit. ``crash`` raises
``InjectedFault`` there: no marker, an uncommitted directory, as a preemption mid-save
leaves. ``corrupt`` flips one byte of the first manifested file after the marker, which
only the manifest's hashes catch; on an async save it rides the deferred commit and
lands when :func:`wait_for_async_save` has written the marker.

Not ported: pipeline (pp/mpmd) checkpoints and the consolidated ``FULL_STATE_DICT``
format.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import random
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .logging import get_logger
from .resilience.faults import InjectedFault
from .utils.constants import (
    CUSTOM_OBJECT_NAME,
    RNG_STATE_NAME,
    SAFE_WEIGHTS_NAME,
    SAMPLER_STATE_NAME,
    SCHEDULER_STATE_NAME,
    SHARDED_STATE_DIR,
    TENSOR_AXIS,
)
from .utils.operations import _world_size, gather_object
from .utils.tree import named_parameters, tree_unflatten

logger = get_logger(__name__)

__all__ = [
    "save_accelerator_state", "load_accelerator_state", "save_custom_state",
    "load_custom_state", "wait_for_async_save", "verify_checkpoint", "CheckpointCorruptError",
    "MANIFEST_NAME", "COMMIT_MARKER", "QUARANTINE_DIR", "FILE_BYTES", "STAGING_BUFFERS",
]

#: Per-file sha256 manifest, written after every file of a snapshot has landed.
MANIFEST_NAME = "manifest.sha256.json"
#: Validity marker written last (tmp + rename): a crash mid-save leaves none, and the
#: loader treats the directory as garbage instead of restoring a torn snapshot.
COMMIT_MARKER = "COMMITTED"
#: Where invalid checkpoints go on a load's fallback (outside the ``checkpoint_*`` glob).
QUARANTINE_DIR = "quarantined"
#: Bytes per train-state file; also the size of one staging buffer.
FILE_BYTES = 256 << 20
#: Staging buffers (pinned on CUDA) and the threads that fill, write and hash them.
STAGING_BUFFERS = 4
_TRAIN_STATE_FIELDS = ("params", "opt_state", "step", "grad_accum", "micro", "rng")


class CheckpointCorruptError(RuntimeError):
    """An explicitly named checkpoint failed integrity verification."""

    def __init__(self, path, problems):
        super().__init__(f"checkpoint {path} failed verification: {'; '.join(problems)}")
        self.path = str(path)
        self.problems = list(problems)


# ------------------------------------------------------------------- verified checkpoints
def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(16 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_files(path: Path) -> list:
    """Every snapshot file, checkpoint-relative, manifest and marker excluded."""
    skip = {MANIFEST_NAME, COMMIT_MARKER}
    return sorted(p.relative_to(path).as_posix() for p in path.rglob("*")
                  if p.is_file() and p.name not in skip)


def _hash_files(path: Path, rels) -> dict:
    """sha256 of each file, hashed by ``STAGING_BUFFERS`` threads (``hashlib`` releases
    the GIL on large buffers)."""
    with ThreadPoolExecutor(STAGING_BUFFERS) as pool:
        return dict(zip(rels, pool.map(lambda rel: _sha256_file(path / rel), rels)))


def _write_commit_marker(path: Path, known: Optional[dict] = None) -> None:
    """Hash every file (``known`` digests are taken as given), write the manifest, then
    the marker, atomically and strictly last."""
    known = known or {}
    rels = _manifest_files(path)
    manifest = {**_hash_files(path, [r for r in rels if r not in known]),
                **{r: known[r] for r in rels if r in known}}
    (path / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1, sort_keys=True))
    tmp = path / (COMMIT_MARKER + ".tmp")
    tmp.write_text(json.dumps({"files": len(manifest)}))
    os.replace(tmp, path / COMMIT_MARKER)


def verify_checkpoint(path) -> list:
    """Integrity problems of one checkpoint directory (empty: valid): a missing commit
    marker (a crash mid-save), a missing manifest, files that disappeared or are not in
    the manifest, and files whose sha256 no longer matches."""
    path = Path(path)
    if not (path / COMMIT_MARKER).exists():
        return ["uncommitted (no COMMITTED marker — crash mid-save?)"]
    if not (path / MANIFEST_NAME).exists():
        return ["committed but manifest missing"]
    try:
        manifest = json.loads((path / MANIFEST_NAME).read_text())
    except (json.JSONDecodeError, OSError) as e:
        return [f"unreadable manifest: {e}"]
    present = set(_manifest_files(path))
    problems = [f"missing file {rel}" for rel in manifest if rel not in present]
    listed = sorted(rel for rel in manifest if rel in present)

    def check(rel):
        try:
            return None if _sha256_file(path / rel) == manifest[rel] else f"sha256 mismatch: {rel}"
        except OSError as e:  # another rank may be quarantining this directory
            return f"unreadable file {rel}: {e}"

    with ThreadPoolExecutor(STAGING_BUFFERS) as pool:
        problems += [p for p in pool.map(check, listed) if p]
    problems += [f"unmanifested file {rel}" for rel in sorted(present - set(manifest))]
    return problems


def _list_checkpoints(base: Path) -> list:
    """``checkpoint_*`` directories under ``base`` in numeric order: the one listing
    behind latest-selection, rotation and the verified-load fallback."""
    return sorted(base.glob("checkpoint_*"), key=lambda p: int(p.name.split("_")[-1]))


def _checkpoint_dir(accelerator, output_dir: Optional[str], for_save: bool) -> Path:
    project = accelerator.project_configuration
    if output_dir is not None:
        return Path(output_dir)
    if project.project_dir is None:
        raise ValueError("No output_dir given and no project_dir configured.")
    base = Path(project.project_dir) / "checkpoints"
    if for_save:
        return base / f"checkpoint_{project.iteration}"
    existing = _list_checkpoints(base)
    if not existing:
        raise FileNotFoundError(f"No checkpoints found under {base}")
    return existing[-1]


def _rotate_checkpoints(accelerator, base: Path) -> None:
    """Prune old snapshots to ``total_limit``, counting only committed checkpoints and
    never deleting the newest committed one: uncommitted directories neither count nor
    shield older valid ones, and if the save about to happen crashes, the newest valid
    checkpoint is the state the loader falls back to."""
    limit = accelerator.project_configuration.total_limit
    if limit is None:
        return
    committed = [p for p in _list_checkpoints(base) if (p / COMMIT_MARKER).exists()]
    # Keep limit - 1 (the incoming save is the limit-th), but never fewer than one.
    while len(committed) > max(max(limit, 1) - 1, 1):
        victim = committed.pop(0)
        logger.info(f"Deleting old checkpoint {victim} (total_limit={limit})")
        shutil.rmtree(victim, ignore_errors=True)


# ------------------------------------------------------------------ the train state's bytes
def _flat_state(train_state) -> dict:
    """``{path: leaf}`` over the train state's fields: tensors and plain values."""
    return named_parameters({f: getattr(train_state, f) for f in _TRAIN_STATE_FIELDS})


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A leaf's memory as a flat uint8 view (no copy)."""
    if not t.is_contiguous():
        raise ValueError(f"checkpointing needs contiguous tensors, got strides {t.stride()}")
    return t.detach().reshape(-1).view(torch.uint8)


def _split_dims(train_state, flat: dict) -> dict:
    """``{path: dim}`` of the state's leaves split over the tp ranks: the params' from
    ``TrainState.tp_dims``, and every other leaf (a moment, an accumulated gradient) whose
    path ends with a split param's path and has its shape."""
    dims = getattr(train_state, "tp_dims", None)
    if not dims:
        return {}
    params = named_parameters(train_state.params)
    split = {p: (d, tuple(params[p].shape)) for p, d in zip(params, dims) if d is not None}
    out = {}
    for path, leaf in flat.items():
        parts = path.split("/")[1:]
        for i in range(len(parts)):
            hit = split.get("/".join(parts[i:]))
            if hit is not None:
                if torch.is_tensor(leaf) and tuple(leaf.shape) == hit[1]:
                    out[path] = hit[0]
                break
    return out


def _state_index(flat: dict, accelerator, split: dict) -> dict:
    leaves, offset = [], 0
    for path, leaf in flat.items():
        if torch.is_tensor(leaf):
            n = leaf.numel() * leaf.element_size()
            leaves.append({"path": path, "dtype": str(leaf.dtype).removeprefix("torch."),
                           "shape": list(leaf.shape), "offset": offset, "nbytes": n,
                           "split": split.get(path)})
            offset += n
        else:
            leaves.append({"path": path, "value": leaf})
    mesh = accelerator.mesh
    tp = None if mesh is None else {"size": mesh.axis_size(TENSOR_AXIS),
                                    "index": mesh.axis_index(TENSOR_AXIS)}
    return {"world": accelerator.num_processes, "rank": accelerator.process_index,
            "mesh": None if mesh is None else dict(mesh.shape), "tp": tp,
            "file_bytes": FILE_BYTES, "total_bytes": offset,
            "n_files": -(-offset // FILE_BYTES), "leaves": leaves}


def _file_pieces(index: dict, tensors: dict) -> list:
    """Per file, its pieces ``(leaf bytes view, start in the leaf, length, offset in the
    file)``."""
    fb = index["file_bytes"]
    files = [[] for _ in range(index["n_files"])]
    for leaf in index["leaves"]:
        if "value" in leaf or leaf["nbytes"] == 0:
            continue
        view = _bytes_of(tensors[leaf["path"]])
        start, end = leaf["offset"], leaf["offset"] + leaf["nbytes"]
        pos = start
        while pos < end:
            i, off = divmod(pos, fb)
            n = min(end - pos, fb - off)
            files[i].append((view, pos - start, n, off))
            pos += n
    return files


class _Staging:
    """``STAGING_BUFFERS`` host buffers (pinned when the device is CUDA) of ``nbytes``
    each, kept by the accelerator between saves and loads."""

    def __init__(self, device: torch.device, nbytes: int):
        pin = device.type == "cuda"
        self.device, self.nbytes = device, nbytes
        self.buffers = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
                        for _ in range(STAGING_BUFFERS)]

    def mark(self):
        """A timing event recorded on the current stream after the copies issued so far
        (None on the CPU, where the copies are synchronous)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev


def _copy_s(start, end) -> float:
    """Device seconds between two marks (0 on the CPU); waits for ``end``."""
    if end is None:
        return 0.0
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _staging(accelerator, index: dict) -> _Staging:
    """The accelerator's staging buffers, (re)made when they are smaller than one file
    of ``index``."""
    need = max(1, min(index["file_bytes"], index["total_bytes"]))
    st = getattr(accelerator, "_ckpt_staging", None)
    if st is None or st.device != accelerator.device or st.nbytes < need:
        accelerator._ckpt_staging = None  # free the old buffers first
        st = accelerator._ckpt_staging = _Staging(accelerator.device, need)
    return st


def _write_file(target: Path, data: memoryview) -> tuple[str, float, float]:
    """Write ``data`` to ``target``; (sha256, write s, hash s)."""
    t0 = time.perf_counter()
    with open(target, "wb") as f:
        f.write(data)
    t1 = time.perf_counter()
    digest = hashlib.sha256(data).hexdigest()
    return digest, t1 - t0, time.perf_counter() - t1


class _AsyncWrites:
    """An async save's pending file writes: the deferred commit."""

    def __init__(self, path: Path, write_marker: bool, started: float):
        self.path, self.write_marker, self.started = path, write_marker, started
        self.corrupt = False  # a ckpt.save ``corrupt`` draw, applied after the marker
        self.pool = ThreadPoolExecutor(STAGING_BUFFERS)
        self.futures: dict = {}  # rel -> future of (digest, write s, hash s)
        self.last_done = started

    def submit(self, rel: str, data: np.ndarray) -> None:
        fut = self.pool.submit(_write_file, self.path / rel, memoryview(data))
        fut.add_done_callback(lambda _f: setattr(self, "last_done", time.perf_counter()))
        self.futures[rel] = fut

    def join(self) -> tuple[dict, dict]:
        done = {rel: f.result() for rel, f in self.futures.items()}
        self.pool.shutdown()
        return ({rel: d[0] for rel, d in done.items()},
                {"write_thread_s": sum(d[1] for d in done.values()),
                 "hash_thread_s": sum(d[2] for d in done.values()),
                 "commit_after_s": self.last_done - self.started})


def _save_train_state(accelerator, train_state, state_dir: Path, async_writes=None) -> tuple:
    """Write this rank's train state into ``state_dir``; (known digests, stats). With
    ``async_writes``, return once every byte is in host memory, the files handed to it."""
    t_start = time.perf_counter()
    rank = accelerator.process_index
    flat = _flat_state(train_state)
    index = _state_index(flat, accelerator, _split_dims(train_state, flat))
    state_dir.mkdir(parents=True, exist_ok=True)
    (state_dir / f"rank{rank}.json").write_text(json.dumps(index))
    pieces = _file_pieces(index, {p: v for p, v in flat.items() if torch.is_tensor(v)})
    staging = _staging(accelerator, index)
    free = list(staging.buffers)
    digests = {}
    totals = {"d2h_s": 0.0, "write_thread_s": 0.0, "hash_thread_s": 0.0}
    inflight = []  # (future, buffer, file name) in submission order

    def stage_out(buf, marks, n, rel):
        """After the buffer's copies: its bytes written and hashed, or (async) copied
        into host memory of their own."""
        d2h = _copy_s(*marks)
        if async_writes is None:
            return d2h, _write_file(state_dir / Path(rel).name, memoryview(buf.numpy())[:n])
        host = np.empty(n, dtype=np.uint8)
        host[:] = buf.numpy()[:n]
        return d2h, host

    def retire():
        fut, buf, rel = inflight.pop(0)
        d2h, out = fut.result()
        totals["d2h_s"] += d2h
        if async_writes is None:
            digests[rel] = out[0]
            totals["write_thread_s"] += out[1]
            totals["hash_thread_s"] += out[2]
        else:
            async_writes.submit(rel, out)
        free.append(buf)

    with ThreadPoolExecutor(STAGING_BUFFERS) as pool, torch.no_grad():
        for i, file_pieces in enumerate(pieces):
            if not free:
                retire()
            buf = free.pop()
            start = staging.mark()
            for view, first, length, off in file_pieces:
                buf[off:off + length].copy_(view[first:first + length], non_blocking=True)
            n = max(off + length for _, _, length, off in file_pieces)
            rel = f"{SHARDED_STATE_DIR}/rank{rank}_{i:05d}.bin"
            inflight.append((pool.submit(stage_out, buf, (start, staging.mark()), n, rel),
                             buf, rel))
        while inflight:
            retire()
    stats = {"bytes": index["total_bytes"], "files": index["n_files"],
             "staging_bytes": staging.nbytes * STAGING_BUFFERS, "d2h_s": totals["d2h_s"],
             "state_s": time.perf_counter() - t_start}
    if async_writes is None:
        stats.update(write_thread_s=totals["write_thread_s"],
                     hash_thread_s=totals["hash_thread_s"])
    return digests, stats


def _check_index(index: dict, flat: dict, accelerator) -> None:
    mesh = accelerator.mesh
    here = {"world": accelerator.num_processes, "mesh": None if mesh is None else dict(mesh.shape)}
    if {k: index[k] for k in here} != here:
        raise ValueError(
            f"checkpoint saved on world {index['world']}, mesh {index['mesh']}; this run has "
            f"world {here['world']}, mesh {here['mesh']}: loading onto another mesh shape is "
            "not supported")
    saved = [leaf["path"] for leaf in index["leaves"]]
    if saved != list(flat):
        raise ValueError(f"checkpoint leaves {saved} differ from the train state's {list(flat)}")
    for leaf in index["leaves"]:
        live = flat[leaf["path"]]
        if "value" in leaf:
            if torch.is_tensor(live):
                raise ValueError(f"{leaf['path']}: saved a value, the state holds a tensor")
            continue
        if not torch.is_tensor(live):
            raise ValueError(f"{leaf['path']}: saved a tensor, the state holds {type(live)}")
        got = (str(live.dtype).removeprefix("torch."), list(live.shape))
        if got != (leaf["dtype"], leaf["shape"]):
            raise ValueError(f"{leaf['path']}: saved {leaf['dtype']} {leaf['shape']}, the "
                             f"state holds {got[0]} {got[1]}")


def _load_train_state(accelerator, train_state, state_dir: Path):
    """This rank's train state copied in place into ``train_state``'s tensors; returns
    (the state with its plain values restored, stats)."""
    t_start = time.perf_counter()
    index = json.loads((state_dir / f"rank{accelerator.process_index}.json").read_text())
    flat = _flat_state(train_state)
    _check_index(index, flat, accelerator)
    pieces = _file_pieces(index, {p: v for p, v in flat.items() if torch.is_tensor(v)})
    staging = _staging(accelerator, index)
    free = [(buf, None) for buf in staging.buffers]  # (buffer, marks of its last copies)
    totals = {"read_thread_s": 0.0, "h2d_s": 0.0}

    def read(i, buf, marks):
        if marks is not None:
            totals["h2d_s"] += _copy_s(*marks)  # the buffer's previous copies are done
        t0 = time.perf_counter()
        with open(state_dir / f"rank{index['rank']}_{i:05d}.bin", "rb") as f:
            f.readinto(memoryview(buf.numpy()))
        return time.perf_counter() - t0

    with ThreadPoolExecutor(STAGING_BUFFERS) as pool, torch.no_grad():
        inflight = []
        for i in range(len(pieces) + STAGING_BUFFERS):
            if i < len(pieces):
                buf, marks = free.pop(0)
                inflight.append((i, buf, pool.submit(read, i, buf, marks)))
            if inflight and (i >= len(pieces) or not free):
                j, buf, fut = inflight.pop(0)
                totals["read_thread_s"] += fut.result()
                start = staging.mark()
                for view, first, length, off in pieces[j]:
                    view[first:first + length].copy_(buf[off:off + length], non_blocking=True)
                free.append((buf, (start, staging.mark())))
    for _, marks in free:
        if marks is not None:
            totals["h2d_s"] += _copy_s(*marks)
    values = {leaf["path"]: leaf["value"] for leaf in index["leaves"] if "value" in leaf}
    leaves = [values.get(p, v) for p, v in flat.items()]
    fields = tree_unflatten({f: getattr(train_state, f) for f in _TRAIN_STATE_FIELDS}, leaves)
    return train_state.replace(**fields), {
        "bytes": index["total_bytes"], "files": index["n_files"], **totals,
        "read_h2d_s": time.perf_counter() - t_start}


# --------------------------------------------------------------------------- save / load
#: An async save's writes, committed by :func:`wait_for_async_save`.
_PENDING: Optional[_AsyncWrites] = None


def wait_for_async_save(accelerator=None) -> Optional[dict]:
    """Join an async save's background writes, then write its manifest and marker (the
    snapshot is valid only from then on); returns the writes' stats, or None when none
    was pending. With several processes this is collective: every process calls it."""
    global _PENDING
    pending, _PENDING = _PENDING, None
    if pending is None:
        return None
    digests, stats = pending.join()
    all_digests = _all_ranks_digests(digests)
    if pending.write_marker:
        _write_commit_marker(pending.path, all_digests)
        if pending.corrupt:
            _corrupt_one_file(pending.path)
    _barrier()
    if accelerator is not None:
        accelerator.checkpoint_stats["save"].update(stats)
    return stats


def _corrupt_one_file(path: Path) -> None:
    """Injected silent corruption: one byte flipped in the middle of the first
    manifested file, which the marker cannot catch and the manifest's hashes must."""
    files = _manifest_files(path)
    if not files:
        return
    victim = path / files[0]
    data = bytearray(victim.read_bytes())
    if data:
        data[len(data) // 2] ^= 0xFF
        victim.write_bytes(bytes(data))


def _export_safetensors(accelerator, train_state, file_path: Path) -> float:
    """The whole params as one safetensors file, written by the main process; split
    leaves are gathered from the tp ranks first (every rank joins). Returns seconds."""
    from .parallel.tp import gather_split_leaf
    from .utils.serialization import write_safetensors

    t0 = time.perf_counter()
    flat = named_parameters(train_state.params)
    dims = train_state.tp_dims or [None] * len(flat)
    whole = {path: gather_split_leaf(leaf, d, accelerator.mesh)
             for (path, leaf), d in zip(flat.items(), dims)}
    if accelerator.is_main_process:
        write_safetensors(whole, file_path)
    return time.perf_counter() - t0


def _all_ranks_digests(digests: dict) -> dict:
    merged = {}
    for d in gather_object([digests]):
        merged.update(d)
    return merged


def _barrier() -> None:
    if _world_size() > 1:
        import torch.distributed as dist

        dist.barrier()


def save_accelerator_state(accelerator, output_dir: Optional[str] = None, train_state=None,
                           safe_serialization: bool = False, async_save: bool = False) -> str:
    """Write a resumable snapshot; returns its path. ``async_save``: return once every
    byte of the train state is in host memory, the writes going on in the background
    (joined and committed by the next save or load, or :func:`wait_for_async_save`)."""
    global _PENDING
    t_start = time.perf_counter()
    # Join any in-flight write first: rotation may delete its directory, and a save to
    # the same path would remove it mid-write.
    wait_for_async_save(accelerator)
    project = accelerator.project_configuration
    automatic = output_dir is None and project.automatic_checkpoint_naming
    if automatic:
        # Single-writer rotation, between barriers: every rank has joined its own writes
        # before the prune, and none writes into a directory being pruned.
        accelerator.wait_for_everyone()
        if accelerator.is_main_process:
            _rotate_checkpoints(accelerator, Path(project.project_dir) / "checkpoints")
        accelerator.wait_for_everyone()
    path = _checkpoint_dir(accelerator, output_dir, for_save=True)
    path.mkdir(parents=True, exist_ok=True)
    # A re-used directory loses its committed bit first: the marker only ever describes
    # bytes that are fully on disk.
    (path / COMMIT_MARKER).unlink(missing_ok=True)

    for hook in accelerator._save_model_hooks:
        hook(accelerator._models, train_state, str(path))

    digests, stats = {}, {}
    pending = None
    if train_state is not None:
        state_dir = path / SHARDED_STATE_DIR
        if accelerator.is_main_process and state_dir.exists():
            shutil.rmtree(state_dir)
        accelerator.wait_for_everyone()
        if async_save:
            pending = _AsyncWrites(path, accelerator.is_main_process, t_start)
        digests, stats = _save_train_state(accelerator, train_state, state_dir, pending)
        if safe_serialization:
            stats["export_s"] = _export_safetensors(accelerator, train_state,
                                                    path / SAFE_WEIGHTS_NAME)

    meta: dict[str, Any] = {
        "step": accelerator.step, "iteration": project.iteration,
        "optimizers": [opt.state_dict() for opt in accelerator._optimizers],
    }
    schedulers = []
    for sched in accelerator._schedulers:
        try:
            schedulers.append(sched.state_dict())
        except Exception:  # a scheduler without a serialisable state: restored as None
            schedulers.append(None)
    meta["schedulers"] = schedulers
    samplers = [dl.state_dict() if getattr(dl, "stateful", False) and hasattr(dl, "state_dict")
                else {"iteration": getattr(dl, "iteration", 0)} for dl in accelerator._dataloaders]
    meta["dataloaders"] = samplers
    if accelerator.is_main_process:
        (path / SCHEDULER_STATE_NAME).write_text(json.dumps(meta, indent=2))
        (path / SAMPLER_STATE_NAME).write_text(json.dumps(samplers))
    save_each = project.save_on_each_node
    for i, obj in enumerate(accelerator._custom_objects):
        save_custom_state(obj, str(path), i, save_on_each_node=save_each)

    states: dict[str, Any] = {"random_state": random.getstate(),
                              "numpy_random_seed": np.random.get_state(),
                              "torch_manual_seed": torch.get_rng_state()}
    if accelerator.device.type == "cuda":
        states["torch_cuda_manual_seed"] = torch.cuda.get_rng_state(accelerator.device)
    with open(path / f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl", "wb") as f:
        pickle.dump(states, f)

    # Fault injection: every rank draws once, before the commit's collectives, so all
    # take the same branch and no survivor waits in a barrier.
    plan = getattr(accelerator, "fault_plan", None)
    spec = plan.draw("ckpt.save") if plan is not None else None
    if spec is not None and spec.kind == "crash":
        if pending is not None:
            pending.join()  # the data files land; the marker never does
        raise InjectedFault("ckpt.save", "crash")
    corrupt = spec is not None and spec.kind == "corrupt"

    # Every file hashed into the manifest, then the marker, last: a crash anywhere above
    # leaves an uncommitted directory the loader skips.
    t_commit = time.perf_counter()
    if pending is not None:
        pending.corrupt = corrupt  # lands after the deferred marker
        _PENDING = pending
        stats["blocking_s"] = time.perf_counter() - t_start
    else:
        all_digests = _all_ranks_digests(digests)
        if accelerator.is_main_process:
            _write_commit_marker(path, all_digests)
            if corrupt:
                _corrupt_one_file(path)
        _barrier()
        stats["commit_s"] = time.perf_counter() - t_commit
        stats["total_s"] = time.perf_counter() - t_start
    accelerator.checkpoint_stats["save"] = stats
    if automatic:
        project.iteration += 1
    logger.info(f"Saved accelerator state to {path}")
    return str(path)


def _quarantine_checkpoint(accelerator, cand: Path, base: Path, problems) -> None:
    """Move an invalid checkpoint out of the ``checkpoint_*`` namespace (so rotation and
    latest-selection never see it again) and count it."""
    logger.warning(f"checkpoint {cand} failed verification ({'; '.join(problems)}) — "
                   "quarantining and falling back to the previous valid snapshot")
    if accelerator.is_main_process:
        qdir = base / QUARANTINE_DIR
        qdir.mkdir(parents=True, exist_ok=True)
        dest = qdir / cand.name
        if dest.exists():
            shutil.rmtree(dest, ignore_errors=True)
        shutil.move(str(cand), str(dest))
    accelerator.checkpoints_quarantined = getattr(accelerator, "checkpoints_quarantined", 0) + 1


def _select_valid_checkpoint(accelerator) -> Path:
    """The newest checkpoint that verifies; invalid ones are quarantined on the way."""
    base = Path(accelerator.project_configuration.project_dir) / "checkpoints"
    existing = _list_checkpoints(base)
    if not existing:
        raise FileNotFoundError(f"No checkpoints found under {base}")
    for cand in reversed(existing):
        problems = verify_checkpoint(cand)
        # Every rank must take the same verdict before the main rank moves anything.
        problems = sorted({p for ps in gather_object([problems]) for p in ps})
        if not problems:
            return cand
        _quarantine_checkpoint(accelerator, cand, base, problems)
        _barrier()
    raise FileNotFoundError(
        f"No VALID checkpoint under {base}: all {len(existing)} candidates failed "
        f"verification (quarantined under {base / QUARANTINE_DIR})")


def load_accelerator_state(accelerator, input_dir: Optional[str] = None, train_state=None,
                           load_optimizer_states: bool = True):
    """Restore a snapshot; returns ``train_state`` with every tensor overwritten in place
    and its plain values restored (None when no state was given)."""
    wait_for_async_save(accelerator)  # never read a directory whose write has not committed
    t_start = time.perf_counter()
    if input_dir is None and accelerator.project_configuration.project_dir is not None:
        path = _select_valid_checkpoint(accelerator)
    else:
        path = _checkpoint_dir(accelerator, input_dir, for_save=False)
    if not path.exists():
        raise FileNotFoundError(f"Checkpoint {path} does not exist")
    if input_dir is not None and ((path / COMMIT_MARKER).exists()
                                  or (path / MANIFEST_NAME).exists()):
        problems = verify_checkpoint(path)
        if problems:
            raise CheckpointCorruptError(path, problems)
    stats = {"verify_s": time.perf_counter() - t_start}

    for hook in accelerator._load_model_hooks:
        hook(accelerator._models, train_state, str(path))

    restored = None
    if train_state is not None:
        restored, read_stats = _load_train_state(accelerator, train_state,
                                                 path / SHARDED_STATE_DIR)
        stats.update(read_stats)
        for opt in accelerator._optimizers:
            if opt._opt_state_ref is train_state.opt_state:
                opt._opt_state_ref = restored.opt_state

    meta_file = path / SCHEDULER_STATE_NAME
    if meta_file.exists():
        meta = json.loads(meta_file.read_text())
        accelerator.step = meta.get("step", 0)
        if load_optimizer_states:
            for opt, sd in zip(accelerator._optimizers, meta.get("optimizers", [])):
                opt.load_state_dict(sd)
        for sched, sd in zip(accelerator._schedulers, meta.get("schedulers", [])):
            if sd is not None:
                sched.load_state_dict(sd)
        for dl, sd in zip(accelerator._dataloaders, meta.get("dataloaders", [])):
            if getattr(dl, "stateful", False) and hasattr(dl, "load_state_dict"):
                dl.load_state_dict(sd)
            elif hasattr(dl, "set_epoch"):
                dl.set_epoch(sd.get("iteration", 0))

    for i, obj in enumerate(accelerator._custom_objects):
        load_custom_state(obj, str(path), i)

    rng_file = path / f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl"
    if rng_file.exists():
        with open(rng_file, "rb") as f:
            states = pickle.load(f)  # written by this program's save
        random.setstate(states["random_state"])
        np.random.set_state(states["numpy_random_seed"])
        torch.set_rng_state(states["torch_manual_seed"])
        if "torch_cuda_manual_seed" in states and accelerator.device.type == "cuda":
            torch.cuda.set_rng_state(states["torch_cuda_manual_seed"], accelerator.device)
    stats["total_s"] = time.perf_counter() - t_start
    accelerator.checkpoint_stats["load"] = stats
    logger.info(f"Loaded accelerator state from {path}")
    return restored


def save_custom_state(obj, path: str, index: int = 0, save_on_each_node: bool = False) -> None:
    """Pickle ``obj.state_dict()``: once (the main process), or once per node (each
    node's local main process) with ``save_on_each_node``."""
    from .state import PartialState

    st = PartialState._shared_state
    key = "local_process_index" if save_on_each_node else "process_index"
    if st.get(key, 0) != 0:
        return
    with open(Path(path) / f"{CUSTOM_OBJECT_NAME}_{index}.pkl", "wb") as f:
        pickle.dump(obj.state_dict(), f)


def load_custom_state(obj, path: str, index: int = 0) -> None:
    """``obj.load_state_dict`` of the pickled state, when the checkpoint has one."""
    location = Path(path) / f"{CUSTOM_OBJECT_NAME}_{index}.pkl"
    if location.exists():
        with open(location, "rb") as f:
            obj.load_state_dict(pickle.load(f))
