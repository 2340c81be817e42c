"""Distributed data pipeline: the port's counterpart of ``accelerate_tpu/data_loader.py``.

The index math (which rows each process loads) is the JAX package's, so its sampler
tests translate one to one: ``SeedableRandomSampler`` (numpy's generator seeded from
seed + epoch), ``BatchSampler``, ``BatchSamplerShard`` (batches dealt round-robin, or
each global batch split, with an even tail cycled from the epoch's start),
``IterableDatasetShard``, ``SkipBatchSampler``. Host work is numpy: ``default_collate``
stacks examples per leaf, and torch leaves from a torch dataset become numpy.

``DataLoaderShard`` iterates a loader with ``prefetch_depth`` batches placed on the
device ahead of the one handed out, so ``end_of_dataloader`` (and ``remainder``) are
known before the last batch is yielded; it registers itself with ``GradientState`` while
it runs and keeps its position for a mid-epoch resume (``state_dict`` /
``load_state_dict``, with ``stateful``). On CUDA a batch is copied from pinned host
memory with ``non_blocking=True`` on a side stream, so the copy overlaps the step that
runs meanwhile; the consumer's stream waits for the copy's event before the batch is
used, and each tensor is marked as used by that stream (``record_stream``) for the
caching allocator. (A non-blocking copy from pageable memory would be synchronous.)
Unless ``non_blocking``, the host also waits for each batch's copy when it places it,
one prefetched batch ahead of the step that uses it.

Under a mesh of several processes (``batch_group``), each process loads its shard and
the shards are gathered into the global batch, which every rank of the train step sees
and slices, as the JAX step sees one global array. ``DataLoaderDispatcher`` reads on
process 0 only and broadcasts each batch over ``torch.distributed``.
``prepare_data_loader`` also takes a ``torch.utils.data.DataLoader`` and re-wraps its
dataset, sampler and collate function.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from .logging import get_logger
from .state import GradientState, PartialState
from .utils.operations import (
    broadcast,
    broadcast_object_list,
    concatenate,
    find_batch_size,
    gather,
    get_data_structure,
    initialize_tensors,
    recursively_apply,
    slice_tensors,
)
from .utils.random import synchronize_rng_states

logger = get_logger(__name__)

__all__ = [
    "SeedableRandomSampler", "SequentialSampler", "BatchSampler", "BatchSamplerShard",
    "IterableDatasetShard", "DataLoader", "DataLoaderShard", "DataLoaderDispatcher",
    "SkipBatchSampler", "SkipDataLoader", "prepare_data_loader", "skip_first_batches",
    "default_collate",
]


# ------------------------------------------------------------------------------- samplers
class SeedableRandomSampler:
    """A permutation drawn from numpy's generator seeded with ``seed + epoch``: the same
    on every process for a given (seed, epoch), so shards never overlap."""

    def __init__(self, data_source, seed: Optional[int] = None, epoch: int = 0):
        self.data_source = data_source
        self.seed = seed if seed is not None else 0
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.data_source)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from rng.permutation(len(self.data_source)).tolist()


class SequentialSampler:
    def __init__(self, data_source):
        self.data_source = data_source

    def __len__(self) -> int:
        return len(self.data_source)

    def __iter__(self) -> Iterator[int]:
        yield from range(len(self.data_source))


class BatchSampler:
    """A sampler's indices in batches of ``batch_size`` (torch's ``BatchSampler``)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[list[int]]:
        batch: list[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)


class BatchSamplerShard:
    """A batch sampler's batches for process ``process_index`` of ``num_processes``.

    - ``split_batches=False``: the inner sampler yields per-process batches; process
      ``p`` takes batches ``p, p + n, ...``. With ``even_batches`` the tail is completed
      by cycling samples from the start of the epoch, so every process yields the same
      number of full batches.
    - ``split_batches=True``: the inner sampler yields global batches (a multiple of
      ``num_processes``); each process takes its contiguous slice of each.
    """

    def __init__(self, batch_sampler, num_processes: int = 1, process_index: int = 0,
                 split_batches: bool = False, even_batches: bool = True):
        if split_batches and getattr(batch_sampler, "batch_size", None) is not None:
            if batch_sampler.batch_size % num_processes != 0:
                raise ValueError(
                    f"batch_size {batch_sampler.batch_size} must be divisible by "
                    f"num_processes {num_processes} when split_batches=True")
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self) -> int:
        return len(self.batch_sampler)

    def __len__(self) -> int:
        if self.split_batches:
            return len(self.batch_sampler)
        length = len(self.batch_sampler) // self.num_processes
        if len(self.batch_sampler) % self.num_processes != 0 and not self.drop_last:
            if self.even_batches:
                length += 1
            else:
                length += (1 if self.process_index < len(self.batch_sampler) % self.num_processes
                           else 0)
        return length

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __iter__(self) -> Iterator[list[int]]:
        return self._iter_split() if self.split_batches else self._iter_no_split()

    def _iter_split(self):
        initial_batch = None
        for batch in self.batch_sampler:
            if initial_batch is None:
                initial_batch = list(batch)
            chunk = len(batch) // self.num_processes
            if chunk * self.num_processes != len(batch):
                if self.drop_last:
                    continue
                if self.even_batches:
                    batch = list(batch) + initial_batch[: self.batch_size - len(batch)]
                    chunk = len(batch) // self.num_processes
                else:
                    start = self.process_index * chunk
                    end = min(len(batch), (self.process_index + 1) * chunk)
                    if start < len(batch):
                        yield batch[start:end]
                    continue
            yield batch[self.process_index * chunk:(self.process_index + 1) * chunk]

    def _iter_no_split(self):
        batch_size = self.batch_size
        initial_data: list[int] = []  # the epoch's first samples, for the tail
        cached: list[list[int]] = []
        for batch in self.batch_sampler:
            if not self.drop_last and batch_size is not None:
                if len(initial_data) < self.num_processes * batch_size:
                    initial_data += list(batch)
            cached.append(list(batch))
            if len(cached) == self.num_processes:
                if all(batch_size is None or len(b) == batch_size for b in cached):
                    yield cached[self.process_index]
                    cached = []
        if not cached or self.drop_last:
            return
        if not self.even_batches:
            if self.process_index < len(cached):
                yield cached[self.process_index]
            return
        flat = [i for b in cached for i in b]
        per = batch_size if batch_size is not None else max(len(b) for b in cached)
        target = per * self.num_processes
        while len(flat) < target and initial_data:
            flat += initial_data[: target - len(flat)]
        yield flat[self.process_index * per:(self.process_index + 1) * per]


class IterableDatasetShard:
    """An iterable dataset's elements for one process: buffers ``batch_size *
    num_processes`` elements (``batch_size`` with ``split_batches``) and yields this
    process's slice; unless ``drop_last``, the tail is completed from the first
    buffered batch."""

    def __init__(self, dataset: Iterable, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False):
        if split_batches and batch_size % num_processes != 0:
            raise ValueError(f"batch_size {batch_size} must be divisible by num_processes "
                             f"{num_processes} when split_batches=True")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        real_batch = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        if self.drop_last:
            return (n // real_batch) * real_batch // self.num_processes
        return math.ceil(n / real_batch) * real_batch // self.num_processes

    def __iter__(self):
        real = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        per = real // self.num_processes
        mine = range(self.process_index * per, (self.process_index + 1) * per)
        first_batch = None
        current: list[Any] = []
        for element in self.dataset:
            current.append(element)
            if len(current) == real:
                for i in mine:
                    yield current[i]
                if first_batch is None:
                    first_batch = current.copy()
                current = []
        if not self.drop_last and current:
            if first_batch is None:
                first_batch = current.copy()
            while len(current) < real:
                current += first_batch[: real - len(current)]
            for i in mine:
                yield current[i]


# ------------------------------------------------------------------------------- collation
def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def default_collate(examples: Sequence[Any]):
    """A list of examples stacked into one batch per leaf (``np.stack``)."""
    first = examples[0]
    if isinstance(first, dict):
        return {k: default_collate([ex[k] for ex in examples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([ex[i] for ex in examples]) for i in range(len(first)))
    return np.stack([np.asarray(_to_numpy(ex)) for ex in examples])


def _batch_to_numpy(batch):
    return recursively_apply(lambda t: np.asarray(_to_numpy(t)), batch)


# ---------------------------------------------------------------------------- data loaders
class DataLoader:
    """A minimal data loader over a map-style dataset: a ``batch_sampler`` (or one built
    from ``batch_size``/``shuffle``/``drop_last``) and a ``collate_fn``."""

    def __init__(self, dataset, batch_size: Optional[int] = 1, shuffle: bool = False,
                 sampler=None, batch_sampler=None, drop_last: bool = False,
                 collate_fn: Optional[Callable] = None, generator_seed: Optional[int] = None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", None)
            self.drop_last = getattr(batch_sampler, "drop_last", False)
        else:
            if sampler is None:
                sampler = (SeedableRandomSampler(dataset, seed=generator_seed or 0) if shuffle
                           else SequentialSampler(dataset))
            self.sampler = sampler
            self.batch_size = batch_size
            self.drop_last = drop_last
            self.batch_sampler = BatchSampler(sampler, batch_size, drop_last)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __iter__(self):
        for batch_indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in batch_indices])


class _Placed:
    """A batch on its way to the device: the device tree, the pinned host tensors its
    copies read, and the copy stream's event (CUDA)."""

    __slots__ = ("batch", "sources", "event")

    def __init__(self, batch, sources=(), event=None):
        self.batch, self.sources, self.event = batch, sources, event

    def ready(self):
        """The batch, ordered after its copies on the current stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.event.device)
            stream.wait_event(self.event)
            recursively_apply(lambda t: t.record_stream(stream), self.batch,
                              test_type=torch.is_tensor)
        return self.batch


class _PreparedDataLoader:
    """Shared plumbing: ``GradientState`` registration, device placement, rng sync."""

    def __init__(self, device=None, rng_types: Optional[list[str]] = None,
                 synchronized_generator=None, non_blocking: bool = False, batch_group=None):
        self.device = None if device is None else torch.device(device)
        self.rng_types = rng_types
        self.synchronized_generator = synchronized_generator
        self.non_blocking = non_blocking
        self.batch_group = batch_group
        self.gradient_state = GradientState()
        self.end_of_dataloader = False
        self.remainder = -1
        self._copy_stream = None

    def _place(self, batch) -> _Placed:
        batch = _batch_to_numpy(batch)
        if self.device is None:
            return _Placed(batch)
        if self.device.type != "cuda":
            placed = recursively_apply(lambda x: torch.from_numpy(np.ascontiguousarray(x))
                                       .to(self.device), batch)
            return _Placed(self._global(placed))
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        sources = []

        def pinned(x):
            host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
            sources.append(host)
            return host.to(self.device, non_blocking=True)

        # No wait on the current stream: the copies' device memory comes from the side
        # stream's pool, which reuses a block only after the streams recorded on it are
        # done; a pinned source freed early is held by the caching host allocator until
        # its copy's event completes.
        with torch.cuda.stream(self._copy_stream):
            placed = recursively_apply(pinned, batch)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        if not self.non_blocking:
            event.synchronize()  # the batch is on the device when it is placed
        if self.batch_group is not None:
            # The gather runs on the current stream, which waits for the copies first.
            torch.cuda.current_stream(self.device).wait_event(event)
            return _Placed(self._global(placed), sources)
        return _Placed(placed, sources, event)

    def _global(self, batch):
        """This process's shard gathered with the other batch ranks' into the global
        batch (a no-op without a batch group)."""
        if self.batch_group is None:
            return batch
        return gather(batch, group=self.batch_group)

    def begin(self):
        self.end_of_dataloader = False
        self.remainder = -1
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)


class DataLoaderShard(_PreparedDataLoader):
    """A process's (already index-sharded) data loader, with ``prefetch_depth`` batches
    placed ahead of the one handed out (at most ``prefetch_depth`` in flight), so
    ``end_of_dataloader`` is known before the last batch is yielded. ``stateful`` keeps
    ``batches_yielded`` for ``state_dict``; ``load_state_dict`` arms a one-shot skip of
    that many batches in the next epoch it starts."""

    def __init__(self, dataloader, device=None, rng_types=None, synchronized_generator=None,
                 skip_batches: int = 0, _non_blocking: bool = False, stateful: bool = False,
                 prefetch_depth: int = 1, batch_group=None):
        super().__init__(device=device, rng_types=rng_types,
                         synchronized_generator=synchronized_generator,
                         non_blocking=_non_blocking, batch_group=batch_group)
        self.dataloader = dataloader
        self.skip_batches = skip_batches
        if prefetch_depth < 1:
            raise ValueError(f"prefetch_depth={prefetch_depth} must be >= 1")
        self.prefetch_depth = prefetch_depth
        self.iteration = 0
        self.stateful = stateful
        self.batches_yielded = 0
        self._resume_batches = 0

    @property
    def dataset(self):
        return getattr(self.dataloader, "dataset", None)

    @property
    def batch_sampler(self):
        return getattr(self.dataloader, "batch_sampler", None)

    def __len__(self) -> int:
        return len(self.dataloader) - self.skip_batches - self._resume_batches

    @property
    def total_batch_size(self) -> int:
        sampler = self.batch_sampler
        if isinstance(sampler, BatchSamplerShard):
            bs = sampler.batch_size or 0
            return bs * (1 if sampler.split_batches else sampler.num_processes)
        return (getattr(self.dataloader, "batch_size", None) or 0) * _num_processes()

    @property
    def total_dataset_length(self) -> int:
        ds = self.dataset
        return len(ds) if ds is not None and hasattr(ds, "__len__") else -1

    def set_epoch(self, epoch: int) -> None:
        self.iteration = epoch
        if hasattr(self.dataloader, "set_epoch"):
            self.dataloader.set_epoch(epoch)
        elif hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self):
        if self.rng_types is not None:
            # A (seed, epoch) sampler cannot desync: only a generator that really drives
            # the order is synchronised.
            synchronize_rng_states([r for r in self.rng_types if r != "generator"
                                    or self.synchronized_generator is not None],
                                   self.synchronized_generator)
        self.begin()
        try:
            skip = self.skip_batches
            if self._resume_batches and not self.skip_batches:
                skip = self._resume_batches  # armed by load_state_dict, consumed once
                self._resume_batches = 0
            self.batches_yielded = 0
            dataloader_iter = iter(self.dataloader)
            buffered: deque = deque()  # (index, placed batch), yielded from the left
            batch_index = 0  # index of the next batch to fetch from the inner loader
            exhausted = any_fetched = False
            while True:
                while not exhausted and len(buffered) < self.prefetch_depth + 1:
                    try:
                        fetched = next(dataloader_iter)
                    except StopIteration:
                        exhausted = True
                        break
                    any_fetched = True
                    if batch_index >= skip:
                        buffered.append((batch_index, self._place(fetched)))
                    batch_index += 1
                if not buffered:
                    if any_fetched and not self.end_of_dataloader:
                        self.end_of_dataloader = True  # every batch was skipped
                        self.remainder = self._final_remainder()
                    break
                index, placed = buffered.popleft()
                if exhausted and not buffered:
                    self.end_of_dataloader = True
                    self.remainder = self._final_remainder()
                # Counted before the yield: a state_dict taken between batches includes
                # the batch just handed out.
                self.batches_yielded = index + 1
                yield placed.ready()
            if not any_fetched:
                return
            self.iteration += 1
            self.batches_yielded = 0
        finally:
            self.end()

    def state_dict(self) -> dict:
        """The resumable position: the epoch and the batches handed out in it."""
        return {"iteration": self.iteration, "batches_yielded": self.batches_yielded}

    def load_state_dict(self, state: dict) -> None:
        if self.skip_batches:
            raise ValueError(
                "load_state_dict on a skip_first_batches-wrapped loader is ambiguous "
                "(two competing resume offsets); restore state on the base loader OR use "
                "skip_first_batches, not both.")
        self.iteration = int(state.get("iteration", 0))
        self.batches_yielded = int(state.get("batches_yielded", 0))
        self._resume_batches = self.batches_yielded
        self.set_epoch(self.iteration)

    def _final_remainder(self) -> int:
        length, total_bs = self.total_dataset_length, self.total_batch_size
        if length >= 0 and total_bs:
            rem = length % total_bs
            return rem if rem != 0 else -1
        return -1


def _num_processes() -> int:
    return PartialState._shared_state.get("num_processes", 1)


def _process_index() -> int:
    return PartialState._shared_state.get("process_index", 0)


class DataLoaderDispatcher(_PreparedDataLoader):
    """Process 0 iterates the whole loader (global batches); each batch's structure is
    broadcast as an object, then its tensors, and every process takes its slice (the
    global batch under a ``batch_group``: the train step slices it)."""

    def __init__(self, dataloader, device=None, split_batches: bool = False,
                 skip_batches: int = 0, _non_blocking: bool = False, batch_group=None):
        super().__init__(device=device, non_blocking=_non_blocking, batch_group=batch_group)
        self.dataloader = dataloader
        self.split_batches = split_batches
        self.skip_batches = skip_batches
        self.iteration = 0

    @property
    def dataset(self):
        return getattr(self.dataloader, "dataset", None)

    def set_epoch(self, epoch: int) -> None:
        self.iteration = epoch
        if hasattr(self.dataloader, "set_epoch"):
            self.dataloader.set_epoch(epoch)
        elif hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _fetch_global_batch(self, iterator):
        """(global batch, stop), the batch read on process 0 and broadcast."""
        main = _process_index() == 0
        if main:
            if self.split_batches:
                try:
                    batch = _batch_to_numpy(next(iterator))
                except StopIteration:
                    batch = None
            else:
                batches = []  # one per process; a partial round keeps what it has
                for _ in range(_num_processes()):
                    try:
                        batches.append(_batch_to_numpy(next(iterator)))
                    except StopIteration:
                        break
                batch = concatenate(batches, dim=0) if batches else None
            batch_info = [get_data_structure(batch) if batch is not None else None, batch is None]
        else:
            batch, batch_info = None, [None, False]
        broadcast_object_list(batch_info)
        if batch_info[1]:
            return None, True
        batch = (recursively_apply(lambda x: torch.from_numpy(np.ascontiguousarray(x)), batch)
                 if main else initialize_tensors(batch_info[0]))
        return broadcast(batch, from_process=0), False

    def __iter__(self):
        self.begin()
        try:
            iterator = iter(self.dataloader) if _process_index() == 0 else iter(())
            batch_index = 0
            current_batch, stop = self._fetch_global_batch(iterator)
            while not stop:
                next_batch, stop = self._fetch_global_batch(iterator)
                if stop:
                    self.end_of_dataloader = True
                    bs = find_batch_size(current_batch)
                    if bs is not None and bs % _num_processes() != 0:
                        self.remainder = bs
                if batch_index >= self.skip_batches:
                    yield self._yield_batch(current_batch)
                if stop:
                    break
                current_batch = next_batch
                batch_index += 1
            self.iteration += 1
        finally:
            self.end()

    def _yield_batch(self, global_batch):
        bs = find_batch_size(global_batch)
        n = _num_processes()
        if bs is not None and bs % n != 0:
            pad = n - bs % n  # padded with the first rows

            def pad_rows(t):
                return torch.cat([t, t[:pad]]) if t.dim() > 0 else t

            global_batch = recursively_apply(pad_rows, global_batch)
            bs += pad
        if self.batch_group is None and bs is not None and n > 1:
            per, i = bs // n, _process_index()
            global_batch = slice_tensors(global_batch, slice(i * per, (i + 1) * per))
        if self.device is None:
            return global_batch
        return recursively_apply(lambda t: t.to(self.device, non_blocking=self.non_blocking),
                                 global_batch)

    def __len__(self) -> int:
        whole_length = len(self.dataloader)
        if self.split_batches:
            return whole_length - self.skip_batches
        return math.ceil(whole_length / _num_processes()) - self.skip_batches

    @property
    def total_batch_size(self) -> int:
        bs = getattr(self.dataloader, "batch_size", None) or 0
        return bs * (1 if self.split_batches else _num_processes())

    @property
    def total_dataset_length(self) -> int:
        ds = self.dataset
        return len(ds) if ds is not None and hasattr(ds, "__len__") else -1


# ---------------------------------------------------------------------------------- skipping
class SkipBatchSampler:
    """An inner batch sampler's batches from ``skip_batches`` on."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    def __iter__(self):
        for index, samples in enumerate(self.batch_sampler):
            if index >= self.skip_batches:
                yield samples

    def set_epoch(self, epoch):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        return len(self.batch_sampler) - self.skip_batches


class SkipDataLoader(DataLoaderShard):
    """A data loader that skips its first ``skip_batches`` batches."""


def skip_first_batches(dataloader, num_batches: int = 0):
    """The loader resuming after ``num_batches`` batches of its epoch: a prepared loader
    is re-wrapped with the same settings; another loader becomes a ``SkipDataLoader``."""
    if isinstance(dataloader, DataLoaderDispatcher):
        return DataLoaderDispatcher(dataloader.dataloader, device=dataloader.device,
                                    split_batches=dataloader.split_batches,
                                    skip_batches=num_batches,
                                    _non_blocking=dataloader.non_blocking,
                                    batch_group=dataloader.batch_group)
    if isinstance(dataloader, DataLoaderShard):
        return DataLoaderShard(dataloader.dataloader, device=dataloader.device,
                               rng_types=dataloader.rng_types,
                               synchronized_generator=dataloader.synchronized_generator,
                               skip_batches=num_batches, _non_blocking=dataloader.non_blocking,
                               stateful=dataloader.stateful,
                               prefetch_depth=dataloader.prefetch_depth,
                               batch_group=dataloader.batch_group)
    return SkipDataLoader(dataloader, skip_batches=num_batches)


# ----------------------------------------------------------------------------------- prepare
def _is_torch_dataloader(obj) -> bool:
    return isinstance(obj, torch.utils.data.DataLoader)


def _extract_torch_parts(dataloader):
    """(dataset, batch_sampler, collate_fn, sampler, shuffled) of a torch DataLoader."""
    sampler = getattr(dataloader, "sampler", None)
    return (dataloader.dataset, dataloader.batch_sampler, dataloader.collate_fn, sampler,
            isinstance(sampler, torch.utils.data.RandomSampler))


def prepare_data_loader(dataloader, device=None, num_processes: Optional[int] = None,
                        process_index: Optional[int] = None, split_batches: bool = False,
                        put_on_device: bool = True, rng_types: Optional[list[str]] = None,
                        dispatch_batches: Optional[bool] = None, even_batches: bool = True,
                        use_seedable_sampler: bool = True, data_seed: Optional[int] = None,
                        non_blocking: bool = False, use_stateful_dataloader: bool = False,
                        prefetch_depth: int = 1, batch_group=None,
                        ) -> Union[DataLoaderShard, DataLoaderDispatcher]:
    """Shard a data loader over processes: each process loads its share of every
    (global) batch and places it on ``device`` (None: numpy batches on the host).
    ``batch_group`` (a group of the port's mesh): the shards are gathered into the
    global batch on every rank of the group."""
    if num_processes is None:
        num_processes = _num_processes()
    if process_index is None:
        process_index = _process_index()
    if dispatch_batches and use_stateful_dataloader:
        raise ValueError(
            "use_stateful_dataloader (mid-epoch resume) is not implemented for "
            "dispatch_batches=True loaders; use shard mode or checkpoint at epoch "
            "boundaries.")
    if use_stateful_dataloader and not use_seedable_sampler:
        raise ValueError(
            "use_stateful_dataloader requires use_seedable_sampler=True: mid-epoch resume "
            "skips by batch count, which is only correct under a deterministic "
            "(seed, epoch) data order.")
    device = device if put_on_device else None

    synchronized_generator = None
    if _is_torch_dataloader(dataloader):
        dataset, _, collate, sampler, shuffle = _extract_torch_parts(dataloader)
        if hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__"):
            if shuffle and use_seedable_sampler:
                sampler = SeedableRandomSampler(dataset, seed=data_seed or 0)
            elif shuffle:  # torch's own order, its generator synchronised over processes
                synchronized_generator = getattr(sampler, "generator", None)
            else:
                sampler = SequentialSampler(dataset)
            dataloader = DataLoader(dataset, batch_size=dataloader.batch_size, sampler=sampler,
                                    drop_last=dataloader.drop_last, collate_fn=collate)

    if dispatch_batches:
        if prefetch_depth > 1:
            logger.warning(
                "prefetch_depth=%d is not supported by dispatch_batches=True loaders "
                "(main-process broadcast is one batch at a time); running with the "
                "built-in one-batch lookahead", prefetch_depth)
        return DataLoaderDispatcher(dataloader, device=device, split_batches=split_batches,
                                    _non_blocking=non_blocking, batch_group=batch_group)

    shard_kw = dict(device=device, rng_types=rng_types, _non_blocking=non_blocking,
                    stateful=use_stateful_dataloader, prefetch_depth=prefetch_depth,
                    batch_group=batch_group)
    dataset = getattr(dataloader, "dataset", dataloader)
    if num_processes == 1:
        return DataLoaderShard(dataloader, synchronized_generator=synchronized_generator,
                               **shard_kw)
    if hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__") and hasattr(
            dataloader, "batch_sampler"):
        sharded = BatchSamplerShard(dataloader.batch_sampler, num_processes=num_processes,
                                    process_index=process_index, split_batches=split_batches,
                                    even_batches=even_batches)
        inner = DataLoader(dataset, batch_sampler=sharded,
                           collate_fn=getattr(dataloader, "collate_fn", None) or default_collate)
        return DataLoaderShard(inner, synchronized_generator=synchronized_generator, **shard_kw)
    shard = IterableDatasetShard(dataset, batch_size=getattr(dataloader, "batch_size", 1) or 1,
                                 drop_last=getattr(dataloader, "drop_last", False),
                                 num_processes=num_processes, process_index=process_index,
                                 split_batches=split_batches)
    bs = getattr(dataloader, "batch_size", 1) or 1
    inner = _IterableLoader(shard, getattr(dataloader, "collate_fn", None) or default_collate,
                            bs // num_processes if split_batches else bs)
    return DataLoaderShard(inner, **shard_kw)


class _IterableLoader:
    """An ``IterableDatasetShard``'s elements in batches."""

    def __init__(self, shard: IterableDatasetShard, collate_fn, batch_size: int):
        self.dataset = shard
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.drop_last = shard.drop_last

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)

    def __len__(self):
        return math.ceil(len(self.dataset) / self.batch_size)

    def __iter__(self):
        batch = []
        for element in self.dataset:
            batch.append(element)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)
