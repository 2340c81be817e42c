"""The port's data pipeline (``accelerate_tpu_torch/data_loader.py``) against the JAX
package's ``data_loader``, on the CPU.

Mirrors ``tests/test_data_loader.py``'s 30 tests. The samplers' index math is pure
Python on both sides: every ``BatchSamplerShard`` and ``IterableDatasetShard`` output
over the same parameter grid must equal JAX's exactly, beside the same invariants.
Prepared loaders are held to JAX's batch for batch (values, ``remainder``,
``end_of_dataloader``, ``skip_first_batches``, ``prefetch_depth`` bounds and stateful
mid-epoch resume); the port's batches are tensors on the named device (JAX's are device
arrays), numpy without a device, as in JAX.
"""

import math

import numpy as np
import pytest
import torch

from accelerate_tpu import data_loader as jdl
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu_torch import data_loader as tdl
from accelerate_tpu_torch.data_loader import (
    BatchSampler,
    BatchSamplerShard,
    DataLoader,
    DataLoaderShard,
    IterableDatasetShard,
    SeedableRandomSampler,
    SequentialSampler,
    SkipBatchSampler,
    default_collate,
    prepare_data_loader,
    skip_first_batches,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def make_batch_sampler(n, batch_size, drop_last=False):
    return BatchSampler(SequentialSampler(range(n)), batch_size, drop_last)


def jax_batch_sampler(n, batch_size, drop_last=False):
    return jdl.BatchSampler(jdl.SequentialSampler(range(n)), batch_size, drop_last)


def _shards(n, batch_size, num_processes, drop_last=False, **kw):
    """Each process's batches from the port's and from JAX's BatchSamplerShard."""
    ours = [BatchSamplerShard(make_batch_sampler(n, batch_size, drop_last), num_processes, p,
                              **kw) for p in range(num_processes)]
    theirs = [jdl.BatchSamplerShard(jax_batch_sampler(n, batch_size, drop_last),
                                    num_processes, p, **kw) for p in range(num_processes)]
    outputs = [list(s) for s in ours]
    assert outputs == [list(s) for s in theirs]
    assert [len(s) for s in ours] == [len(s) for s in theirs]
    return ours, outputs


# --------------------------------------------------------------------- BatchSamplerShard
@pytest.mark.parametrize("n", [24, 22, 21, 8, 7, 3, 2, 1])
@pytest.mark.parametrize("batch_size", [3, 4])
@pytest.mark.parametrize("num_processes", [1, 2, 3])
def test_batch_sampler_shard_even_batches_invariants(n, batch_size, num_processes):
    shards, outputs = _shards(n, batch_size, num_processes, split_batches=False,
                              even_batches=True)
    assert len({len(o) for o in outputs}) == 1
    assert all(len(b) == batch_size for o in outputs for b in o)
    for s, o in zip(shards, outputs):
        assert len(s) == len(o)
    interleaved = [i for k in range(len(outputs[0])) for p in range(num_processes)
                   for i in outputs[p][k]]
    assert interleaved[:n] == list(range(n))
    assert all(v == j % n for j, v in enumerate(interleaved[n:]))


@pytest.mark.parametrize("n", [24, 22, 21, 7])
@pytest.mark.parametrize("num_processes", [2, 3])
def test_batch_sampler_shard_uneven(n, num_processes):
    _, outputs = _shards(n, 4, num_processes, even_batches=False)
    assert sorted(i for o in outputs for b in o for i in b) == list(range(n))


@pytest.mark.parametrize("n", [24, 22, 21, 7])
@pytest.mark.parametrize("num_processes", [2, 3])
def test_batch_sampler_shard_drop_last(n, num_processes):
    _, outputs = _shards(n, 4, num_processes, drop_last=True)
    assert len({len(o) for o in outputs}) == 1
    n_full = (n // 4) // num_processes * num_processes
    assert sum(len(b) for o in outputs for b in o) == n_full * 4


@pytest.mark.parametrize("n", [24, 22, 8])
@pytest.mark.parametrize("num_processes", [2, 4])
def test_batch_sampler_shard_split_batches(n, num_processes):
    _, outputs = _shards(n, 8, num_processes, split_batches=True)
    assert len({len(o) for o in outputs}) == 1
    for i in range(len(outputs[0])):
        combined = [x for p in range(num_processes) for x in outputs[p][i]]
        assert all(v == (i * 8 + j) % n for j, v in enumerate(combined))


@pytest.mark.parametrize("n", [23, 13])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_shard_split_uneven_matches_jax(n, drop_last):
    """The split path's short last global batch, kept apart or dropped."""
    for even in (True, False):
        _shards(n, 8, 2, drop_last=drop_last, split_batches=True, even_batches=even)


def test_batch_sampler_shard_split_batches_indivisible_raises():
    with pytest.raises(ValueError):
        BatchSamplerShard(make_batch_sampler(24, 3), 2, 0, split_batches=True)


def test_batch_sampler_shard_explicit_reference_case():
    s0 = list(BatchSamplerShard(make_batch_sampler(24, 3), 2, 0))
    s1 = list(BatchSamplerShard(make_batch_sampler(24, 3), 2, 1))
    assert s0 == [[0, 1, 2], [6, 7, 8], [12, 13, 14], [18, 19, 20]]
    assert s1 == [[3, 4, 5], [9, 10, 11], [15, 16, 17], [21, 22, 23]]


def test_batch_sampler_shard_tail_padding_explicit():
    s0 = list(BatchSamplerShard(make_batch_sampler(22, 3), 2, 0))
    s1 = list(BatchSamplerShard(make_batch_sampler(22, 3), 2, 1))
    assert s0[-1] == [18, 19, 20]
    assert s1[-1] == [21, 0, 1]


# ------------------------------------------------------------------- IterableDatasetShard
@pytest.mark.parametrize("n", [24, 22, 21, 7, 2])
@pytest.mark.parametrize("num_processes", [1, 2, 3])
@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_shard(n, num_processes, drop_last):
    kw = dict(batch_size=4, drop_last=drop_last, num_processes=num_processes)
    shards = [IterableDatasetShard(list(range(n)), process_index=p, **kw)
              for p in range(num_processes)]
    outputs = [list(s) for s in shards]
    assert outputs == [list(jdl.IterableDatasetShard(list(range(n)), process_index=p, **kw))
                       for p in range(num_processes)]
    assert len({len(o) for o in outputs}) == 1
    real = 4 * num_processes
    expected = (n // real) * real if drop_last else math.ceil(n / real) * real
    assert sum(len(o) for o in outputs) == expected
    assert [len(s) for s in shards] == [len(o) for o in outputs]
    interleaved = [x for g in range(len(outputs[0]) // 4) for p in range(num_processes)
                   for x in outputs[p][g * 4:(g + 1) * 4]]
    assert all(v == j % n for j, v in enumerate(interleaved))


# -------------------------------------------------------------------------- seedable rng
def test_seedable_random_sampler_matches_jax():
    s = SeedableRandomSampler(range(100), seed=12)
    a = list(s)
    assert a == list(s) == list(jdl.SeedableRandomSampler(range(100), seed=12))
    s.set_epoch(1)
    c = list(s)
    assert a != c and c == list(jdl.SeedableRandomSampler(range(100), seed=12, epoch=1))
    assert list(SeedableRandomSampler(range(100), seed=12, epoch=1)) == c
    assert sorted(a) == list(range(100))


# ----------------------------------------------------------------------- DataLoaderShard
class DictDataset:
    def __init__(self, n):
        self.x = np.arange(n, dtype=np.float32).reshape(n, 1)
        self.y = np.arange(n)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def _jax_batches(dl_kwargs, n=16, **prep):
    """JAX's prepared loader over ``DictDataset(n)``: batches as numpy, with the
    gradient state's (end_of_dataloader, remainder) at each."""
    loader = jdl.prepare_data_loader(jdl.DataLoader(DictDataset(n), **dl_kwargs), device=None,
                                     **prep)
    gs = JGradientState()
    out = [({k: np.asarray(v) for k, v in b.items()}, gs.end_of_dataloader, gs.remainder)
           for b in loader]
    JGradientState._reset_state()
    return out


@pytest.mark.parametrize("n", [16, 20])
def test_dataloader_shard_gradient_state_tracking(n):
    """Batches on the device, ``in_dataloader`` while iterating, and the end known at the
    last batch with its remainder: JAX's, batch for batch."""
    prepared = prepare_data_loader(DataLoader(DictDataset(n), batch_size=8), device="cpu")
    gs = GradientState()
    seen = []
    for batch in prepared:
        assert gs.in_dataloader
        assert torch.is_tensor(batch["x"]) and batch["x"].device.type == "cpu"
        seen.append(({k: v.numpy() for k, v in batch.items()}, gs.end_of_dataloader,
                     gs.remainder))
    assert not gs.in_dataloader
    want = _jax_batches({"batch_size": 8}, n)
    assert [s[1:] for s in seen] == [w[1:] for w in want]
    for (got, _, _), (ref, _, _) in zip(seen, want, strict=True):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_dataloader_shard_remainder():
    prepared = prepare_data_loader(DataLoader(DictDataset(20), batch_size=8), device=None)
    gs = GradientState()
    remainders = [gs.remainder for _ in prepared]
    assert remainders == [-1, -1, 4]


def test_dataloader_len_and_total_batch_size():
    prepared = prepare_data_loader(DataLoader(DictDataset(24), batch_size=6))
    assert len(prepared) == 4
    assert prepared.total_dataset_length == 24
    assert prepared.total_batch_size == 6


def test_skip_first_batches():
    prepared = prepare_data_loader(DataLoader(DictDataset(24), batch_size=6))
    batches = list(skip_first_batches(prepared, 2))
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[0]["y"], np.arange(12, 18))
    want = list(jdl.skip_first_batches(jdl.prepare_data_loader(
        jdl.DataLoader(DictDataset(24), batch_size=6)), 2))
    for g, w in zip(batches, want, strict=True):
        np.testing.assert_array_equal(g["y"], np.asarray(w["y"]))


def test_skip_batch_sampler():
    bs = SkipBatchSampler(make_batch_sampler(24, 4), skip_batches=3)
    assert len(bs) == 3
    assert list(bs) == list(jdl.SkipBatchSampler(jax_batch_sampler(24, 4), skip_batches=3))
    assert list(bs)[0] == [12, 13, 14, 15]


def test_prepare_torch_dataloader():
    from torch.utils.data import DataLoader as TorchDL, TensorDataset

    ds = TensorDataset(torch.arange(20, dtype=torch.float32).reshape(20, 1))
    batches = list(prepare_data_loader(TorchDL(ds, batch_size=5, shuffle=False)))
    assert len(batches) == 4
    assert isinstance(batches[0][0], np.ndarray)  # no device: host numpy, as in JAX
    np.testing.assert_array_equal(batches[0][0].ravel(), np.arange(5, dtype=np.float32))
    on_cpu = list(prepare_data_loader(TorchDL(ds, batch_size=5), device="cpu"))
    assert torch.is_tensor(on_cpu[0][0]) and torch.equal(on_cpu[3][0].ravel(),
                                                         torch.arange(15.0, 20.0))


def test_prepare_torch_dataloader_shuffled_matches_jax():
    from torch.utils.data import DataLoader as TorchDL, TensorDataset

    ds = TensorDataset(torch.arange(20, dtype=torch.float32))
    torch_dl = TorchDL(ds, batch_size=5, shuffle=True)
    b1 = [b[0].tolist() for b in prepare_data_loader(torch_dl, data_seed=7)]
    b2 = [b[0].tolist() for b in prepare_data_loader(torch_dl, data_seed=7)]
    assert b1 == b2 == [np.asarray(b[0]).tolist()
                        for b in jdl.prepare_data_loader(torch_dl, data_seed=7)]
    assert sorted(x for b in b1 for x in b) == list(range(20))


def test_dispatcher_single_process():
    prepared = prepare_data_loader(DataLoader(DictDataset(16), batch_size=8), device="cpu",
                                   dispatch_batches=True)
    batches = list(prepared)
    assert len(batches) == 2
    assert torch.is_tensor(batches[0]["x"])
    np.testing.assert_array_equal(batches[1]["y"].numpy(), np.arange(8, 16))


def test_dataloader_set_epoch_changes_order():
    prepared = prepare_data_loader(DataLoader(DictDataset(16), batch_size=4, shuffle=True,
                                              generator_seed=3))
    first = [b["y"].tolist() for b in prepared]
    prepared.set_epoch(1)
    second = [b["y"].tolist() for b in prepared]
    assert first != second
    assert sorted(x for b in first for x in b) == sorted(x for b in second for x in b) == list(
        range(16))
    jax_loader = jdl.prepare_data_loader(jdl.DataLoader(DictDataset(16), batch_size=4,
                                                        shuffle=True, generator_seed=3))
    assert first == [b["y"].tolist() for b in jax_loader]
    jax_loader.set_epoch(1)
    assert second == [b["y"].tolist() for b in jax_loader]


def test_default_collate_nested():
    examples = [{"a": (1, np.ones(2))}, {"a": (2, np.zeros(2))}]
    out = default_collate(examples)
    assert out["a"][0].tolist() == [1, 2]
    assert out["a"][1].shape == (2, 2)
    want = jdl.default_collate(examples)
    np.testing.assert_array_equal(out["a"][1], want["a"][1])


# ------------------------------------------------------------------ stateful data loader
class IdxDS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int32(i)}


def _stateful(mod, n, **kw):
    return mod.prepare_data_loader(mod.DataLoader(IdxDS(n), batch_size=4), put_on_device=False,
                                   use_stateful_dataloader=True, **kw)


def test_stateful_dataloader_mid_epoch_resume():
    prepared = _stateful(tdl, 24)
    assert prepared.stateful
    it = iter(prepared)
    [next(it) for _ in range(3)]
    state = prepared.state_dict()
    assert state["batches_yielded"] == 3
    resumed = _stateful(tdl, 24)
    resumed.load_state_dict(state)
    rest = [int(b["idx"][0]) for b in resumed]
    jax_resumed = _stateful(jdl, 24)
    jax_resumed.load_state_dict(state)
    assert rest == [int(b["idx"][0]) for b in jax_resumed] == [12, 16, 20]
    assert len([b for b in resumed]) == 6


def test_stateful_flag_off_keeps_plain_iteration():
    prepared = prepare_data_loader(DataLoader(IdxDS(8), batch_size=4), put_on_device=False)
    assert not prepared.stateful
    _ = [b for b in prepared]
    assert prepared.state_dict()["batches_yielded"] == 0


def test_stateful_peek_or_break_never_skips_data():
    prepared = _stateful(tdl, 16)
    next(iter(prepared))
    assert [int(b["idx"][0]) for b in prepared] == [0, 4, 8, 12]
    prepared.load_state_dict({"iteration": 0, "batches_yielded": 2})
    assert len(prepared) == 2
    assert [int(b["idx"][0]) for b in prepared] == [8, 12]
    assert len(prepared) == 4
    assert [int(b["idx"][0]) for b in prepared] == [0, 4, 8, 12]


def test_stateful_rejected_for_dispatch_mode():
    with pytest.raises(ValueError, match="dispatch_batches"):
        prepare_data_loader(DataLoader(IdxDS(8), batch_size=4), put_on_device=False,
                            dispatch_batches=True, use_stateful_dataloader=True)


def test_skip_first_batches_preserves_stateful():
    assert skip_first_batches(_stateful(tdl, 16), 2).stateful


def test_stateful_requires_deterministic_order():
    with pytest.raises(ValueError, match="seedable"):
        prepare_data_loader(DataLoader(IdxDS(8), batch_size=4), put_on_device=False,
                            use_stateful_dataloader=True, use_seedable_sampler=False)


def test_stateful_restore_refused_on_skip_wrapped_loader():
    skipped = skip_first_batches(_stateful(tdl, 16), 2)
    with pytest.raises(ValueError, match="ambiguous"):
        skipped.load_state_dict({"iteration": 0, "batches_yielded": 1})


# ------------------------------------------------------------------------ prefetch depth
class _CountingShard(DataLoaderShard):
    """Counts placements; the consumer counts yields."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.placed = 0
        self.consumed = 0
        self.max_in_flight_at_place = 0

    def _place(self, batch):
        self.placed += 1
        self.max_in_flight_at_place = max(self.max_in_flight_at_place,
                                          self.placed - self.consumed)
        return super()._place(batch)


def _counting_loader(n_batches, depth, device=None):
    return _CountingShard(DataLoader(IdxDS(n_batches * 2), batch_size=2), prefetch_depth=depth,
                          device=device)


@pytest.mark.parametrize("depth", [1, 2, 3, 8])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_depth_bounds_batches_in_flight(depth, device):
    loader = _counting_loader(6, depth, device)
    seen = []
    for batch in loader:
        loader.consumed += 1
        assert loader.placed - loader.consumed <= depth
        seen.append(int(np.asarray(batch["idx"]).reshape(-1)[0]))
    assert seen == [0, 2, 4, 6, 8, 10]
    assert loader.placed == 6
    assert loader.max_in_flight_at_place <= depth + 1


def test_prefetch_depth_one_matches_historical_lookahead():
    loader = _counting_loader(4, 1)
    for _ in loader:
        loader.consumed += 1
        assert loader.placed - loader.consumed <= 1
    assert loader.max_in_flight_at_place == 2


def test_prefetch_depth_preserves_end_of_dataloader_contract():
    GradientState()
    for depth in (1, 3):
        loader = _counting_loader(5, depth)
        assert [loader.end_of_dataloader for _ in loader] == [False] * 4 + [True], depth


def test_prefetch_depth_flows_from_configuration():
    from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration

    with pytest.raises(ValueError, match="prefetch_depth"):
        DataLoaderConfiguration(prefetch_depth=0)
    prepared = prepare_data_loader(DataLoader(IdxDS(8), batch_size=2), put_on_device=False,
                                   prefetch_depth=3)
    assert prepared.prefetch_depth == 3
    assert skip_first_batches(prepared, 1).prefetch_depth == 3


def test_configuration_env_sentinels(monkeypatch):
    from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration

    monkeypatch.setenv("ACCELERATE_EVEN_BATCHES", "false")
    monkeypatch.setenv("ACCELERATE_DISPATCH_BATCHES", "true")
    cfg = DataLoaderConfiguration()
    assert cfg.even_batches is False and cfg.dispatch_batches is True
    assert cfg.use_seedable_sampler is True
    assert DataLoaderConfiguration(even_batches=True).even_batches is True


def test_accelerator_prepares_loader_and_scheduler():
    """``Accelerator.prepare`` wraps a data loader (registered for checkpointing) and a
    stateful scheduler, which steps only on apply steps; the loader's last batch is an
    apply step whatever the accumulation count."""
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.scheduler import AcceleratedScheduler

    class Counter:
        def __init__(self):
            self.n = 0

        def step(self):
            self.n += 1

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, sd):
            self.n = sd["n"]

    acc = Accelerator(device="cpu", gradient_accumulation_steps=2)
    dl, sched = acc.prepare(DataLoader(DictDataset(10), batch_size=2), Counter())
    assert isinstance(dl, DataLoaderShard) and isinstance(sched, AcceleratedScheduler)
    assert acc._dataloaders == [dl] and acc._schedulers == [sched]
    state = acc.create_train_state({"w": torch.ones(1)}, optim.sgd(0.1))
    step = acc.build_train_step(lambda p, b: (p["w"] * b["x"]).sum())
    syncs = []
    for batch in dl:
        state, _ = step(state, batch)
        sched.step()
        syncs.append(acc.sync_gradients)
    # The last batch applies what it accumulated (sync_with_dataloader), as in JAX.
    assert syncs == [False, True, False, True, True]
    assert sched.scheduler.n == 3 and state.step == 3
