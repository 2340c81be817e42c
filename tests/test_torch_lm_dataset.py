"""The port's indexed LM dataset (``accelerate_tpu_torch/lm_dataset.py`` + its copy of
``native/lmdata.cpp``) against the JAX package's ``lm_dataset``, on the CPU.

Mirrors ``tests/test_lm_dataset.py``: windows tile the corpus, epoch orders are the same
on every instance and change with the epoch and seed, the native shuffle and gather give
the numpy path's bytes, ``iter_batches`` shards are disjoint and equal ``__getitem__``,
validation, and a torch DataLoader through ``Accelerator.prepare`` into a train step.
Every window, epoch order and batch is held equal to JAX's ``TokenDataset`` on the same
corpus, seed and epoch (exact integers: no tolerance).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from accelerate_tpu import lm_dataset as jlm
from accelerate_tpu_torch import lm_dataset
from accelerate_tpu_torch.lm_dataset import TokenDataset, write_token_file
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture()
def corpus(tmp_path):
    tokens = np.random.default_rng(0).integers(0, 1000, size=4097, dtype=np.int32)
    path = tmp_path / "corpus.bin"
    write_token_file(tokens, str(path))
    return tokens, str(path)


def test_windows_tile_corpus(corpus):
    tokens, path = corpus
    ds = TokenDataset(path, seq_len=128, shuffle=False)
    assert len(ds) == 32  # (4097 - 1) // 128
    for i in (0, 7, 31):
        w = ds[i]["tokens"]
        assert w.shape == (129,)
        np.testing.assert_array_equal(w, tokens[i * 128:i * 128 + 129])
    np.testing.assert_array_equal(ds[0]["tokens"][-1:], ds[1]["tokens"][:1])


def test_file_layout_matches_jax(corpus, tmp_path):
    """``write_token_file`` writes the bytes JAX's writes."""
    tokens, path = corpus
    jax_path = tmp_path / "jax.bin"
    jlm.write_token_file(tokens, str(jax_path))
    assert pathlib.Path(path).read_bytes() == jax_path.read_bytes()


@pytest.mark.parametrize("seed", [0, 5, 7])
@pytest.mark.parametrize("epoch", [0, 1, 3])
@pytest.mark.parametrize("seq_len", [16, 64])
def test_epoch_order_and_windows_match_jax(corpus, seed, epoch, seq_len):
    _, path = corpus
    ours, theirs = TokenDataset(path, seq_len=seq_len, seed=seed), jlm.TokenDataset(
        path, seq_len=seq_len, seed=seed)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    np.testing.assert_array_equal(ours._order, theirs._order)
    for i in (0, len(ours) // 2, len(ours) - 1):
        np.testing.assert_array_equal(ours[i]["tokens"], theirs[i]["tokens"])


def test_epoch_shuffle_deterministic_across_instances(corpus):
    _, path = corpus
    a, b = TokenDataset(path, seq_len=64, seed=7), TokenDataset(path, seq_len=64, seed=7)
    a.set_epoch(3)
    b.set_epoch(3)
    np.testing.assert_array_equal(a._order, b._order)
    before = a._order.copy()
    a.set_epoch(4)
    assert not np.array_equal(before, a._order)
    assert sorted(a._order) == list(range(len(a)))
    c = TokenDataset(path, seq_len=64, seed=8)
    c.set_epoch(3)
    assert not np.array_equal(b._order, c._order)


def test_native_library_builds_outside_the_package(corpus):
    """g++ builds the port's own copy of lmdata.cpp into the git-ignored build/native/,
    and its shuffle equals the numpy path's."""
    _, path = corpus
    if not lm_dataset.native_available():
        pytest.skip("no native toolchain")
    from accelerate_tpu_torch import native

    so = native._lib_path("lmdata")
    assert so.exists() and so.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    ds = TokenDataset(path, seq_len=64, seed=5)
    ds.set_epoch(2)
    idx = np.arange(len(ds), dtype=np.int64)
    lm_dataset._shuffle_py(idx, (5 * 1_000_003 + 2 + 1) & ((1 << 64) - 1))
    np.testing.assert_array_equal(ds._order, idx)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("drop_last", [True, False])
def test_iter_batches_match_jax(corpus, world, drop_last):
    _, path = corpus
    ours, theirs = TokenDataset(path, seq_len=64, seed=1), jlm.TokenDataset(path, seq_len=64,
                                                                            seed=1)
    for rank in range(world):
        got = [b["tokens"] for b in ours.iter_batches(8, rank, world, drop_last)]
        want = [b["tokens"] for b in theirs.iter_batches(8, rank, world, drop_last)]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_iter_batches_shards_disjoint_and_match_getitem(corpus):
    _, path = corpus
    ds = TokenDataset(path, seq_len=64, seed=1)
    per_rank = [list(ds.iter_batches(8, rank=rank, world_size=2)) for rank in (0, 1)]
    assert len(per_rank[0]) == len(per_rank[1]) == len(ds) // 8
    serial = list(ds.iter_batches(8))
    for gb, (r0, r1) in enumerate(zip(*per_rank)):
        assert r0["tokens"].shape == r1["tokens"].shape == (4, 65)
        np.testing.assert_array_equal(np.concatenate([r0["tokens"], r1["tokens"]]),
                                      serial[gb]["tokens"])
    np.testing.assert_array_equal(serial[0]["tokens"][0], ds[0]["tokens"])


def test_native_gather_matches_numpy_path(corpus, monkeypatch):
    _, path = corpus
    if not lm_dataset.native_available():
        pytest.skip("no native toolchain")
    ds = TokenDataset(path, seq_len=32, seed=3)
    native = [b["tokens"].copy() for b in ds.iter_batches(16)]
    monkeypatch.setattr(lm_dataset, "_load_native", lambda: None)
    numpy_path = [b["tokens"].copy() for b in ds.iter_batches(16)]
    assert len(native) == len(numpy_path) > 0
    for a, b in zip(native, numpy_path):
        np.testing.assert_array_equal(a, b)


def test_in_memory_source_and_validation():
    ds = TokenDataset(np.arange(257), seq_len=16, shuffle=False)
    assert len(ds) == 16
    with pytest.raises(ValueError, match="no \\["):
        TokenDataset(np.arange(8), seq_len=16)
    with pytest.raises(ValueError, match="divisible"):
        next(TokenDataset(np.arange(257), seq_len=16).iter_batches(3, world_size=2))
    with pytest.raises(ValueError, match="seq_len"):
        TokenDataset(np.arange(257), seq_len=0)


def test_through_accelerator_prepare(corpus):
    """A torch DataLoader over the dataset through ``Accelerator.prepare``: batches are
    tensors on the accelerator's device, the windows JAX's loader yields, and they
    train."""
    from accelerate_tpu.data_loader import prepare_data_loader as jprepare
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama

    _, path = corpus
    cfg = dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32)
    acc = Accelerator(device="cpu")
    ds = TokenDataset(path, seq_len=cfg.max_seq, seed=0)
    dl = acc.prepare(torch.utils.data.DataLoader(ds, batch_size=8, drop_last=True))
    want = list(jprepare(torch.utils.data.DataLoader(
        jlm.TokenDataset(path, seq_len=cfg.max_seq, seed=0), batch_size=8, drop_last=True)))
    got = list(dl)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["tokens"].device.type == "cpu" and torch.is_tensor(g["tokens"])
        np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
    state = acc.create_train_state(llama.init_params(cfg, device="cpu"), optim.adamw(1e-3))
    step = acc.build_train_step(lambda p, b: llama.loss_fn(
        p, {"tokens": b["tokens"] % cfg.vocab_size}, cfg))
    for n, batch in enumerate(dl):
        state, m = step(state, batch)
        if n == 1:
            break
    assert np.isfinite(float(m["loss"]))
