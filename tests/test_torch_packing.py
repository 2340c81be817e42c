"""The port's sequence packing (``ops/packing.py``, ``native/packing.cpp``) and the packed
llama forward against the JAX package's, on the CPU (mirrors ``tests/test_packing.py``;
the gpt and t5 packed losses wait for those families' ports).

- ``pack_sequences`` (native and Python), ``pack_seq2seq`` and ``packed_batch_iterator``
  bit for bit against JAX's on random corpora; the port's native packer equals its
  Python one; an oversized sequence raises in both; ``use_native=True`` raises when the
  library is unavailable.
- tiny llama (fp32, ``attn_impl="xla"``) on JAX's seeded params: the packed forward
  isolates segments (each segment's hidden states equal the sequence's alone, atol
  2e-5, JAX's tolerance) and equals JAX's packed forward (atol 2e-5); the packed loss
  equals the token-weighted mean of each sequence's unpacked loss (rtol 2e-5) and JAX's
  packed loss (rtol 1e-5); positions derived from the segments equal the explicit ones
  (rtol 1e-6); the iterator's batches feed ``loss_fn`` (losses equal JAX's, rtol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import packing as jpk
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.ops import packing as tpk


def random_corpus(rng, n=40, max_len=24, vocab=250):
    return [rng.integers(1, vocab, size=rng.integers(1, max_len + 1)).astype(np.int32)
            for _ in range(n)]


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_pack_sequences_matches_jax(native, seed):
    if native and not tpk.native_available():
        pytest.skip("no g++ toolchain")
    rng = np.random.default_rng(seed)
    for _ in range(5):
        seqs = random_corpus(rng, n=int(rng.integers(1, 80)), max_len=int(rng.integers(2, 40)))
        cap = int(rng.integers(40, 64))
        _same(tpk.pack_sequences(seqs, cap, use_native=native),
              jpk.pack_sequences(seqs, cap, use_native=False))
        _same(tpk.pack_sequences(seqs, cap, use_native=native, max_bins=len(seqs)),
              jpk.pack_sequences(seqs, cap, use_native=False, max_bins=len(seqs)))


@pytest.mark.skipif(not tpk.native_available(), reason="no g++ toolchain")
def test_native_matches_python():
    rng = np.random.default_rng(1)
    for _ in range(5):
        seqs = random_corpus(rng, n=int(rng.integers(1, 80)), max_len=int(rng.integers(2, 40)))
        cap = int(rng.integers(40, 64))
        _same(tpk.pack_sequences(seqs, cap, use_native=True),
              tpk.pack_sequences(seqs, cap, use_native=False))


@pytest.mark.parametrize("native", [False, True])
def test_oversized_sequence_raises(native):
    if native and not tpk.native_available():
        pytest.skip("no g++ toolchain")
    with pytest.raises(ValueError, match="exceeds seq_len=32"):
        tpk.pack_sequences([np.arange(50, dtype=np.int32)], seq_len=32, use_native=native)
    with pytest.raises(ValueError):
        tpk.pack_sequences([np.arange(5, dtype=np.int32)] * 4, seq_len=8, max_bins=1,
                           use_native=native)


def test_use_native_raises_when_the_library_is_unavailable(monkeypatch):
    monkeypatch.setattr(tpk, "_load_native", lambda: None)
    with pytest.raises(RuntimeError, match="native packer requested"):
        tpk.pack_sequences([np.arange(5, dtype=np.int32)], 8, use_native=True)
    assert not tpk.native_available()
    assert tpk.pack_sequences([np.arange(5, dtype=np.int32)], 8)["tokens"].shape == (1, 8)


@pytest.mark.parametrize("seed", range(3))
def test_pack_seq2seq_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ins = random_corpus(rng, n=30, max_len=20)
    tgts = random_corpus(rng, n=30, max_len=12)
    _same(tpk.pack_seq2seq(ins, tgts, 32, 16), jpk.pack_seq2seq(ins, tgts, 32, 16))
    for bad in (([np.arange(40)], [np.arange(3)]), ([np.arange(3)], [])):
        for pkg in (tpk, jpk):
            with pytest.raises(ValueError):
                pkg.pack_seq2seq(*bad, 32, 16)
    for pkg in (tpk, jpk):
        with pytest.raises(ValueError, match="empty side"):
            pkg.pack_seq2seq([np.arange(3)], [np.zeros(0, np.int32)], 32, 16)


@pytest.mark.parametrize("drop_last", [False, True])
def test_packed_batch_iterator_matches_jax(drop_last):
    rng = np.random.default_rng(10)
    docs = [rng.integers(1, 200, int(n)).astype(np.int32) for n in rng.integers(1, 30, 200)]
    got = list(tpk.packed_batch_iterator(iter(docs), 32, 4, drop_last=drop_last))
    want = list(jpk.packed_batch_iterator(iter(docs), 32, 4, drop_last=drop_last))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _same(a, b)
    tokens = np.sort(np.concatenate([b["tokens"][b["segment_ids"] != 0] for b in got]))
    if not drop_last:
        np.testing.assert_array_equal(tokens, np.sort(np.concatenate(docs)))
    with pytest.raises(ValueError, match="exceeds seq_len"):
        list(tpk.packed_batch_iterator(iter([np.arange(40)]), 32, 4))


# ------------------------------------------------------------------- the packed forward
def _models():
    jcfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, attn_impl="xla")
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, attn_impl="xla")
    np_params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_jax(np_params, tcfg, device="cpu", master_dtype=torch.float32)
    return jcfg, tcfg, jparams, tparams


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_packed_forward_isolates_segments():
    jcfg, tcfg, jparams, tparams = _models()
    rng = np.random.default_rng(2)
    a = rng.integers(1, tcfg.vocab_size, 11).astype(np.int32)
    b = rng.integers(1, tcfg.vocab_size, 7).astype(np.int32)
    packed = tpk.pack_sequences([a, b], seq_len=24, use_native=False)
    assert packed["tokens"].shape[0] == 1  # both fit one row
    with torch.no_grad():
        x = tl.forward_hidden(tparams, torch.tensor(packed["tokens"]), tcfg,
                              positions=torch.tensor(packed["positions"]),
                              segment_ids=torch.tensor(packed["segment_ids"])).numpy()
        x_a = tl.forward_hidden(tparams, torch.tensor(a[None]), tcfg).numpy()
        x_b = tl.forward_hidden(tparams, torch.tensor(b[None]), tcfg).numpy()
    seg = packed["segment_ids"][0]
    np.testing.assert_allclose(x[0, seg == 1], x_a[0], atol=2e-5)
    np.testing.assert_allclose(x[0, seg == 2], x_b[0], atol=2e-5)
    jx, _ = jl.forward_hidden(jparams, jnp.asarray(packed["tokens"]), jcfg,
                              positions=jnp.asarray(packed["positions"]),
                              shard_activations=False,
                              segment_ids=jnp.asarray(packed["segment_ids"]))
    live = seg != 0
    np.testing.assert_allclose(x[0, live], np.asarray(jx)[0, live], atol=2e-5)


def test_packed_loss_matches_unpacked_sum():
    jcfg, tcfg, jparams, tparams = _models()
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, tcfg.vocab_size, int(n)).astype(np.int32) for n in (9, 6, 12, 5)]
    packed = tpk.pack_sequences(seqs, seq_len=18, use_native=False)
    with torch.no_grad():
        packed_loss = float(tl.loss_fn(tparams, _t(packed), tcfg))
        total, count = 0.0, 0
        for s in seqs:
            loss = float(tl.loss_fn(tparams, {"tokens": torch.tensor(s[None])}, tcfg))
            total += loss * (len(s) - 1)
            count += len(s) - 1
    np.testing.assert_allclose(packed_loss, total / count, rtol=2e-5)
    want = float(jl.loss_fn(jparams, {k: jnp.asarray(v) for k, v in packed.items()}, jcfg))
    np.testing.assert_allclose(packed_loss, want, rtol=1e-5)


def test_positions_derived_from_segments_matches_explicit():
    _, tcfg, _, tparams = _models()
    rng = np.random.default_rng(4)
    seqs = [rng.integers(1, tcfg.vocab_size, int(n)).astype(np.int32) for n in (8, 5, 11)]
    packed = tpk.pack_sequences(seqs, seq_len=16, use_native=False)
    full = _t(packed)
    without = {k: v for k, v in full.items() if k != "positions"}
    with torch.no_grad():
        np.testing.assert_allclose(float(tl.loss_fn(tparams, full, tcfg)),
                                   float(tl.loss_fn(tparams, without, tcfg)), rtol=1e-6)
    np.testing.assert_array_equal(tl.segment_positions(full["segment_ids"]).numpy(),
                                  packed["positions"])
    np.testing.assert_array_equal(
        tl.segment_positions(full["segment_ids"]).numpy(),
        np.asarray(jl.segment_positions(jnp.asarray(packed["segment_ids"]))))


def test_packed_batch_iterator_trains():
    jcfg, tcfg, jparams, tparams = _models()
    rng = np.random.default_rng(11)
    docs = [rng.integers(1, tcfg.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(3, 20, 40)]
    n = 0
    for batch in tpk.packed_batch_iterator(iter(docs), seq_len=24, rows_per_batch=2):
        with torch.no_grad():
            loss = float(tl.loss_fn(tparams, _t(batch), tcfg))
        want = float(jl.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, want, rtol=1e-5)
        n += 1
    assert n > 2
