"""The port's speculative-decoding pieces against the JAX package's, on the CPU.

- ``spec_decode.ngram_propose_resident`` (the device n-gram proposer) against JAX's on
  seeded histories and lengths, lanes shorter than ``max_ngram`` included: exactly
  equal. ``NgramDrafter`` against the JAX drafter (mirrors
  tests/test_serving_spec.py::test_ngram_drafter_lookup): exactly equal.
- ``generation.speculative_prefix_accept`` against JAX's: integer logic, exactly equal.
- ``generation.speculative_accept(_batch)``: the port draws from ``torch.Generator``s
  where JAX takes keys, so they agree in distribution: each row's output histogram
  must pass a chi-square test against p at significance 1e-4 (the statistic below the
  0.9999 quantile of chi2 with V-1 degrees of freedom), the batch must equal the
  scalar row for row, and an all-zero residual (p == q) must fall back to p.
- ``models.common.spec_multi_step_decode`` through ``llama.forward_slots_spec_multi``
  against the JAX function at fp32 on ``tiny``, dense and paged, greedy: ``tok_buf``,
  ``emits``, ``counts``, ``proposed`` and ``accepted`` equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from accelerate_tpu import generation as jgen
from accelerate_tpu import spec_decode as jspec
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch import spec_decode as tspec
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
ALPHA = 1e-4  # chi-square significance of the distribution tests


@pytest.fixture(scope="module", autouse=True)
def _no_jax_persistent_cache():
    """Compile the JAX references afresh in this module, as tests/test_compile_cache.py
    does: an executable loaded from the suite's persistent cache (tests/.jax_cache,
    which outlives a run) is not held to compute what a fresh compile computes, and
    these tests compare the two frameworks' tokens and counters exactly."""
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def _histories(seed, B, S, vocab, lengths):
    rng = np.random.default_rng(seed)
    hist = np.zeros((B, S), np.int32)
    for b, n in enumerate(lengths):
        hist[b, :n] = rng.integers(0, vocab, n)
    return hist, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("max_ngram", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_ngram_propose_resident_matches_jax(k, max_ngram):
    """Seeded histories over a 4-token vocabulary (matches everywhere) and a 50-token
    one (few matches), lengths 1 and 2 (shorter than max_ngram) up to the full width."""
    lengths = [1, 2, 3, 7, 17, 31, 32, 12]
    for seed, vocab in ((0, 4), (1, 50), (2, 2)):
        hist, lens = _histories(seed, len(lengths), 32, vocab, lengths)
        want = np.asarray(jspec.ngram_propose_resident(jnp.asarray(hist), jnp.asarray(lens),
                                                       k, max_ngram))
        got = tspec.ngram_propose_resident(torch.from_numpy(hist), torch.from_numpy(lens),
                                           k, max_ngram)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_ngram_drafter_lookup():
    """Mirrors the JAX test of the same name on the port's drafter: longest suffix
    n-gram, latest occurrence, the repeat-last fallback."""
    d = tspec.NgramDrafter(max_ngram=3)
    ctx = np.asarray([1, 2, 3, 9, 1, 2, 3], np.int32)
    assert d._propose_one(ctx, 1).tolist() == [9]
    assert d._propose_one(ctx, 4).tolist() == [9, 1, 2, 3]
    assert d._propose_one(np.asarray([4, 5, 6], np.int32), 3).tolist() == [6, 6, 6]
    assert d._propose_one(np.asarray([7, 8, 7, 9, 7], np.int32), 1).tolist() == [9]
    with pytest.raises(ValueError):
        tspec.NgramDrafter(max_ngram=0)


class _Lane:
    def __init__(self, prompt, tokens):
        self.prompt, self.tokens = prompt, tokens


@pytest.mark.parametrize("max_ngram", [1, 3, 4])
def test_ngram_drafter_matches_jax(max_ngram):
    """``propose`` over seeded lanes (idle lanes included) equals the JAX drafter's."""
    rng = np.random.default_rng(5)
    lanes = [None]
    for n, m in ((1, 0), (3, 2), (12, 5), (30, 9), (2, 1)):
        lanes.append(_Lane(rng.integers(0, 6, n).astype(np.int32),
                           [int(t) for t in rng.integers(0, 6, m)]))
    pending = np.zeros((len(lanes),), np.int32)
    for k in (1, 3, 6):
        want = jspec.NgramDrafter(max_ngram).propose(lanes, pending, pending, k)
        got = tspec.NgramDrafter(max_ngram).propose(lanes, pending, pending, k)
        np.testing.assert_array_equal(got[1:], want[1:])  # row 0: an idle lane


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_prefix_accept_matches_jax(seed):
    """Random proposals and references over a 3-token vocabulary (long matches), live
    masks, budgets from 0 to past k+1 and EOS ids (-1: none): every output equal."""
    rng = np.random.default_rng(seed)
    B, k = 64, 4
    props = rng.integers(0, 3, (B, k)).astype(np.int32)
    ref = rng.integers(0, 3, (B, k + 1)).astype(np.int32)
    ref[::3, :k] = props[::3]  # lanes that accept everything
    live = rng.random(B) < 0.8
    limits = rng.integers(0, k + 3, B).astype(np.int32)
    eos = rng.integers(-1, 3, B).astype(np.int32)
    want = jgen.speculative_prefix_accept(jnp.asarray(props), jnp.asarray(ref),
                                          jnp.asarray(live), jnp.asarray(limits),
                                          jnp.asarray(eos))
    got = tgen.speculative_prefix_accept(torch.from_numpy(props), torch.from_numpy(ref),
                                         torch.from_numpy(live), torch.from_numpy(limits),
                                         torch.from_numpy(eos))
    names = ("n_emit", "last_tok", "hit_eos", "n_accepted")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        emitted = np.asarray(want[0]) > 0
        if name == "last_tok":  # undefined where nothing is emitted, in JAX's contract
            g, w = g.numpy()[emitted], w[emitted]
        else:
            g = g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)


def _chi2_ok(tokens: np.ndarray, p: np.ndarray) -> tuple[bool, float, float]:
    n = len(tokens)
    observed = np.bincount(tokens, minlength=len(p))
    support = p > 0
    assert observed[~support].sum() == 0, "a token outside p's support was drawn"
    expected = n * p[support]
    stat = float(((observed[support] - expected) ** 2 / expected).sum())
    crit = float(stats.chi2.ppf(1 - ALPHA, support.sum() - 1))
    return stat < crit, stat, crit


def test_speculative_accept_preserves_target_distribution():
    """A badly matched draft q: 20,000 scalar accept/reject draws (one generator each)
    and the outputs' histogram passes the chi-square test against p."""
    p = torch.tensor([0.45, 0.30, 0.20, 0.05])
    q = torch.tensor([0.10, 0.10, 0.40, 0.40])
    n = 20_000
    drafts = torch.multinomial(q, n, replacement=True, generator=torch.Generator().manual_seed(1))
    gens = [torch.Generator().manual_seed(1000 + i) for i in range(n)]
    toks = np.asarray([int(tgen.speculative_accept(p, q, d, g)[1])
                       for d, g in zip(drafts, gens)])
    ok, stat, crit = _chi2_ok(toks, p.numpy())
    assert ok, (stat, crit)


def test_speculative_accept_batch_rows_match_scalar_and_p():
    """The batch is the scalar test row for row (per-row generators rebuilt from the
    same seeds); each distinct p row's outputs pass the chi-square test, for a badly
    matched q and for the one-hot q a deterministic drafter induces (accept with
    p(draft), residual p minus the draft's mass)."""
    p_rows = torch.tensor([[0.45, 0.30, 0.20, 0.05], [0.1, 0.2, 0.3, 0.4],
                           [0.7, 0.1, 0.1, 0.1]])
    q_row = torch.tensor([0.10, 0.10, 0.40, 0.40])
    n = 512
    idx = torch.arange(n) % 3
    drafts = torch.multinomial(q_row, n, replacement=True,
                               generator=torch.Generator().manual_seed(3))
    acc_b, tok_b = tgen.speculative_accept_batch(
        p_rows[idx], q_row.expand(n, 4), drafts,
        [torch.Generator().manual_seed(s) for s in range(n)])
    for i in range(n):
        a, t = tgen.speculative_accept(p_rows[idx[i]], q_row, drafts[i],
                                       torch.Generator().manual_seed(i))
        assert bool(a) == bool(acc_b[i]) and int(t) == int(tok_b[i]), i
    m = 60_000
    idx = torch.arange(m) % 3
    for q, drafts in ((q_row.expand(m, 4), torch.multinomial(
            q_row, m, replacement=True, generator=torch.Generator().manual_seed(4))),
            (torch.nn.functional.one_hot(torch.full((m,), 2), 4).float(),
             torch.full((m,), 2))):
        _, toks = tgen.speculative_accept_batch(
            p_rows[idx], q, drafts, [torch.Generator().manual_seed(5_000 + s) for s in range(m)])
        for r in range(3):
            ok, stat, crit = _chi2_ok(toks[idx == r].numpy(), p_rows[r].numpy())
            assert ok, (r, stat, crit)


def test_speculative_accept_zero_residual_guard():
    """p == q exactly: every draft is accepted (ratio 1) and the all-zero residual
    falls back to p instead of drawing from -inf everywhere; a rejected row whose
    residual is all zero still returns a token of p's support."""
    p = torch.tensor([0.0, 0.5, 0.5, 0.0])
    drafts = torch.tensor([1, 2, 1, 2])
    acc, toks = tgen.speculative_accept_batch(
        p.expand(4, 4), p.expand(4, 4), drafts, [torch.Generator().manual_seed(s) for s in range(4)])
    assert acc.all() and torch.equal(toks.long(), drafts)
    # The guard itself: a draft token where p has no mass is always rejected, and the
    # residual p - q of p == q is all zero, so the draw comes from p.
    q = torch.tensor([0.0, 0.5, 0.5, 0.0])
    acc, toks = tgen.speculative_accept_batch(
        p.expand(200, 4), q.expand(200, 4), torch.zeros(200, dtype=torch.long),
        [torch.Generator().manual_seed(100 + s) for s in range(200)])
    assert not acc.any()
    assert set(toks.tolist()) <= {1, 2} and len(set(toks.tolist())) == 2


def _prefill(fwd, params, cfg, cache, prompts, to):
    B = prompts.shape[0]
    logits, cache = fwd(params, to(prompts), cache, to(np.zeros((B,), np.int32)), cfg)
    return logits, cache


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_forward_slots_spec_multi_matches_jax(paged):
    """The same prefilled state through the JAX and the port's fused speculative
    rounds (n-gram proposals, greedy select, 3 lanes, N = 4 rounds, k = 3, budgets
    that end inside a round, an EOS, an idle lane): every output equal."""
    jparams = jl.init_params(JCFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")
    rng = np.random.default_rng(4)
    B, plen, max_len, N, k, ps = 3, 6, 48, 4, 3, 8
    prompts = rng.integers(1, JCFG.vocab_size, (B, plen)).astype(np.int32)
    budgets = np.asarray([9, 5, 7], np.int32)
    active = np.asarray([True, True, False])
    tables = (np.arange(B * (max_len // ps), dtype=np.int32).reshape(B, -1)
              if paged else None)
    kw_j = dict(tables=jnp.asarray(tables), page_size=ps) if paged else {}
    kw_t = dict(tables=torch.from_numpy(tables), page_size=ps) if paged else {}

    def jcache():
        return (jl.init_paged_cache(JCFG, B, max_len, B * max_len // ps, ps) if paged
                else jl.init_cache(JCFG, B, max_len))

    def tcache():
        return (tl.init_paged_cache(TCFG, B, max_len, B * max_len // ps, ps, device="cpu")
                if paged else tl.init_cache(TCFG, B, max_len, device="cpu"))

    jl_fwd = lambda p, t, c, pos, cfg: jl.forward_slots(p, t, c, pos, cfg, **kw_j)  # noqa: E731
    tl_fwd = lambda p, t, c, pos, cfg: tl.forward_slots(p, t, c, pos, cfg, **kw_t)  # noqa: E731
    jlog, jc = _prefill(jl_fwd, jparams, JCFG, jcache(), prompts, jnp.asarray)
    tlog, tc = _prefill(tl_fwd, tparams, TCFG, tcache(), prompts, torch.from_numpy)
    first = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    assert torch.equal(torch.argmax(tlog[:, -1], -1).to(torch.int32), torch.from_numpy(first))
    # EOS: lane 1 stops at its third emission of the plain greedy continuation.
    eos = np.asarray([-1, -1, -1], np.int32)
    hist = np.zeros((B, max_len), np.int32)
    hist[:, :plen] = prompts
    hist[:, plen] = first
    lens = np.full((B,), plen + 1, np.int32)
    pos = np.full((B,), plen, np.int32)

    def run_jax(eos_ids, cache):
        return jl.forward_slots_spec_multi(
            jparams, cache, jnp.asarray(first), jnp.asarray(pos), jnp.asarray(active),
            jnp.asarray(budgets), jnp.asarray(eos_ids),
            lambda h, n: jspec.ngram_propose_resident(h, n, k, 3),
            lambda logits, keys: jnp.argmax(logits, -1).astype(jnp.int32),
            jnp.zeros((B, N * (k + 1), 2), jnp.uint32), jnp.asarray(hist),
            jnp.asarray(lens), N, k, JCFG, **kw_j)[1:]

    probe_buf, probe_emits = (np.asarray(a) for a in run_jax(
        eos, _prefill(jl_fwd, jparams, JCFG, jcache(), prompts, jnp.asarray)[1])[:2])
    lane1 = [int(t) for r in range(N) for t in probe_buf[r, 1, :probe_emits[r, 1]]]
    stop = next(i for i in range(1, len(lane1)) if lane1[i] not in lane1[:i])
    eos[1] = lane1[stop]
    want = run_jax(eos, jc)
    got = tl.forward_slots_spec_multi(
        tparams, tc, torch.from_numpy(first), torch.from_numpy(pos), torch.from_numpy(active),
        torch.from_numpy(budgets), torch.from_numpy(eos),
        lambda h, n: tspec.ngram_propose_resident(h, n, k, 3),
        lambda logits, noise: torch.argmax(logits, -1), None, torch.from_numpy(hist),
        torch.from_numpy(lens), N, k, TCFG, **kw_t)[1:6]
    for name, g, w in zip(("tok_buf", "emits", "counts", "proposed", "accepted"), got, want):
        w = np.asarray(w)
        if name == "tok_buf":  # columns past a round's emissions are don't-care
            em = np.asarray(want[1])
            mask = np.arange(k + 1)[None, None, :] < em[:, :, None]
            g, w = g.numpy()[mask], w[mask]
        else:
            g = g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)
    counts = np.asarray(want[2])
    assert counts[2] == 0 and counts[0] == np.asarray(want[1])[:, 0].sum() >= N
    assert counts[1] == stop + 1  # stopped at the EOS
