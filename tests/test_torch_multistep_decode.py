"""The port's device-resident multi-step decode against the JAX package's, on the CPU.

``ContinuousBatcher(decode_steps=N)`` runs N decode steps per dispatch
(``llama.forward_slots_multi``; on the card one CUDA-graph replay) and drains the
``[N, B]`` token buffer once. Fixtures follow tests/test_multistep_decode.py: the
``tiny`` config at fp32, the JAX ``init_params`` weights converted for the port
(``models/convert.params_from_jax``), prompts from ``default_rng(0)``, three lanes.

- Greedy tokens are the JAX engine's with the same ``decode_steps``, token for token,
  dense and paged, N in {1, 2, 4, 5}, over staggered admission and budgets that are
  not a multiple of N; EOS inside a super-step; cancel/evict between super-steps.
- Sampled tokens (the port draws from torch generators, not JAX keys) are the port's
  own N = 1 tokens, bitwise: ``sampling_core_dyn_k`` is ``sampling_core`` per row.
- The fixed-shape cache writes that a captured step needs: a dropped write (sentinel
  page, or a slot at or past ``max_len``) leaves every pool and ``valid`` byte
  unchanged, and live writes equal the boolean-mask writes they replace.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch.generation import GenerationConfig
from accelerate_tpu_torch.models import common as tcommon
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.paged_kv import pages_for
from accelerate_tpu_torch.serving import ContinuousBatcher

ENGINE = dict(max_slots=3, max_len=64, prompt_bucket=16)
JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
BUDGETS = [6, 11, 8, 3, 5, 7]


@pytest.fixture(scope="module")
def setup():
    jparams = jl.init_params(JCFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, JCFG.vocab_size, int(n)).astype(np.int32)
               for n in (5, 9, 3, 7, 6, 4)]
    return jparams, tparams, prompts


def _engine(tparams, decode_steps=1, **kw):
    return ContinuousBatcher(tparams, TCFG, decode_steps=decode_steps, **{**ENGINE, **kw})


def _run(engine, prompts, budgets=BUDGETS, eos=None):
    reqs = [engine.submit(p, max_new_tokens=b, eos_token_id=eos)
            for p, b in zip(prompts, budgets)]
    engine.run()
    return [list(map(int, r.tokens)) for r in reqs]


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
@pytest.mark.parametrize("n_steps", [1, 2, 4, 5])
def test_greedy_parity_with_jax(setup, n_steps, page_size):
    """Staggered admission (six requests, three lanes) and budgets that are not a
    multiple of N: token for token the JAX engine's with the same decode_steps."""
    jparams, tparams, prompts = setup
    want = _run(JaxBatcher(jparams, JCFG, decode_steps=n_steps, page_size=page_size,
                           **ENGINE), prompts)
    eng = _engine(tparams, n_steps, page_size=page_size)
    got = _run(eng, prompts)
    assert got == want
    assert [len(t) for t in got] == BUDGETS
    s = eng.stats()
    assert s["multi_step"] == n_steps and s["admitted"] == s["evicted"] == len(prompts)
    assert s["decode_tokens"] == sum(BUDGETS) - len(prompts)
    if page_size:
        assert s["pages_in_use"] == 0 and s["kv_free_count"] == s["kv_alloc_count"] > 0


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_sampled_superstep_equals_one_step(setup, page_size):
    """Sampled lanes (temperature, top-k, top-p) beside a greedy one: the super-step's
    draws are the one-token engine's, bitwise, for every N; on_token streams in
    generation order."""
    _, tparams, prompts = setup
    gens = [GenerationConfig(max_new_tokens=7, temperature=0.8, top_k=7),
            GenerationConfig(max_new_tokens=9, temperature=0.7, top_p=0.9),
            GenerationConfig(max_new_tokens=6, temperature=0.0),
            GenerationConfig(max_new_tokens=5, temperature=1.1, top_p=0.8, top_k=12)]

    def run(n):
        eng = _engine(tparams, n, page_size=page_size)
        streams = [[] for _ in gens]
        reqs = [eng.submit(p, gen=g, seed=100 + i if g.temperature > 0 else None,
                           on_token=streams[i].append)
                for i, (p, g) in enumerate(zip(prompts, gens))]
        eng.run()
        assert [s for s in streams] == [r.tokens for r in reqs]
        if n > 1:  # the first window of each sampled lane, then windows drawn ahead
            assert eng.stats()["noise_s"] > 0.0 and eng.stats()["noise_ahead_s"] > 0.0
        return [r.tokens for r in reqs]

    want = run(1)
    assert [len(t) for t in want] == [g.max_new_tokens for g in gens]
    for n in (2, 4, 5):
        assert run(n) == want, n


def test_eos_inside_superstep_matches_jax(setup):
    """A lane whose EOS lands inside a super-step freezes there: no token past EOS,
    the other lanes decode on — the JAX engine's tokens, for every N."""
    jparams, tparams, prompts = setup
    probe = _run(_engine(tparams), prompts, budgets=[12] * 6)
    eos = next(t[j] for t in probe for j in (1, 2, 3, 5) if j < len(t))
    want = _run(JaxBatcher(jparams, JCFG, decode_steps=4, **ENGINE), prompts,
                budgets=[12] * 6, eos=eos)
    assert any(t[-1] == eos and len(t) < 12 for t in want)
    for n in (1, 2, 4, 5):
        assert _run(_engine(tparams, n), prompts, budgets=[12] * 6, eos=eos) == want, n


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_cancel_and_evict_between_supersteps(setup, page_size):
    """cancel() and evict_slot() at a super-step boundary free the lane (and its pages);
    the freed requests keep their prefix, nothing emitted past the boundary, and the
    survivor's stream is the undisturbed one (the JAX engine's)."""
    jparams, tparams, prompts = setup
    want = _run(JaxBatcher(jparams, JCFG, page_size=page_size, **ENGINE), prompts[:3],
                budgets=[12] * 3)
    eng = _engine(tparams, 4, page_size=page_size)
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts[:3]]
    eng.step()  # admissions (prefill emits token 0) + the first super-step
    eng.step()
    assert eng.cancel(reqs[1].uid) and eng.evict_slot(reqs[2].uid)
    eng.run()
    for i in (1, 2):
        assert not reqs[i].done and len(reqs[i].tokens) == 9
        assert reqs[i].tokens == want[i][:9]
    assert reqs[0].done and reqs[0].tokens == want[0]
    if page_size:
        assert eng.stats()["pages_in_use"] == 0


def test_admission_reserves_the_whole_budget(setup):
    """A paged lane owns the pages of prompt + budget from its admission on, so a
    super-step never needs a table entry that is not there: the lanes' table rows do
    not change across super-steps, and every position written stays in owned pages."""
    _, tparams, prompts = setup
    eng = _engine(tparams, 4, page_size=8)
    budgets = [30, 25, 9]
    reqs = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    eng.step()
    tables = eng.block_mgr.tables.copy()
    for slot, (req, b) in enumerate(zip(reqs, budgets)):
        _, total = eng._plan_prefill(len(req.prompt), b)
        owned = int((tables[slot] != eng.block_mgr.SENTINEL).sum())
        assert owned == pages_for(total + b, 8)
    while all(r is not None for r in eng.slot_req):
        assert (eng.block_mgr.tables == tables).all()
        for slot, req in enumerate(eng.slot_req):
            owned = int((tables[slot] != eng.block_mgr.SENTINEL).sum())
            left = req.gen.max_new_tokens - len(req.tokens)
            assert eng.positions[slot] + min(4, left) <= owned * 8
        eng.step()
    eng.run()
    assert all(r.done for r in reqs) and eng.stats()["pages_in_use"] == 0


def test_ctor_validation(setup):
    """decode_steps: not an int → TypeError, < 1 → ValueError (the JAX engine's)."""
    jparams, tparams, _ = setup
    for bad, exc in ((0, ValueError), (-3, ValueError), (2.5, TypeError), (True, TypeError),
                     ("4", TypeError)):
        with pytest.raises(exc, match="decode_steps"):
            JaxBatcher(jparams, JCFG, decode_steps=bad, **ENGINE)
        with pytest.raises(exc, match="decode_steps"):
            _engine(tparams, bad)
    assert _engine(tparams, np.int64(3)).stats()["multi_step"] == 3


@pytest.mark.parametrize("k", [0, 1, 3, 7, 64])
def test_sampling_core_dyn_k_bitwise(k):
    """Per-row knobs as tensors: the filtered logits bitwise ``filtered_logits``'s and
    the draw bitwise ``sampling_core``'s for every k (0 = disabled), top-p (1.0
    included: the nucleus filter runs) and temperature, with the same noise; and the
    port's draw stays in JAX's filtered support."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32) * 3)
    for t, p in ((0.8, 0.9), (1.3, 1.0), (0.5, 0.3)):
        assert torch.equal(
            tgen.filtered_logits_dyn_k(logits, torch.full((4,), t), torch.full((4,), p),
                                       torch.full((4,), k)),
            tgen.filtered_logits(logits, t, p, k))
        for seed in (0, 1, 2):
            want = tgen.sampling_core(logits, torch.Generator().manual_seed(seed), t, p, k)
            noise = tgen.gumbel_noise(logits.shape, torch.Generator().manual_seed(seed))
            got = tgen.sampling_core_dyn_k(logits, noise, torch.full((4,), t),
                                           torch.full((4,), p), torch.full((4,), k))
            assert torch.equal(got, want), (k, t, p, seed)
        if p < 1.0:  # at 1.0 the fp32 cumsums of the two frameworks may end apart
            support = np.isfinite(np.asarray(jgen.filtered_logits(
                jnp.asarray(logits.numpy()), t, p, k)))
            assert support[np.arange(4), got.numpy()].all()
    # Mixed knobs per row: each row as the static draw with its own knobs.
    temps, tops, ks = [0.8, 1.3, 0.5, 1.0], [0.9, 1.0, 0.3, 0.95], [k, 0, 5, 2]
    noise = tgen.gumbel_noise(logits.shape, torch.Generator().manual_seed(9))
    got = tgen.sampling_core_dyn_k(logits, noise, torch.tensor(temps), torch.tensor(tops),
                                   torch.tensor(ks))
    filt = tgen.filtered_logits_dyn_k(logits, torch.tensor(temps), torch.tensor(tops),
                                      torch.tensor(ks))
    for b in range(4):
        want = tgen.filtered_logits(logits[b:b + 1], temps[b], tops[b], ks[b])
        assert torch.equal(filt[b:b + 1], want)
        assert int(got[b]) == int(torch.argmax(want + noise[b:b + 1]))


# ------------------------------------------------------- fixed-shape cache writes
def _masked_write_kv(dst, plane, index):
    """The boolean-mask per-row write the port used before (the reference)."""
    B, T = plane.shape[:2]
    slots = index.long()[:, None] + torch.arange(T)[None, :]
    rows = torch.arange(B)[:, None].expand(B, T)
    keep = slots < dst.shape[1]
    dst[rows[keep], slots[keep]] = plane[keep].to(dst.dtype)


def _masked_write_paged(dst, plane, pages, offs):
    keep = pages < dst.shape[0]
    dst[pages[keep].long(), offs[keep].long()] = plane[keep].to(dst.dtype)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_dense_writes_equal_masked_writes(quantized):
    """Per-row dense writes at random starts, some running past the cache end (T up to
    4) and some wholly past it: the same bytes as the boolean-mask write; a row whose
    every slot drops keeps every byte."""
    rng = np.random.default_rng(7)
    B, C, K, hd = 5, 12, 2, 4
    for case in range(20):
        T = int(rng.integers(1, 5))
        kv = tcommon.kv_planes(B, C, K, hd, torch.float32, quantized)
        for plane in kv.values():
            plane.copy_(torch.from_numpy(rng.normal(size=plane.shape) * 50).to(plane.dtype))
        want = {k: v.clone() for k, v in kv.items()}
        index = torch.from_numpy(rng.integers(0, C + 3, B)).to(torch.int32)
        index[0] = C  # a frozen lane: every slot drops
        val = torch.from_numpy(rng.normal(size=(B, T, K, hd)).astype(np.float32))
        before = {k: v.clone() for k, v in kv.items()}
        tcommon.write_kv(kv, "k", val, index)
        for key, plane in tcommon._planes(want, "k", val):
            _masked_write_kv(want[key], plane, index)
        for key in kv:
            assert torch.equal(kv[key], want[key]), (case, key)
            assert torch.equal(kv[key][0], before[key][0]), (case, key)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_paged_writes_equal_masked_writes(quantized):
    """Paged writes through random tables with sentinel entries: the same bytes as the
    boolean-mask write; a call whose every entry is the sentinel keeps every byte."""
    rng = np.random.default_rng(8)
    P, ps, K, hd = 9, 4, 2, 4
    for case in range(20):
        B, T = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        pool = tcommon.paged_kv_planes(P, ps, K, hd, torch.float32, quantized)
        for plane in pool.values():
            plane.copy_(torch.from_numpy(rng.normal(size=plane.shape) * 50).to(plane.dtype))
        # Distinct live slots (a lane writes only its own pages), some sentinel entries.
        flat = rng.permutation(P * ps)[:B * T]
        pages = torch.from_numpy(flat // ps).to(torch.int32).reshape(B, T)
        offs = torch.from_numpy(flat % ps).to(torch.int32).reshape(B, T)
        drop = torch.from_numpy(rng.random((B, T)) < (1.0 if case % 5 == 0 else 0.4))
        pages = torch.where(drop, P, pages)
        val = torch.from_numpy(rng.normal(size=(B, T, K, hd)).astype(np.float32))
        want = {k: v.clone() for k, v in pool.items()}
        before = {k: v.clone() for k, v in pool.items()}
        tcommon.write_kv_paged(pool, "v", val, pages, offs)
        for key, plane in tcommon._planes(want, "v", val):
            _masked_write_paged(want[key], plane, pages, offs)
        for key in pool:
            assert torch.equal(pool[key], want[key]), (case, key)
            if bool(drop.all()):
                assert torch.equal(pool[key], before[key]), (case, key)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_frozen_lane_writes_nothing(setup, paged):
    """A forward_slots step with one lane at max_len (how the super-step freezes a lane)
    leaves that lane's valid row, and (dense) its K/V row, unchanged, while the other
    lanes' writes and logits are those of the step without it."""
    _, tparams, _ = setup
    B, C, ps = 3, 16, 4
    rng = np.random.default_rng(9)
    if paged:
        MP = C // ps
        tables = torch.from_numpy(np.arange(B * MP, dtype=np.int32).reshape(B, MP))
        cache = tl.init_paged_cache(TCFG, B, C, B * MP, ps, device="cpu")
    else:
        tables = None
        cache = tl.init_cache(TCFG, B, C, device="cpu")
    toks = torch.from_numpy(rng.integers(1, 256, (B, 1)).astype(np.int32))
    for pos in range(6):  # fill a few slots of every lane first
        tl.forward_slots(tparams, toks, cache, torch.full((B,), pos, dtype=torch.int32),
                         TCFG, tables=tables, page_size=ps if paged else 0)
    planes = [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]
    valid = cache["valid"].clone()
    positions = torch.tensor([6, C, 7], dtype=torch.int32)
    logits, cache = tl.forward_slots(tparams, toks, cache, positions, TCFG, tables=tables,
                                     page_size=ps if paged else 0)
    assert torch.equal(cache["valid"][1], valid[1])
    assert cache["valid"][0, 6] and cache["valid"][2, 7]
    changed = [(p["k"] != layer["k"]).any() for p, layer in zip(planes, cache["layers"])]
    assert all(changed)
    if not paged:
        for p, layer in zip(planes, cache["layers"]):
            assert torch.equal(layer["k"][1], p["k"][1]) and torch.equal(layer["v"][1], p["v"][1])
    else:
        lane1 = tables[1].long()
        for p, layer in zip(planes, cache["layers"]):
            assert torch.equal(layer["k"][lane1], p["k"][lane1])
    assert torch.isfinite(logits).all()


def test_forward_cached_device_index_equals_int_index(setup):
    """forward_cached with the write index as a 0-d tensor (generate's decode steps)
    gives the logits and cache of the int index, and returns the index advanced."""
    _, tparams, _ = setup
    rng = np.random.default_rng(10)
    prompt = torch.from_numpy(rng.integers(1, 256, (2, 7)).astype(np.int32))
    mask = torch.ones((2, 7), dtype=torch.bool)
    mask[0, :3] = False
    a = tl.init_cache(TCFG, 2, 32, device="cpu")
    b = tl.init_cache(TCFG, 2, 32, device="cpu")
    b["index"] = torch.zeros((), dtype=torch.long)
    la, a = tl.forward_cached(tparams, prompt, a, TCFG, token_mask=mask)
    lb, b = tl.forward_cached(tparams, prompt, b, TCFG, token_mask=mask)
    for _ in range(3):
        tok = torch.argmax(la[:, -1], -1).to(torch.int32)[:, None]
        la, a = tl.forward_cached(tparams, tok, a, TCFG)
        lb, b = tl.forward_cached(tparams, tok, b, TCFG)
        assert torch.equal(la, lb)
    assert torch.is_tensor(b["index"]) and int(b["index"]) == a["index"] == 10
    assert torch.equal(a["valid"], b["valid"])
    for x, y in zip(a["layers"], b["layers"]):
        assert torch.equal(x["k"], y["k"]) and torch.equal(x["v"], y["v"])
