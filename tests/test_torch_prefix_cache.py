"""The port's prefix cache against the JAX engine's, on the CPU at fp32.

Fixtures follow tests/test_torch_serving.py: the ``tiny`` config at fp32, the JAX
``init_params`` weights converted for the port, ``max_slots=2, max_len=64,
prompt_bucket=16``. Each test mirrors a JAX test (tests/test_serving.py and
tests/test_serving_paged.py, named in its docstring) and drives the JAX engine and the
port's through the same script in lockstep:

- greedy tokens equal, token for token;
- after every step, every prefix counter (entries, hits, misses, capacity and key
  misses, evictions), the admission counters and, paged, every page counter (in use,
  free, shared, alloc, free, COW, adopt, defer) equal the JAX engine's;
- each admission's first-token logits within rtol = atol = 1e-5 (the tolerance of the
  port's other fp32 serving tests: the two frameworks' fp32 sums round differently in
  the last bits).

Dense (a row-cache clone per entry), paged with pages that divide the chunk (shared
pages) and paged with a page size that cuts the chunk (copy-on-write of the boundary
page).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import ContinuousBatcher, _copy_page, _gather_row_paged

ENGINE = dict(max_slots=2, max_len=64, prompt_bucket=16)
JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
STAT_KEYS = ("admitted", "evicted", "decode_steps", "prefix_entries", "prefix_hits",
             "prefix_misses", "prefix_evictions", "prefix_capacity_misses",
             "prefix_key_misses", "bucket_hits", "bucket_misses")
PAGED_KEYS = ("pages_in_use", "pages_free", "kv_shared_pages", "kv_alloc_count",
              "kv_free_count", "kv_cow_count", "kv_adopt_count", "kv_defer_count")
LAYOUTS = {"dense": {}, "paged": {"page_size": 8}, "paged_cow": {"page_size": 12}}


@pytest.fixture(scope="module")
def params():
    jparams = jl.init_params(JCFG)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")


def _ints(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, JCFG.vocab_size, n).astype(np.int32) for n in lengths]


def _record_first_logits(eng, store: list):
    """Wrap the engine's admission so each proceeding admission's first-token logits
    land in ``store`` (as numpy)."""
    admit = eng._prefill_into_slot

    def wrapped(*args, **kw):
        out = admit(*args, **kw)
        if out is not None:
            logits = out[1]
            store.append(logits.numpy() if torch.is_tensor(logits) else np.asarray(logits))
        return out

    eng._prefill_into_slot = wrapped


def lockstep(params, script, **engine_kw):
    """Run ``script`` through the JAX engine and the port's side by side → (jax reqs,
    port reqs, jax engine, port engine). Ops: ("submit", prompt, max_new_tokens),
    ("step",), ("run",) (drain), ("clear",) (evict the whole registry). After every
    step the listed counters must be equal; at the end tokens and first-token logits."""
    jparams, tparams = params
    kw = {**ENGINE, **engine_kw}
    jeng, teng = JaxBatcher(jparams, JCFG, **kw), ContinuousBatcher(tparams, TCFG, **kw)
    jlog, tlog = [], []
    _record_first_logits(jeng, jlog)
    _record_first_logits(teng, tlog)
    keys = STAT_KEYS + (PAGED_KEYS if kw.get("page_size") else ())
    jreqs, treqs = [], []

    def step():
        jeng.step()
        teng.step()
        js, ts = jeng.stats(), teng.stats()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}

    def busy(eng):
        return eng.queue or any(r is not None for r in eng.slot_req)

    for op in list(script) + [("run",)]:
        if op[0] == "submit":
            jreqs.append(jeng.submit(op[1], max_new_tokens=op[2]))
            treqs.append(teng.submit(op[1], max_new_tokens=op[2]))
        elif op[0] == "step":
            step()
        elif op[0] == "run":
            while busy(jeng) or busy(teng):
                step()
        elif op[0] == "clear":
            while jeng._evict_prefix_lru():
                assert teng._evict_prefix_lru()
            assert not teng._evict_prefix_lru()
    assert [list(map(int, r.tokens)) for r in treqs] == [list(map(int, r.tokens)) for r in jreqs]
    assert all(r.done for r in treqs)
    assert len(tlog) == len(jlog) == len(treqs)
    for t, j in zip(tlog, jlog):
        np.testing.assert_allclose(t, j, **TOL)
    return jreqs, treqs, jeng, teng


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shared_prefix_hits_match_jax(params, layout):
    """Mirrors test_prefix_cache_matches_generate_and_hits, ..._parity_and_page_sharing
    and test_prefix_cow_on_divergence: prompts sharing a 2-chunk system prompt hit its
    snapshot (or adopt its pages, copying a cut boundary page); a prompt equal to a
    registered prefix replays its last chunk."""
    system, *suffixes = _ints(1, 32, 5, 9, 3, 13)
    prompts = [np.concatenate([system, s]) for s in suffixes]
    script = [("submit", prompts[0], 6), ("run",)]
    script += [("submit", p, 6) for p in prompts[1:]]
    script += [("run",), ("submit", system, 5), ("submit", system[:16], 4)]
    _, _, _, teng = lockstep(params, script, prefix_cache=4, **LAYOUTS[layout])
    s = teng.stats()
    assert s["prefix_hits"] >= 4 and s["prefix_entries"] == 2  # system[:16], system[:32]
    if layout != "dense":
        # After the drain only registry references remain; nested entries share pages.
        assert s["pages_in_use"] > 0 and s["kv_shared_pages"] > 0 and s["kv_adopt_count"] > 0
        assert (s["kv_cow_count"] > 0) == (layout == "paged_cow")
        while teng._evict_prefix_lru():
            pass
        assert teng.stats()["pages_free"] == teng.stats()["pages_total"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefix_cache_eviction_bounded(params, layout):
    """Mirrors test_prefix_cache_eviction_bounded: one lane, capacity 2, five prompts
    of one full chunk and a tail each."""
    script = []
    for p in _ints(11, *[20] * 5):
        script += [("submit", p, 3), ("run",)]
    _, _, _, teng = lockstep(params, script, prefix_cache=2, max_slots=1, **LAYOUTS[layout])
    s = teng.stats()
    assert s["prefix_entries"] <= 2 and s["prefix_evictions"] == 3


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefix_eviction_mid_flight_recompute(params, layout):
    """Mirrors test_prefix_eviction_mid_flight_recompute: a prompt that IS a registered
    2-chunk prefix whose 1-chunk snapshot was evicted while another request decodes
    (dense: the recompute-all path), beside a prompt of a chunk and a tail."""
    x, y, z = _ints(7, 32, 16, 19)
    script = [("submit", x, 4), ("step",), ("submit", y, 6), ("step",),
              ("submit", x, 5), ("submit", z, 3)]
    _, _, _, teng = lockstep(params, script, prefix_cache=2, **LAYOUTS[layout])
    s = teng.stats()
    assert s["prefix_entries"] <= 2
    # Paged lookups stop a chunk short of the prompt (its last chunk is recomputed),
    # so x's resubmission finds only the evicted 1-chunk prefix there.
    assert s["prefix_hits"] == (1 if layout == "dense" else 0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefix_eviction_capacity_miss_observable(params, layout):
    """Mirrors test_prefix_eviction_capacity_miss_observable: a re-miss on an evicted
    key counts as a capacity miss, a never-seen key as a key miss."""
    a, b = _ints(3, 16, 16)
    script = [("submit", np.concatenate([a, a[:3]]), 2), ("run",),
              ("submit", np.concatenate([b, b[:3]]), 2), ("run",),
              ("submit", np.concatenate([a, a[:5]]), 2)]
    _, _, _, teng = lockstep(params, script, prefix_cache=1, max_slots=1, **LAYOUTS[layout])
    s = teng.stats()
    assert (s["prefix_evictions"], s["prefix_key_misses"], s["prefix_capacity_misses"]) == (2, 2, 1)


@pytest.mark.parametrize("case", ["lru_entry_yields", "adopted_entry_yields"])
def test_registry_pages_reclaimed_under_pressure(params, case):
    """Mirrors test_registry_pages_reclaimed_under_pressure: with every lane drained,
    pages held only by the registry yield to a new admission (4 pages of 8; a one-chunk
    prompt + 2 needs 3, the registered prefix holds 2). Then the last resort: a hit
    whose entry holds a boundary copy (pages of 12) the 3-page pool cannot spare drops
    the adopted entry and is served as a (capacity) miss."""
    a, b = _ints(4, 16, 16)
    if case == "lru_entry_yields":
        script = [("submit", a, 2), ("run",), ("submit", b, 2)]
        engine_kw = dict(page_size=8, kv_pages=4)
    else:
        script = [("submit", a, 2), ("run",), ("submit", np.concatenate([a, a[:4]]), 2)]
        engine_kw = dict(page_size=12, kv_pages=3)
    _, _, _, teng = lockstep(params, script, prefix_cache=4, max_slots=1, **engine_kw)
    s = teng.stats()
    assert s["prefix_evictions"] >= 1 and s["kv_defer_count"] == 0 and s["prefix_hits"] == 0
    if case == "adopted_entry_yields":
        assert s["prefix_capacity_misses"] == 1


def test_registry_cleared_between_requests_repeats_tokens(params):
    """A request served on a registry hit gives the tokens it gets with the registry
    cleared first (all misses): the paged hit gathers the same bytes and runs the same
    chunk programs. (The card's main_prefix phase holds this at 8B, bf16.)"""
    system, s1, s2 = _ints(5, 32, 9, 5)
    script = [("submit", np.concatenate([system, s1]), 5), ("run",),
              ("submit", np.concatenate([system, s2]), 6), ("run",), ("clear",),
              ("submit", np.concatenate([system, s2]), 6)]
    _, treqs, _, teng = lockstep(params, script, prefix_cache=4, page_size=12)
    assert treqs[1].tokens == treqs[2].tokens
    s = teng.stats()
    assert s["prefix_hits"] == 1 and s["prefix_capacity_misses"] == 1


def test_gather_and_copy_page_move_every_plane(params):
    """``_copy_page`` copies every plane of a page (an int8 pool's scale planes too);
    ``_gather_row_paged`` lays pool pages out as the dense row, slots past the prefix
    invalid and the row's device index at the prefix length."""
    cfg = dataclasses.replace(TCFG, kv_quant=True)
    pool = tl.init_paged_cache(cfg, 2, 64, 9, 8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for planes in pool["layers"]:
        for key, t in planes.items():
            t.copy_(torch.randint(-100, 100, t.shape, generator=gen).to(t.dtype))
    _copy_page(pool, 3, 7)
    assert all(torch.equal(t[7], t[3]) for planes in pool["layers"] for t in planes.values())
    assert set(pool["layers"][0]) == {"k", "v", "k_scale", "v_scale"}
    row = tl.init_cache(cfg, 1, 64, device="cpu", device_index=True)
    read_ids = np.array([5, 2, 9, 9, 9, 9, 9, 9], np.int32)  # 9 == SENTINEL: clamps
    _gather_row_paged(pool, row, read_ids, 13, 8)
    for planes, rplanes in zip(pool["layers"], row["layers"]):
        for key, t in planes.items():
            assert torch.equal(rplanes[key][0, :8], t[5])
            assert torch.equal(rplanes[key][0, 8:16], t[2])
            assert torch.equal(rplanes[key][0, 16:24], t[8])
    assert row["valid"][0].tolist() == [i < 13 for i in range(64)]
    assert int(row["index"]) == 13
