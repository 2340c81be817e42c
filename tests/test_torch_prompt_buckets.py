"""The port's bucketed prefill and ``warm_programs()`` against the JAX engine, on the CPU.

Fixtures follow tests/test_torch_serving.py: the ``tiny`` config at fp32, the JAX
``init_params`` weights converted for the port, ``max_slots=2, max_len=64,
prompt_bucket=16``. The engine tests mirror tests/test_compile_cache.py
(``test_bucket_ladder_and_pick``, ``test_serving_bucketed_matches_greedy_reference``
and the paged bucketed engine's two varied workloads) and drive the JAX engine and the
port's in lockstep (``test_torch_prefix_cache.lockstep``): greedy tokens equal, the
bucket, prefix and page counters equal after every step, first-token logits within
rtol = atol = 1e-5.

On the card each prefill program is one CUDA graph per ``(program, width)``; here the
same keys hold plain calls, so the tests count the program surface by those keys.
``warm_programs()`` only enumerates that surface on the CPU; what it runs on the card
(each graph's eager first call on idle inputs) is run here by hand and must leave the
engine's cache, pages and counters as they were.
"""

import numpy as np
import pytest
import torch

from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu_torch.compile_cache import pick_bucket
from accelerate_tpu_torch.serving import ContinuousBatcher
from test_torch_prefix_cache import ENGINE, JCFG, TCFG, _ints, lockstep, params  # noqa: F401


def test_bucket_ladder_and_pick(params):
    """Mirrors test_bucket_ladder_and_pick's ``pick_bucket`` cases (the ladder config is
    not ported) and the engine's validation of ``prompt_buckets``."""
    assert pick_bucket(5, (64, 128)) == 64
    assert pick_bucket(64, (64, 128)) == 64
    assert pick_bucket(65, (64, 128)) == 128
    assert pick_bucket(200, (64, 128)) is None
    assert pick_bucket(3, ()) is None
    tparams = params[1]
    eng = ContinuousBatcher(tparams, TCFG, prompt_buckets=[32, 8, 16, 8], **ENGINE)
    assert eng.prompt_buckets == (8, 16, 32)
    for bad in ((0, 8), (8, 65)):
        with pytest.raises(ValueError, match="prompt_buckets"):
            ContinuousBatcher(tparams, TCFG, prompt_buckets=bad, **ENGINE)
    with pytest.raises(ValueError, match="prefix_cache"):
        ContinuousBatcher(tparams, TCFG, prefix_cache=-1, **ENGINE)


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_serving_bucketed_matches_jax(params, page_size):
    """Mirrors test_serving_bucketed_matches_greedy_reference: on rungs (8, 16, 40),
    prompts of 5, 13 and 6 tokens take the rungs 8, 16 and 8 again; a 44-token prompt
    overflows the ladder, and a 20-token one with a budget of 30 fits its rung 40 only
    under the chunk layout's tighter padding (40 + 30 > 64 >= 32 + 30): both fall back
    to 16-token chunks."""
    prompts = _ints(0, 5, 13, 44, 20, 6)
    script = [("submit", p, n) for p, n in zip(prompts, (4, 4, 4, 30, 4))]
    _, _, _, teng = lockstep(params, script, prompt_buckets=(8, 16, 40), page_size=page_size)
    s = teng.stats()
    assert (s["bucket_misses"], s["bucket_hits"]) == (2, 1)
    assert sorted(teng.prefill_graphs) == [("chunk", 16), ("prefill", 8), ("prefill", 16)]


def test_paged_bucketed_second_workload_adds_no_program(params):
    """Mirrors the paged bucketed engine's compile-surface test: two varied workloads
    (other lengths, budgets, lane churn) on rungs (8, 16, 32); the first touches every
    rung, the second adds no prefill program and no super-step key."""
    wl1 = [("submit", p, 3) for p in _ints(2, 3, 5, 9, 12, 20, 30)]
    wl2 = [("submit", p, 5) for p in _ints(3, 2, 7, 11, 19, 28, 31)]
    _, _, _, teng = lockstep(params, wl1, prompt_buckets=(8, 16, 32), page_size=8,
                             decode_steps=2)
    first = (sorted(teng.prefill_graphs), sorted(teng.graphs))
    assert first[0] == [("prefill", 8), ("prefill", 16), ("prefill", 32)]
    for _, p, n in wl2:
        teng.submit(p, max_new_tokens=n)
    teng.run()
    assert (sorted(teng.prefill_graphs), sorted(teng.graphs)) == first
    s = teng.stats()
    assert s["bucket_misses"] == 3 and s["bucket_hits"] == 9 and s["pages_in_use"] == 0


@pytest.mark.parametrize("engine_kw", [
    dict(prompt_buckets=(8, 16, 48)),
    dict(page_size=8, decode_steps=3),
    dict(prefix_cache=2, page_size=12, decode_steps=2, prompt_buckets=(8,)),
], ids=["buckets", "chunks_paged_n3", "prefix_paged_n2"])
def test_kv_demand_matches_jax(params, engine_kw):
    """``kv_demand`` (what ``submit`` checks) under the bucket, chunk and prefix
    layouts equals the JAX engine's, refusals included."""
    jparams, tparams = params
    kw = {**ENGINE, **engine_kw}
    jeng, teng = JaxBatcher(jparams, JCFG, **kw), ContinuousBatcher(tparams, TCFG, **kw)
    for n, new in ((1, 1), (5, 20), (9, 40), (17, 20), (33, 8), (40, 30), (48, 16)):
        try:
            want = jeng.kv_demand(n, new)
        except ValueError as e:  # the JAX package's KVBudgetError is a ValueError too
            with pytest.raises(ValueError) as got:
                teng.kv_demand(n, new)
            assert type(got.value).__name__ == type(e).__name__
            continue
        assert teng.kv_demand(n, new) == want


EXPECTED_KEYS = {
    "buckets": [("serving.prefill", ["prefill", 8]), ("serving.prefill", ["prefill", 16]),
                ("serving.prefill_chunk", ["chunk", 16])],
    "paged_n4": [("serving.decode_multi_paged", [4, False, True]),
                 ("serving.decode_multi_paged", [4, True, True]),
                 ("serving.prefill", ["prefill", 16]),
                 ("serving.prefill_chunk", ["chunk", 16])],
    "prefix_dense_n2": [("serving.decode_multi", [2, False, False]),
                        ("serving.decode_multi", [2, True, False]),
                        ("serving.prefill_full_logits", ["full_logits", 16]),
                        ("serving.prefill_chunk_keep", ["keep", 16])],
}
WARM_ENGINES = {"buckets": dict(prompt_buckets=(8, 16, 48)),
                "paged_n4": dict(page_size=8, decode_steps=4),
                "prefix_dense_n2": dict(prefix_cache=2, decode_steps=2, prompt_buckets=(8,))}


def _state(eng) -> dict:
    """Everything warming must leave as it was: cache bytes, lane state, pages and
    every counter (host-clock seconds aside: the ``*_s`` keys and the ``queue_wait``
    summary)."""
    s = {k: v for k, v in eng.stats().items() if not k.endswith("_s") and k != "queue_wait"}
    out = {"stats": s, "cache": [t.clone() for planes in eng.cache["layers"]
                                 for t in planes.values()] + [eng.cache["valid"].clone()],
           "positions": eng.positions.copy(), "tokens": eng.tokens.copy(),
           "reg": list(eng._prefix_reg)}
    if eng.paged:
        out["tables"] = eng.block_mgr.tables.copy()
        out["refcount"] = eng.block_mgr.refcount.copy()
    return out


def _assert_same_state(a, b):
    assert a["stats"] == b["stats"] and a["reg"] == b["reg"]
    assert all(torch.equal(x, y) for x, y in zip(a["cache"], b["cache"]))
    for k in ("positions", "tokens", "tables", "refcount"):
        if k in a:
            assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("name", list(WARM_ENGINES))
def test_warm_programs_surface_and_no_state_change(params, name):
    """``warm_programs(max_new_tokens=20)`` enumerates every program such a request can
    reach (the rung 48 cannot: 48 + 20 > 64; a prefix engine warms the prefix programs,
    not its buckets), captures nothing on the CPU, and running each entry's program as
    the card does — mid-flight, with lanes live and a registry — changes no engine
    state; the engine then serves exactly what an engine never warmed serves."""
    tparams = params[1]
    kw = {**ENGINE, **WARM_ENGINES[name]}
    prompts = _ints(6, 21, 7, 35, 11, 18)
    cold, warmed = (ContinuousBatcher(tparams, TCFG, **kw) for _ in range(2))
    for eng in (cold, warmed):
        for p in prompts[:3]:
            eng.submit(p, max_new_tokens=12)
        eng.step()
        eng.step()
    entries = warmed.warm_programs(max_new_tokens=20)
    assert [(e["name"], e["key"]) for e in entries] == EXPECTED_KEYS[name]
    assert all(e["capture_s"] is None and e["pool_bytes"] is None for e in entries)
    before = _state(warmed)
    for e in entries:  # what warm_programs runs on the card for each entry
        warmed._warm_one(tuple(e["key"]))
    _assert_same_state(before, _state(warmed))
    assert _state(cold)["stats"] == before["stats"]
    for eng in (cold, warmed):
        for p in prompts[3:]:
            eng.submit(p, max_new_tokens=9)
    assert [r.tokens for r in cold.run()] == [r.tokens for r in warmed.run()]
    _assert_same_state(_state(cold), _state(warmed))
    assert warmed.prefill_pool_bytes == 0
