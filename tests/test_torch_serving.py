"""The port's ContinuousBatcher against the JAX package's, on the CPU at fp32.

Fixtures follow tests/test_serving_paged.py: the ``tiny`` config at fp32, the JAX
``init_params`` weights (converted for the port), prompts from ``default_rng(0)``,
``max_slots=2, max_len=64, prompt_bucket=16``. Greedy requests must come out token
for token the JAX engine's — dense and paged (``page_size=8``), staggered submits,
chunked prefill, int8 KV pages, cancel and lane reuse, FIFO deferral on a small page
pool. Sampled requests draw from torch generators (not JAX keys), so they are held to
their own contract: right lengths, reproducible per seed, independent of the batch.
The copied ``BlockManager`` is held to cases of tests/test_paged_kv.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu_torch.generation import GenerationConfig
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.paged_kv import (
    BlockManager, KVBudgetError, PagePoolExhausted, pages_for,
)
from accelerate_tpu_torch.serving import ContinuousBatcher, normalize_submit

ENGINE = dict(max_slots=2, max_len=64, prompt_bucket=16)


def _cfgs(**kw):
    return (dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, **kw),
            dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = jl.init_params(jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jcfg.vocab_size, int(n)).astype(np.int32)
               for n in (5, 9, 3, 7, 6, 4)]
    return jparams, tparams, prompts


def _drive(engine, script):
    """Run ``script`` — a list of ("submit", args, kwargs) / ("step",) / ("cancel", i)
    / ("evict", i) — then drain; returns the requests in submit order."""
    reqs = []
    for op in script:
        if op[0] == "submit":
            reqs.append(engine.submit(*op[1], **op[2]))
        elif op[0] == "step":
            engine.step()
        elif op[0] == "cancel":
            assert engine.cancel(reqs[op[1]].uid)
        elif op[0] == "evict":
            assert engine.evict_slot(reqs[op[1]].uid)
    engine.run()
    return reqs


def _both(setup, script, cfg_kw=None, **engine_kw):
    """The same script through the JAX engine and the port's → (jax reqs, port reqs,
    port engine)."""
    jparams, tparams, _ = setup
    if cfg_kw:
        jcfg, tcfg = _cfgs(**cfg_kw)
    else:
        jcfg, tcfg = _cfgs()
    kw = {**ENGINE, **engine_kw}
    jreqs = _drive(JaxBatcher(jparams, jcfg, **kw), script)
    teng = ContinuousBatcher(tparams, tcfg, **kw)
    return jreqs, _drive(teng, script), teng


def _tokens(reqs):
    return [list(map(int, r.tokens)) for r in reqs]


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_greedy_matches_jax(setup, page_size):
    prompts = setup[2]
    script = [("submit", (p,), dict(max_new_tokens=n))
              for p, n in zip(prompts, (6, 4, 8, 3, 5, 7))]
    jreqs, treqs, eng = _both(setup, script, page_size=page_size)
    assert _tokens(treqs) == _tokens(jreqs)
    assert all(r.done for r in treqs)
    s = eng.stats()
    assert s["admitted"] == s["evicted"] == len(prompts)
    assert s["decode_tokens"] == sum(len(r.tokens) for r in treqs) - len(prompts)
    if page_size:
        assert s["pages_in_use"] == 0 and s["kv_free_count"] == s["kv_alloc_count"] > 0


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_staggered_submits_match_jax(setup, page_size):
    prompts = setup[2]
    script = [("submit", (prompts[0],), dict(max_new_tokens=9)), ("step",), ("step",),
              ("submit", (prompts[1],), dict(max_new_tokens=5)), ("step",),
              ("submit", (prompts[2],), dict(max_new_tokens=7)),
              ("submit", (prompts[3],), dict(max_new_tokens=4, eos_token_id=35))]
    jreqs, treqs, _ = _both(setup, script, page_size=page_size)
    assert _tokens(treqs) == _tokens(jreqs)


def test_chunked_prefill_matches_jax(setup):
    """A 40-token prompt takes three 16-token prefill chunks."""
    long_prompt = np.random.default_rng(7).integers(1, 256, 40).astype(np.int32)
    script = [("submit", (long_prompt,), dict(max_new_tokens=8)),
              ("submit", (setup[2][0],), dict(max_new_tokens=6))]
    jreqs, treqs, _ = _both(setup, script, page_size=8)
    assert _tokens(treqs) == _tokens(jreqs)


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_kv_quant_matches_jax(setup, page_size):
    prompts = setup[2]
    script = [("submit", (p,), dict(max_new_tokens=6)) for p in prompts[:4]]
    jreqs, treqs, eng = _both(setup, script, cfg_kw={"kv_quant": True},
                              page_size=page_size)
    assert _tokens(treqs) == _tokens(jreqs)
    assert eng.cache["layers"][0]["k"].dtype == torch.int8


def test_cancel_and_lane_reuse_match_jax(setup):
    """Cancel a queued request, evict an in-flight one: the freed lane (and pages)
    serve the next request; partial tokens are kept."""
    prompts = setup[2]
    script = [("submit", (prompts[0],), dict(max_new_tokens=10)),
              ("submit", (prompts[1],), dict(max_new_tokens=4)),
              ("submit", (prompts[2],), dict(max_new_tokens=5)),
              ("step",), ("step",), ("cancel", 1), ("evict", 0)]
    jreqs, treqs, eng = _both(setup, script, page_size=8, max_slots=1)
    assert _tokens(treqs) == _tokens(jreqs)
    assert [r.done for r in treqs] == [False, False, True]
    assert len(treqs[0].tokens) == 3 and treqs[1].tokens == []
    s = eng.stats()
    assert s["pages_in_use"] == 0 and s["evicted_external"] == 1


def test_pool_pressure_defers_fifo(setup):
    """A 3-page pool holds one request at a time: admissions defer (counted), serve
    in FIFO order with the JAX engine's tokens, and every page comes back."""
    prompts = setup[2]
    script = [("submit", (p,), dict(max_new_tokens=8)) for p in prompts[:3]]
    jreqs, treqs, eng = _both(setup, script, page_size=8, kv_pages=3)
    assert _tokens(treqs) == _tokens(jreqs)
    s = eng.stats()
    assert s["kv_defer_count"] > 0 and s["peak_active_slots"] == 1
    assert s["pages_in_use"] == 0
    with pytest.raises(KVBudgetError):  # could never fit the pool: refused at submit
        eng.submit(prompts[0], max_new_tokens=40)


def test_sampled_requests_contract(setup):
    """Sampled requests: right lengths, the same tokens for the same seed whatever
    else is in the batch (emission i draws from (seed, i)), other seeds differ."""
    _, tparams, prompts = setup
    _, tcfg = _cfgs()
    gen = GenerationConfig(max_new_tokens=7, temperature=0.9, top_k=20, top_p=0.95)

    def run(max_slots, seeds, page_size=8):
        eng = ContinuousBatcher(tparams, tcfg, max_slots=max_slots, max_len=64,
                                prompt_bucket=16, page_size=page_size)
        reqs = [eng.submit(prompts[i], gen=gen, seed=s) for i, s in enumerate(seeds)]
        streamed = []
        greedy = eng.submit(prompts[4], max_new_tokens=5, on_token=streamed.append)
        out, tokens_per_s = eng.run(report_throughput=True)
        assert sorted(r.uid for r in out) == [r.uid for r in reqs + [greedy]]
        assert tokens_per_s > 0 and streamed == greedy.tokens
        return _tokens(reqs), greedy.tokens

    a, ga = run(2, (11, 22, 33))
    b, gb = run(1, (11, 22, 33))
    c, _ = run(3, (11, 22, 33), page_size=0)
    assert a == b == c and ga == gb
    assert all(len(t) == 7 for t in a) and len(ga) == 5
    assert all(0 <= tok < tcfg.vocab_size for t in a for tok in t)
    d, _ = run(2, (12, 23, 34))
    assert d != a


def test_normalize_submit_contract():
    gen = GenerationConfig(max_new_tokens=4, temperature=0.5)
    with pytest.raises(ValueError, match="empty prompt"):
        normalize_submit([])
    with pytest.raises(ValueError, match="greedy"):
        normalize_submit([1, 2], max_new_tokens=3, seed=1)
    with pytest.raises(ValueError, match="seed"):
        normalize_submit([1, 2], gen=gen)
    with pytest.raises(ValueError, match="not both"):
        normalize_submit([1, 2], max_new_tokens=3, gen=gen)
    with pytest.raises(TypeError):
        normalize_submit([1, 2], max_new_tokens=2.5)
    prompt, g = normalize_submit([1, 2], gen=gen, seed=3)
    assert prompt.dtype == np.int32 and g is gen


def test_engine_rejects_bad_geometry(setup):
    _, tparams, prompts = setup
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="kv_pages"):
        ContinuousBatcher(tparams, tcfg, kv_pages=4)
    with pytest.raises(ValueError, match="page_size"):
        ContinuousBatcher(tparams, tcfg, page_size=-1)
    eng = ContinuousBatcher(tparams, tcfg, **ENGINE)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(prompts[0], max_new_tokens=60)


# --------------------------------------------------- the copied BlockManager
def test_block_manager_admit_release_and_exhaustion():
    assert [pages_for(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    mgr = BlockManager(num_pages=8, page_size=4, max_slots=2, max_len=32)
    ids = mgr.admit(0, 10)
    assert len(ids) == 3 and mgr.pages_in_use == 3
    assert (mgr.tables[0, :3] == ids).all() and (mgr.tables[0, 3:] == mgr.SENTINEL).all()
    assert mgr.release_slot(0) == 3 and (mgr.tables[0] == mgr.SENTINEL).all()
    assert len(mgr.admit(1, 32)) == 8 and mgr.free_pages == 0
    small = BlockManager(num_pages=4, page_size=4, max_slots=3, max_len=32)
    small.admit(0, 12)
    assert not small.can_admit(8) and small.can_admit(4)
    with pytest.raises(PagePoolExhausted):
        small.admit(1, 8)
    with pytest.raises(KVBudgetError):
        small.demand(17)
    with pytest.raises(RuntimeError, match="still holds"):
        small.admit(0, 4)


def test_block_manager_refcounts_and_cow():
    mgr = BlockManager(num_pages=8, page_size=4, max_slots=2, max_len=32)
    ids = mgr.admit(0, 16)
    shared = ids[:2]
    mgr.retain(shared)
    assert mgr.shared_pages() == 2
    assert mgr.release_slot(0) == 2 and mgr.pages_in_use == 2
    mgr.admit(1, 16, adopted=list(shared[:1]), cow_partial=True)
    assert mgr.adopt_count == 1 and mgr.cow_count == 1
    mgr.release_slot(1)
    page = mgr.take_copy_page()
    assert page is not None and mgr.refcount[page] == 1 and mgr.cow_count == 2
    assert mgr.release([page]) == 1 and mgr.release(shared) == 2
    assert mgr.pages_in_use == 0
    # detach: the lane empties but its pages keep their references until released
    lane = mgr.admit(0, 8)
    held = mgr.detach_slot(0)
    assert list(held) == list(lane) and (mgr.tables[0] == mgr.SENTINEL).all()
    assert mgr.pages_in_use == 2 and mgr.detach_count == 2
    imported = mgr.import_pages(3)
    assert mgr.pages_in_use == 5
    assert mgr.release(held) == 2 and mgr.release(imported) == 3
    assert mgr.pages_in_use == 0
    s = mgr.stats()
    assert s["alloc_count"] == s["free_count"]
