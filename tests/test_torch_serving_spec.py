"""The port's speculative serving against the JAX engine's, on the CPU at fp32.

Fixtures follow tests/test_serving_spec.py: the ``tiny`` config at fp32 (the JAX tests
use fp32 because exact-token contracts do not survive bf16 near-ties), the JAX
``init_params`` weights converted for the port (``models/convert.params_from_jax``),
prompts from ``default_rng(0)``, ``max_slots=2, max_len=64, prompt_bucket=16``,
``spec_k=3``. Each test mirrors the JAX test named in its docstring.

- Greedy workloads run the JAX engine and the port's in LOCKSTEP (the same script of
  submits, steps, cancels and switches): after every step each request's tokens and
  every ``spec_*`` counter (``spec_proposed``, ``spec_accepted``, ``spec_accept_rate``,
  ``spec_enabled``, ``spec_k``) and the decode counters must be equal.
- Sampled lanes: the port draws from torch generators, the JAX engine from keys, so
  the two match in distribution only (ROADMAP §C). Their contract is checked inside the
  port, bitwise: the fused super-step's tokens = the host loop's = ``spec_k=0``'s.

Waits, not mirrored here: the cross-family GPT draft and the GPT-family fused test
(``models/gpt.py`` is not ported, ROADMAP A.4), MoE dense routing (``moe_experts``
is not ported, A.4), and the ``serving.spec/v1`` telemetry tests (telemetry, A.5).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu.spec_decode import ModelDrafter as JaxModelDrafter
from accelerate_tpu_torch.generation import GenerationConfig
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.spec_decode import ModelDrafter, NgramDrafter

ENGINE = dict(max_slots=2, max_len=64, prompt_bucket=16, spec_k=3)
JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
STAT_KEYS = ("spec_k", "spec_proposed", "spec_accepted", "spec_accept_rate", "spec_enabled",
             "decode_steps", "decode_tokens", "tokens_per_step", "admitted", "evicted",
             "evicted_external")
FUSED = {"dense": dict(decode_steps=4), "paged": dict(decode_steps=4, page_size=8)}


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


@pytest.fixture(scope="module")
def setup():
    jparams = jl.init_params(JCFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, JCFG.vocab_size, int(n)).astype(np.int32)
               for n in (5, 9, 3, 7, 6, 4)]
    return jparams, tparams, prompts


def _busy(eng):
    return bool(eng.queue) or any(r is not None for r in eng.slot_req)


def lockstep(setup, script, drafter=None, **kw):
    """Run ``script`` through the JAX engine and the port's side by side → (port
    engine, port requests). Ops: ("submit", prompt, max_new_tokens[, eos_token_id]),
    ("step",), ("cancel", request index), ("spec", enabled), ("run",) (drain; one is
    appended). ``drafter``: "perfect" (a ModelDrafter over the target's own params) or
    None (the default NgramDrafter). After every step: each request's tokens and
    :data:`STAT_KEYS` equal."""
    jparams, tparams, _ = setup
    kw = {**ENGINE, **kw}
    jd = td = None
    if drafter == "perfect":
        jd, td = JaxModelDrafter(jparams, JCFG), ModelDrafter(tparams, TCFG)
    jeng = JaxBatcher(jparams, JCFG, drafter=jd, **kw)
    teng = ContinuousBatcher(tparams, TCFG, drafter=td, **kw)
    jreqs, treqs = [], []

    def check():
        assert [list(map(int, r.tokens)) for r in treqs] == \
            [list(map(int, r.tokens)) for r in jreqs]
        js, ts = jeng.stats(), teng.stats()
        assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}

    def step():
        jdone = [r.uid for r in jeng.step()]
        tdone = [r.uid for r in teng.step()]
        assert tdone == jdone
        check()

    for op in list(script) + [("run",)]:
        if op[0] == "submit":
            eos = op[3] if len(op) > 3 else None
            jreqs.append(jeng.submit(op[1], max_new_tokens=op[2], eos_token_id=eos))
            treqs.append(teng.submit(op[1], max_new_tokens=op[2], eos_token_id=eos))
        elif op[0] == "step":
            step()
        elif op[0] == "cancel":
            assert teng.cancel(treqs[op[1]].uid) == jeng.cancel(jreqs[op[1]].uid)
            check()
        elif op[0] == "spec":
            jeng.set_spec_enabled(op[1])
            teng.set_spec_enabled(op[1])
        elif op[0] == "run":
            while _busy(jeng) or _busy(teng):
                step()
    return teng, treqs


def port_tokens(tparams, workload, **kw):
    """Tokens of ``workload`` ([(prompt, submit kwargs)]) through one port engine."""
    eng = ContinuousBatcher(tparams, TCFG, **{**ENGINE, **kw})
    reqs = [eng.submit(p, **k) for p, k in workload]
    eng.run()
    assert all(r.done for r in reqs)
    return [list(map(int, r.tokens)) for r in reqs], eng


@pytest.mark.parametrize("layout", ["host_dense", "host_paged", "fused_dense", "fused_paged"])
def test_spec_greedy_staggered_matches_jax(setup, layout):
    """Mirrors test_spec_greedy_staggered_matches_plain and
    test_fused_spec_greedy_staggered_matches_host_loop_and_plain: more requests than
    lanes, varied budgets, the n-gram drafter; the port equals the JAX engine in
    lockstep (tokens and counters after every step), and its spec_k=0 tokens."""
    _, tparams, prompts = setup
    kw = dict(FUSED[layout.split("_")[1]]) if layout.startswith("fused") else \
        (dict(page_size=8) if layout == "host_paged" else {})
    n_new = [6, 4, 8, 3, 5, 7]
    eng, reqs = lockstep(setup, [("submit", p, n) for p, n in zip(prompts, n_new)], **kw)
    assert eng._spec_fused() == layout.startswith("fused")
    plain, _ = port_tokens(tparams, [(p, dict(max_new_tokens=n))
                                     for p, n in zip(prompts, n_new)], spec_k=0)
    assert [r.tokens for r in reqs] == plain
    assert [len(r.tokens) for r in reqs] == n_new
    s = eng.stats()
    assert s["spec_proposed"] >= s["spec_accepted"] >= 0 and s["spec_proposed"] > 0
    if kw.get("page_size"):
        assert s["pages_in_use"] == 0


def _sampled_reference(tparams, workload, spec_kw):
    """(spec tokens, spec_k=0 tokens) of a sampled workload through the port."""
    got, eng = port_tokens(tparams, workload, **spec_kw)
    want, _ = port_tokens(tparams, workload, spec_k=0)
    return got, want, eng


def test_spec_sampled_replay_matches_plain(setup):
    """Mirrors test_spec_sampled_replay_matches_plain (spec_k=2, temperature + top-k):
    replayed draws are bitwise the port's spec_k=0 tokens."""
    _, tparams, prompts = setup
    gen = GenerationConfig(max_new_tokens=6, temperature=0.8, top_k=12)
    workload = [(p, dict(gen=gen, seed=s)) for p, s in zip(prompts[:2], (11, 22))]
    got, want, _ = _sampled_reference(tparams, workload, dict(spec_k=2))
    assert got == want


def test_spec_sampled_top_p_matches_plain(setup):
    """Mirrors test_spec_sampled_top_p_matches_plain: the nucleus filter through the
    replay path, one lane."""
    _, tparams, prompts = setup
    gen = GenerationConfig(max_new_tokens=5, temperature=0.7, top_p=0.8)
    got, want, _ = _sampled_reference(tparams, [(prompts[0], dict(gen=gen, seed=77))],
                                      dict(max_slots=1))
    assert got == want


def test_spec_mixed_greedy_and_sampled_lanes(setup):
    """Mirrors test_spec_mixed_greedy_and_sampled_lanes: a greedy and a sampled lane in
    one verify; the greedy lane equals the JAX engine's tokens, the sampled one the
    port's spec_k=0 tokens."""
    jparams, tparams, prompts = setup
    gen = GenerationConfig(max_new_tokens=6, temperature=0.9, top_k=8)
    workload = [(prompts[0], dict(max_new_tokens=7)), (prompts[1], dict(gen=gen, seed=5))]
    got, want, _ = _sampled_reference(tparams, workload, dict(spec_k=2))
    assert got == want
    jeng = JaxBatcher(jparams, JCFG, **{**ENGINE, "spec_k": 2})
    jreq = jeng.submit(prompts[0], max_new_tokens=7)
    jeng.run()
    assert got[0] == list(map(int, jreq.tokens))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_perfect_model_drafter_accepts_everything(setup, layout):
    """Mirrors test_spec_perfect_model_drafter_accepts_everything: a ModelDrafter over
    the target's own params; accept rate 1.0, 2 decode steps of 4 tokens for 9 tokens,
    in lockstep with the JAX engine. Paged: the draft reads its dense cache through the
    paged dispatch (identity tables over the same storage)."""
    _, _, prompts = setup
    kw = dict(page_size=8) if layout == "paged" else {}
    eng, reqs = lockstep(setup, [("submit", prompts[0], 9)], drafter="perfect", max_slots=1,
                         **kw)
    assert (eng.drafter._paged is not None) == (layout == "paged")
    s = eng.stats()
    assert s["spec_accept_rate"] == 1.0 and s["decode_steps"] == 2
    assert s["tokens_per_step"] == 4.0 and len(reqs[0].tokens) == 9


def test_spec_model_drafter_chunked_prefill(setup):
    """Mirrors test_spec_model_drafter_chunked_prefill: a 20-token prompt over chunks
    of 8 mirrors its layout into the draft cache; lockstep with the JAX engine."""
    prompt = np.random.default_rng(42).integers(1, JCFG.vocab_size, 20).astype(np.int32)
    eng, _ = lockstep(setup, [("submit", prompt, 6)], drafter="perfect", prompt_bucket=8,
                      spec_k=2)
    assert eng.stats()["spec_accept_rate"] == 1.0


def test_spec_eos_mid_round_truncates(setup):
    """Mirrors test_spec_eos_mid_round_truncates: an EOS inside an accepted prefix ends
    the request at the EOS, and the freed lane admits the next request in the same
    step; lockstep."""
    _, tparams, prompts = setup
    ref, _ = port_tokens(tparams, [(prompts[2], dict(max_new_tokens=4))], spec_k=0)
    eng, reqs = lockstep(setup, [("submit", prompts[2], 10, ref[0][3]),
                                 ("submit", prompts[3], 4)], drafter="perfect", max_slots=1)
    assert reqs[0].done and reqs[0].tokens == ref[0] and reqs[1].done


@pytest.mark.parametrize("budget", [2, 3, 5])
def test_spec_budget_never_overruns(setup, budget):
    """Mirrors test_spec_budget_never_overruns (spec_k=4, the perfect drafter): exactly
    the budget, in lockstep."""
    _, _, prompts = setup
    _, reqs = lockstep(setup, [("submit", prompts[1], budget)], drafter="perfect",
                       max_slots=1, spec_k=4)
    assert len(reqs[0].tokens) == budget


def test_spec_cancel_and_evict_mid_stream(setup):
    """Mirrors test_spec_cancel_and_evict_mid_stream: a queued and an in-flight request
    cancelled; the freed lane readmits; lockstep (spec_k=2, one lane)."""
    _, _, prompts = setup
    eng, reqs = lockstep(setup, [("submit", prompts[0], 8), ("submit", prompts[1], 4),
                                 ("step",), ("cancel", 1), ("step",), ("cancel", 0),
                                 ("submit", prompts[2], 5)], max_slots=1, spec_k=2)
    assert not reqs[0].done and reqs[2].done
    assert eng.stats()["evicted_external"] == 1


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_with_prefix_cache(setup, layout):
    """Mirrors test_spec_with_prefix_cache: the n-gram drafter with a prefix-cached
    engine (right-aligned layout); the second request hits; lockstep."""
    rng = np.random.default_rng(7)
    system = rng.integers(1, JCFG.vocab_size, 16).astype(np.int32)
    suffix = rng.integers(1, JCFG.vocab_size, 5).astype(np.int32)
    kw = dict(prompt_bucket=8, prefix_cache=4, spec_k=2)
    if layout == "paged":
        kw["page_size"] = 8
    eng, _ = lockstep(setup, [("submit", np.concatenate([system, suffix]), 5), ("run",),
                              ("submit", system, 5)], **kw)
    assert eng.prefix_hits >= 1


@pytest.mark.parametrize("form", ["host", "fused"])
def test_spec_on_token_streaming_order(setup, form):
    """Mirrors test_spec_on_token_streaming_order (host loop, the perfect drafter) and
    test_fused_spec_streaming_order_and_off_switch's streaming half: on_token fires
    once per token in generation order, equal to the final token lists and to the
    port's spec_k=0 tokens."""
    _, tparams, prompts = setup
    streamed = {i: [] for i in range(3)}
    kw = dict(drafter=ModelDrafter(tparams, TCFG)) if form == "host" else FUSED["dense"]
    eng = ContinuousBatcher(tparams, TCFG, **{**ENGINE, **kw})
    reqs = [eng.submit(p, max_new_tokens=6, on_token=streamed[i].append)
            for i, p in enumerate(prompts[:3])]
    eng.run()
    plain, _ = port_tokens(tparams, [(p, dict(max_new_tokens=6)) for p in prompts[:3]],
                           spec_k=0)
    for i, req in enumerate(reqs):
        assert streamed[i] == req.tokens == plain[i]


def test_spec_residual_mode_runs_and_is_deterministic_per_seed(setup):
    """Mirrors test_spec_residual_mode_runs_and_is_deterministic_per_key: residual
    (Leviathan) acceptance emits exactly the budget and the same tokens for the same
    seed; a residual engine never runs fused."""
    _, tparams, prompts = setup
    gen = GenerationConfig(max_new_tokens=6, temperature=0.8, top_k=12)
    runs = [port_tokens(tparams, [(prompts[0], dict(gen=gen, seed=3))], max_slots=1,
                        spec_k=2, spec_accept="residual", **steps)
            for steps in ({}, {}, {"decode_steps": 4})]
    assert runs[0][0] == runs[1][0] == runs[2][0] and len(runs[0][0][0]) == 6
    assert not runs[2][1]._spec_fused()


def test_spec_stats_counters(setup):
    """Mirrors test_spec_stats_counters: before any decode tokens_per_step and
    spec_accept_rate are None and spec_k is reported; after, one lane proposes spec_k a
    step; the JAX engine's counters are equal."""
    jparams, tparams, prompts = setup
    kw = {**ENGINE, "max_slots": 1, "spec_k": 2}
    jeng, teng = JaxBatcher(jparams, JCFG, **kw), ContinuousBatcher(tparams, TCFG, **kw)
    s0 = teng.stats()
    assert s0["tokens_per_step"] is None and s0["spec_accept_rate"] is None
    assert s0["spec_k"] == 2 and s0["spec_enabled"] is True
    for eng in (jeng, teng):
        eng.submit(prompts[0], max_new_tokens=5)
        eng.run()
    s1 = teng.stats()
    assert s1["decode_steps"] >= 1 and s1["tokens_per_step"] >= 1.0
    assert s1["spec_proposed"] == 2 * s1["decode_steps"]
    assert {k: s1[k] for k in STAT_KEYS} == {k: jeng.stats()[k] for k in STAT_KEYS}


def test_spec_plain_engine_counters_too(setup):
    """Mirrors test_spec_plain_engine_counters_too: a spec_k=0 engine reports the same
    counters (spec_proposed 0, accept rate None, tokens_per_step <= lanes)."""
    _, tparams, prompts = setup
    _, eng = port_tokens(tparams, [(p, dict(max_new_tokens=4)) for p in prompts[:2]],
                         spec_k=0)
    s = eng.stats()
    assert s["spec_k"] == 0 and s["spec_proposed"] == 0 and s["spec_accept_rate"] is None
    assert 0 < s["tokens_per_step"] <= 2.0


def test_spec_validation_errors(setup):
    """Mirrors test_spec_validation_errors: the JAX engine's checks and messages."""
    _, tparams, _ = setup
    base = dict(max_slots=1, max_len=64)
    with pytest.raises(ValueError, match="spec_k=-1"):
        ContinuousBatcher(tparams, TCFG, **base, spec_k=-1)
    with pytest.raises(TypeError, match="spec_k must be an int"):
        ContinuousBatcher(tparams, TCFG, **base, spec_k=2.5)
    with pytest.raises(ValueError, match="spec_accept"):
        ContinuousBatcher(tparams, TCFG, **base, spec_k=2, spec_accept="bogus")
    with pytest.raises(ValueError, match="silently ignored"):
        ContinuousBatcher(tparams, TCFG, **base, drafter=NgramDrafter())
    bad = dataclasses.replace(TCFG, vocab_size=TCFG.vocab_size * 2)
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatcher(tparams, TCFG, **base, spec_k=2,
                          drafter=ModelDrafter(tl.init_params(bad, device="cpu"), bad))
    with pytest.raises(ValueError, match="prefix"):
        ContinuousBatcher(tparams, TCFG, **base, prefix_cache=2, spec_k=2,
                          drafter=ModelDrafter(tparams, TCFG))


# ------------------------------------------------- the fused speculative super-step
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_spec_mixed_lanes_bitwise(setup, layout):
    """Mirrors test_fused_spec_mixed_lanes_bitwise (spec_k=2): greedy, temperature +
    top-k and nucleus lanes share one fused super-step; each lane's noise cursor moves
    by its own acceptance, so the fused tokens equal the host loop's and spec_k=0's,
    bitwise; the greedy lane equals the JAX fused engine's."""
    jparams, tparams, prompts = setup
    gen_tk = GenerationConfig(max_new_tokens=6, temperature=0.8, top_k=12)
    gen_tp = GenerationConfig(max_new_tokens=5, temperature=0.7, top_p=0.8)
    workload = [(prompts[0], dict(max_new_tokens=7)), (prompts[1], dict(gen=gen_tk, seed=11)),
                (prompts[2], dict(gen=gen_tp, seed=77)), (prompts[3], dict(gen=gen_tk, seed=22))]
    paged = dict(page_size=8) if layout == "paged" else {}
    fused, eng = port_tokens(tparams, workload, spec_k=2, **FUSED[layout])
    assert eng._spec_fused()
    host, _ = port_tokens(tparams, workload, spec_k=2, **paged)
    plain, _ = port_tokens(tparams, workload, spec_k=0, **paged)
    assert fused == host == plain
    jeng = JaxBatcher(jparams, JCFG, **{**ENGINE, "spec_k": 2, **FUSED[layout]})
    jreq = jeng.submit(prompts[0], max_new_tokens=7)
    jeng.run()
    assert fused[0] == list(map(int, jreq.tokens))


def test_fused_spec_eos_mid_round_and_same_step_lane_reuse(setup):
    """Mirrors test_fused_spec_eos_mid_round_and_same_step_lane_reuse: an EOS inside a
    round freezes the lane for the remaining rounds; the freed lane admits and finishes
    the next request; lockstep with the JAX fused engine."""
    _, tparams, prompts = setup
    ref, _ = port_tokens(tparams, [(prompts[2], dict(max_new_tokens=4))], spec_k=0)
    eng, reqs = lockstep(setup, [("submit", prompts[2], 10, ref[0][3]),
                                 ("submit", prompts[3], 4)], max_slots=1, **FUSED["dense"])
    assert eng._spec_fused() and reqs[0].tokens == ref[0] and reqs[1].done


@pytest.mark.parametrize("budget", [2, 3, 5, 9])
def test_fused_spec_budget_never_overruns(setup, budget):
    """Mirrors test_fused_spec_budget_never_overruns: exactly the budget at every
    boundary N rounds may straddle; lockstep with the JAX fused engine (paged)."""
    _, _, prompts = setup
    _, reqs = lockstep(setup, [("submit", prompts[1], budget)], max_slots=1, **FUSED["paged"])
    assert len(reqs[0].tokens) == budget


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_spec_off_switch(setup, layout):
    """Mirrors test_fused_spec_streaming_order_and_off_switch's switch:
    set_spec_enabled(False) after one super-step falls back to the plain super-step
    (N stays 4), and back on after two more; lockstep with the JAX fused engine."""
    _, _, prompts = setup
    eng, reqs = lockstep(setup, [("submit", p, 8) for p in prompts[:3]]
                         + [("step",), ("spec", False), ("step",), ("step",),
                            ("spec", True)], **FUSED[layout])
    assert eng.multi_step == 4 and all(len(r.tokens) == 8 for r in reqs)


WARM = {
    "fused_paged": (dict(decode_steps=4, page_size=8),
                    [("serving.decode_multi_paged", [4, False, True]),
                     ("serving.decode_multi_paged", [4, True, True]),
                     ("serving.spec_multi_paged", ["spec", 4, 3, 3, False, True]),
                     ("serving.spec_multi_paged", ["spec", 4, 3, 3, True, True]),
                     ("serving.prefill", ["prefill", 16]),
                     ("serving.prefill_chunk", ["chunk", 16])]),
    "draft_multi": (dict(decode_steps=4, drafter="model"),
                    [("serving.decode_multi", [4, False, False]),
                     ("serving.decode_multi", [4, True, False]),
                     ("serving.draft.decode", ["draft", 3]),
                     ("serving.prefill", ["prefill", 16]),
                     ("serving.prefill_chunk", ["chunk", 16])]),
}


@pytest.mark.parametrize("name", list(WARM))
def test_warm_programs_spec_surface_and_no_state_change(setup, name):
    """``warm_programs()`` on a spec engine lists the fused spec, plain super-step and
    draft entries beside the prefill ones (nothing captured on the CPU); running each
    entry's program as the card does — mid-flight, lanes live — changes no state or
    counter (the cache, draft cache, positions, tokens and stats); the engine then
    serves what an engine never warmed serves."""
    _, tparams, prompts = setup
    kw, expected = WARM[name]
    kw = dict(kw)

    def make():
        d = ModelDrafter(tparams, TCFG) if kw.get("drafter") == "model" else None
        return ContinuousBatcher(tparams, TCFG, **{**ENGINE, **kw, "drafter": d})

    cold, warmed = make(), make()
    for eng in (cold, warmed):
        for p in prompts[:3]:
            eng.submit(p, max_new_tokens=12)
        eng.step()
    entries = warmed.warm_programs(max_new_tokens=20)
    assert [(e["name"], e["key"]) for e in entries] == expected
    assert all(e["capture_s"] is None for e in entries)

    def state(eng):
        planes = [t.clone() for layer in eng.cache["layers"] for t in layer.values()]
        if isinstance(eng.drafter, ModelDrafter):
            planes += [t.clone() for layer in eng.drafter.cache["layers"] for t in layer.values()]
            planes.append(eng.drafter.cache["valid"].clone())
        return (planes + [eng.cache["valid"].clone()], eng.positions.copy(),
                eng.tokens.copy(), eng.stats())

    before = state(warmed)
    for e in entries:
        warmed._warm_one(tuple(e["key"]))
    after = state(warmed)
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert np.array_equal(before[1], after[1]) and np.array_equal(before[2], after[2])
    drop = ("queue_wait_s",)
    assert {k: v for k, v in before[3].items() if k not in drop} == \
        {k: v for k, v in after[3].items() if k not in drop}
    assert [r.tokens for r in cold.run()] == [r.tokens for r in warmed.run()]
