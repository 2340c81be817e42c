"""The port's disaggregated prefill/decode serving against the JAX package's, on the CPU
at fp32.

Fixtures follow tests/test_disagg.py: the ``tiny`` config at fp32, the JAX
``init_params`` weights converted for the port (``models/convert.params_from_jax``),
prompts of 5/9/3/21/7/4 tokens from ``default_rng(0)`` (21 > ``prompt_bucket=16``: a
chunked prefill), engines of ``max_slots=2, max_len=64, prompt_bucket=16, page_size=8``.

- Greedy parity is three-way: the port's ``DisaggRouter``, the port's mixed engine and
  JAX's ``DisaggRouter`` give every request the same tokens, and the router counters
  ``handoffs``, ``handoff_defers`` and ``readopted`` equal JAX's.
- Sampled requests: the port draws from torch generators, JAX from keys, so they match
  in distribution only (ROADMAP §C); the port's disagg tokens equal its mixed engine's,
  bitwise (the decode replica draws emissions 1.. where the prefill drew emission 0).
- Every pool ends with ``pages_in_use == 0`` and no live handoff record.

The ``handoff`` trace span with trace-report, ``FaultPlan`` crash clauses
(``test_injected_crash_faults_failover``) and ``adopt_fault`` terminals are at the end of
this file. Waits, not mirrored here: the warm-up manifest by role (``run_warmup``, the
compile cache) and ``serve-bench --disagg``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.resilience import faults as jfaults
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu.serving_gateway import DisaggRouter as JaxDisaggRouter
from accelerate_tpu.utils.dataclasses import GatewayConfig as JaxGatewayConfig
from accelerate_tpu_torch.generation import GenerationConfig
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.ops.collectives import TransferStats, kv_page_transfer, tree_bytes
from accelerate_tpu_torch.serving import ContinuousBatcher, KVHandoff
from accelerate_tpu_torch.resilience import faults as tfaults
from accelerate_tpu_torch.serving_gateway import DisaggRouter, FleetRouter
from accelerate_tpu_torch.telemetry import Tracer
from accelerate_tpu_torch.spec_decode import ModelDrafter
from accelerate_tpu_torch.telemetry.schemas import (FLEET_ROUTE_SCHEMA, SERVING_HANDOFF_SCHEMA,
                                                    validate_record)
from accelerate_tpu_torch.utils.dataclasses import GatewayConfig

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
ENGINE = dict(max_slots=2, max_len=64, prompt_bucket=16, page_size=8)
ROUTER_COUNTERS = ("handoffs", "handoff_defers", "readopted", "migrated", "replica_kills",
                   "replica_restarts", "replayed", "done")


@pytest.fixture(scope="module", autouse=True)
def _no_jax_persistent_cache():
    """Compile the JAX references afresh in this module, as tests/test_compile_cache.py
    does: an executable loaded from the suite's persistent cache (tests/.jax_cache, which
    outlives a run and can hold executables compiled for another host's CPU features) is
    not held to compute what a fresh compile computes, and these tests compare the two
    frameworks exactly. Setting the cache directory alone does not do it once an earlier
    module in the process has used the cache (JAX initializes it once): the cache is
    switched off and reset, and the in-memory executables are dropped, then restored."""
    from jax._src import compilation_cache

    prev = (jax.config.jax_compilation_cache_dir, jax.config.jax_enable_compilation_cache)
    jax.config.update("jax_compilation_cache_dir", None)
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", prev[0])
        jax.config.update("jax_enable_compilation_cache", prev[1])
        compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def setup():
    jparams = jl.init_params(JCFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, JCFG.vocab_size, int(n)).astype(np.int32)
               for n in (5, 9, 3, 21, 7, 4)]
    return jparams, tparams, prompts


def make_engine(params, role="mixed", cfg=TCFG, batcher=ContinuousBatcher, **kw):
    return batcher(params, cfg, role=role, **{**ENGINE, **kw})


def make_jax_engine(jparams, role="mixed", **kw):
    return make_engine(jparams, role, JCFG, JaxBatcher, **kw)


def make_disagg(params, roles=("prefill", "decode"), factory=False, engine_kw=None,
                jax_side=False, telemetry=None, tracer=None, plans=None, clock=None,
                **cfg_kwargs):
    """A DisaggRouter over one engine per role (the port's, or JAX's with
    ``jax_side``); ``engine_kw[role]`` adds engine keywords; ``plans[rid]`` is replica
    ``rid``'s fault plan (its restarts keep it, as in tests/test_disagg.py);
    ``factory`` gives it a ``(rid, role)`` restart factory."""
    engine_kw = engine_kw or {}
    mk = make_jax_engine if jax_side else make_engine
    router, config = ((JaxDisaggRouter, JaxGatewayConfig) if jax_side
                      else (DisaggRouter, GatewayConfig))

    def build(rid, role):
        per = dict(engine_kw.get(role, {}))
        if plans is not None:
            per["faults"] = plans[rid]
        return mk(params, role=role, **per)

    kw = {} if clock is None else {"clock": clock}
    return router([build(rid, role) for rid, role in enumerate(roles)],
                  config(enabled=True, **cfg_kwargs), telemetry=telemetry, tracer=tracer,
                  roles=list(roles), engine_factory=build if factory else None, **kw)


def drain(router, max_steps=600):
    out, steps = [], 0
    while router.queue_depth or router.running_count:
        out.extend(router.step())
        steps += 1
        assert steps < max_steps, "disagg router stalled"
    return out


def baseline(params, prompts, max_new=6, workload=None, **kw):
    """The port's mixed engine → {prompt bytes: tokens}."""
    eng = make_engine(params, **kw)
    workload = workload or [(p, dict(max_new_tokens=max_new)) for p in prompts]
    reqs = [eng.submit(p, **k) for p, k in workload]
    eng.run()
    while eng._evict_prefix_lru():  # a prefix registry holds pages until evicted
        pass
    assert eng.stats()["pages_in_use"] == 0
    return {r.prompt.tobytes(): [int(t) for t in r.tokens] for r in reqs}


def tokens_of(greqs):
    return [[int(t) for t in g.tokens] for g in greqs]


def assert_pools_clean(router):
    """Every pool free and no handoff record live once the workload drained."""
    assert not router._live_handoffs and not router._handoffs
    for rep in router.replicas:
        if getattr(rep.engine, "crashed", False):
            continue  # a dead pool died with its engine
        ms = rep.engine.block_mgr.stats()
        assert ms["pages_in_use"] == 0, (rep.rid, ms)


def three_way(setup, max_new=6, prompts=None, roles=("prefill", "decode"), engine_kw=None,
              script=None, **cfg_kwargs):
    """Serve ``prompts`` (greedy) through the port's router and JAX's, run ``script``
    (a function of the router, called after the submits) on both → (port router, port
    requests, JAX router, JAX requests); the tokens of both equal the port's mixed
    engine's, and the router counters equal JAX's."""
    jparams, tparams, all_prompts = setup
    prompts = all_prompts if prompts is None else prompts
    refs = baseline(tparams, prompts, max_new)
    out = []
    for jax_side, params in ((False, tparams), (True, jparams)):
        router = make_disagg(params, roles, engine_kw=engine_kw, jax_side=jax_side,
                             **cfg_kwargs)
        greqs = [router.submit(p, max_new_tokens=max_new) for p in prompts]
        if script is not None:
            script(router)
        drain(router)
        assert all(g.status == "done" for g in greqs), [(g.status, g.reason) for g in greqs]
        assert_pools_clean(router)
        out += [router, greqs]
    router, greqs, jrouter, jgreqs = out
    assert tokens_of(greqs) == [refs[p.tobytes()] for p in prompts]
    assert tokens_of(greqs) == tokens_of(jgreqs)
    assert ({k: router.counters[k] for k in ROUTER_COUNTERS}
            == {k: jrouter.counters[k] for k in ROUTER_COUNTERS})
    return router, greqs, jrouter, jgreqs


# ------------------------------------------------------------------ validation
@pytest.mark.parametrize("case", ["role", "dense", "prefill_spec", "prefill_multistep",
                                  "decode_prefix", "decode_submit"])
def test_role_validation(setup, case):
    """Mirrors test_role_validation (engine half): the JAX messages."""
    tparams = setup[1]
    bad = {"role": (ValueError, "role", dict(role="oracle")),
           "dense": (ValueError, "paged", dict(role="prefill", page_size=0)),
           "prefill_spec": (ValueError, "spec_k", dict(role="prefill", spec_k=2)),
           "prefill_multistep": (ValueError, "decode_steps", dict(role="prefill",
                                                                  decode_steps=4)),
           "decode_prefix": (ValueError, "prefix_cache", dict(role="decode", prefix_cache=2))}
    if case == "decode_submit":
        with pytest.raises(RuntimeError, match="adopt_handoff"):
            make_engine(tparams, role="decode").submit(np.array([1, 2], np.int32),
                                                       max_new_tokens=4)
        return
    exc, match, kw = bad[case]
    with pytest.raises(exc, match=match):
        make_engine(tparams, **kw)


def test_router_validation(setup):
    """Mirrors test_role_validation (router half)."""
    tparams = setup[1]
    with pytest.raises(ValueError, match="prefill-capable"):
        DisaggRouter([make_engine(tparams, role="decode")], GatewayConfig(enabled=True),
                     roles=["decode"])
    with pytest.raises(ValueError, match="preempt"):
        make_disagg(tparams, preempt=True, max_retries=1)
    with pytest.raises(ValueError, match="replica_roles"):
        GatewayConfig(enabled=True, replica_roles="prefill,oracle")
    with pytest.raises(ValueError, match="declared role"):
        DisaggRouter([make_engine(tparams), make_engine(tparams, role="decode")],
                     GatewayConfig(enabled=True), roles=["prefill", "decode"])
    # A tracer is accepted (the telemetry slice) and reaches every replica engine.
    tracer = Tracer(sink=lambda record: None)
    engines = [make_engine(tparams, role="prefill"), make_engine(tparams, role="decode")]
    DisaggRouter(engines, GatewayConfig(enabled=True), roles=["prefill", "decode"],
                 tracer=tracer)
    assert all(e.tracer is tracer for e in engines)


# --------------------------------------------------------------------- parity
def test_disagg_parity_greedy_incl_chunked(setup):
    """Mirrors test_disagg_parity_greedy_incl_chunked: one handoff per request."""
    router, _, _, _ = three_way(setup)
    assert router.counters["handoffs"] == len(setup[2])
    pre, dec = (rep.engine.stats() for rep in router.replicas)
    assert pre["handoffs_exported"] == dec["handoffs_adopted"] == len(setup[2])
    assert pre["role"] == "prefill" and dec["role"] == "decode"
    assert dec["kv_adopt_count"] > 0 and pre["decode_steps"] == 0


def test_disagg_parity_sampled(setup):
    """Mirrors test_disagg_parity_sampled: the emission-indexed draws survive the
    handoff (emission 0 on the prefill replica, 1.. on the decode replica): the port's
    disagg tokens equal its mixed engine's, bitwise."""
    tparams, prompts = setup[1], setup[2]
    gens = [GenerationConfig(max_new_tokens=6, temperature=0.8, top_p=0.9) for _ in prompts]
    workload = [(p, dict(gen=g, seed=100 + i)) for i, (p, g) in enumerate(zip(prompts, gens))]
    refs = baseline(tparams, prompts, workload=workload)
    router = make_disagg(tparams)
    greqs = [router.submit(p, **k) for p, k in workload]
    drain(router)
    assert all(g.status == "done" for g in greqs)
    assert tokens_of(greqs) == [refs[p.tobytes()] for p in prompts]
    assert_pools_clean(router)


def test_disagg_parity_spec_decode(setup):
    """Mirrors test_disagg_parity_spec_decode: n-gram speculation (spec_k=2) on the
    decode replica; its spec counters equal JAX's decode replica's."""
    router, _, jrouter, _ = three_way(setup, engine_kw={"decode": {"spec_k": 2}})
    dec, jdec = router.replicas[1].engine, jrouter.replicas[1].engine
    assert dec.spec_proposed > 0
    assert (dec.spec_proposed, dec.spec_accepted) == (jdec.spec_proposed, jdec.spec_accepted)


@pytest.mark.parametrize("kw", [dict(decode_steps=4), dict(decode_steps=4, spec_k=2)],
                         ids=["multistep", "fused_spec"])
def test_disagg_parity_decode_super_step(setup, kw):
    """The decode replica's super-step (``decode_steps=4``; with ``spec_k=2`` the fused
    speculative super-step) over adopted lanes: the static inputs read each adopted
    lane's table, position and pending token before every replay."""
    router, _, _, _ = three_way(setup, max_new=9, engine_kw={"decode": kw})
    assert router.replicas[1].engine.decode_steps > 0


def test_disagg_spec_model_drafter(setup):
    """Mirrors test_disagg_spec_model_drafter: a ModelDrafter (over the target's own
    params) on the decode replica; adoption mirrors the lane's left-padded layout onto
    the draft cache with one synthesized bucket plan, so the perfect drafter accepts
    every proposal."""
    tparams, prompts = setup[1], setup[2]
    refs = baseline(tparams, prompts, 6)
    router = make_disagg(tparams, engine_kw={"decode": {"spec_k": 2,
                                                        "drafter": ModelDrafter(tparams, TCFG)}})
    greqs = [router.submit(p, max_new_tokens=6) for p in prompts]
    drain(router)
    assert tokens_of(greqs) == [refs[p.tobytes()] for p in prompts]
    dec = router.replicas[1].engine
    assert dec.spec_proposed > 0 and dec.spec_accepted == dec.spec_proposed
    assert_pools_clean(router)


def test_disagg_mixed_replica_hybrid(setup):
    """Mirrors test_disagg_mixed_replica_hybrid: a mixed replica serves both phases."""
    three_way(setup, roles=("prefill", "decode", "mixed"))


def test_disagg_prefix_cache_prefill_replica(setup):
    """A prefill replica with ``prefix_cache`` exports the right-aligned layout
    (valid range [0, len), decode from len): the decode replica's tokens equal a
    mixed prefix-cached engine's, and the registry's pages stay on the source pool."""
    tparams, prompts = setup[1], setup[2]
    shared = np.concatenate([prompts[3][:16], prompts[0]])
    workload = [prompts[3], shared, prompts[1]]
    refs = baseline(tparams, workload, 6, prefix_cache=4)
    router = make_disagg(tparams, engine_kw={"prefill": {"prefix_cache": 4}})
    greqs = [router.submit(p, max_new_tokens=6) for p in workload]
    drain(router)
    assert tokens_of(greqs) == [refs[p.tobytes()] for p in workload]
    pre = router.replicas[0].engine
    assert pre.prefix_hits >= 1
    while pre._evict_prefix_lru():
        pass
    assert_pools_clean(router)


def test_disagg_int8_kv_pools(setup):
    """int8 KV pools on both replicas: the block carries the scale planes, and the
    decode replica's tokens equal a mixed int8-pool engine's."""
    tparams, prompts = setup[1], setup[2]
    cfg = dataclasses.replace(TCFG, kv_quant=True)
    mixed = ContinuousBatcher(tparams, cfg, **ENGINE)
    mreqs = [mixed.submit(p, max_new_tokens=6) for p in prompts]
    mixed.run()
    engines = [ContinuousBatcher(tparams, cfg, role=r, **ENGINE) for r in ("prefill", "decode")]
    router = DisaggRouter(engines, GatewayConfig(enabled=True), roles=["prefill", "decode"])
    greqs = [router.submit(p, max_new_tokens=6) for p in prompts]
    drain(router)
    assert tokens_of(greqs) == [[int(t) for t in r.tokens] for r in mreqs]
    assert set(engines[0].cache["layers"][0]) == {"k", "v", "k_scale", "v_scale"}
    assert_pools_clean(router)


# ------------------------------------------------------------------ the handoff itself
def test_adopted_lane_equals_mixed_lane(setup):
    """Module-level: a handoff exported from a prefill engine and adopted by a decode
    engine lands the same K/V (every plane), the same valid row, position and pending
    token as the mixed engine's lane after admission; the next decode step's logits
    (kernel #1's plain version over the adopted and COW pages) agree within 1e-5, and
    the boundary page is an owned copy."""
    tparams, prompts = setup[1], setup[2]
    prompt = prompts[3]  # 21 tokens → 2 chunks of 16: prefill_len 32, pages of 8
    mixed = make_engine(tparams, page_size=6)
    pre = make_engine(tparams, role="prefill", page_size=6)
    dec = make_engine(tparams, role="decode", page_size=6)
    for eng in (mixed, pre):
        eng.submit(prompt, max_new_tokens=4)
    mixed._admit()
    pre.step()
    (h,) = pre.take_handoffs()
    assert isinstance(h, KVHandoff) and h.prefill_len == 32 and h.valid_range == (11, 32)
    assert len(h.pages) == 6 and pre.block_mgr.pages_in_use == 6  # pages_for(32, 6)
    block = pre.export_page_block(h)
    assert tree_bytes(block) == 6 * dec.kv_page_bytes
    req = dec.adopt_handoff(h, block)
    assert req.tokens == mixed.slot_req[0].tokens
    assert dec.positions[0] == mixed.positions[0] == 32
    assert dec.tokens[0] == mixed.tokens[0]
    assert torch.equal(dec.cache["valid"][0], mixed.cache["valid"][0])
    lane_d, lane_m = dec.block_mgr.lane_pages(0), mixed.block_mgr.lane_pages(0)
    assert len(lane_d) == len(lane_m)
    for planes_d, planes_m in zip(dec.cache["layers"], mixed.cache["layers"]):
        for key in planes_m:
            got = planes_d[key][torch.as_tensor(lane_d[:6], dtype=torch.long)]
            want = planes_m[key][torch.as_tensor(lane_m[:6], dtype=torch.long)]
            assert torch.equal(got[:5], want[:5])  # the full context pages
            assert torch.equal(got[5, :2], want[5, :2])  # the COW page's context slots
    ms = dec.block_mgr.stats()
    assert ms["cow_count"] == 1 and ms["adopt_count"] == 5
    assert dec.block_mgr.refcount[lane_d].tolist() == [1] * len(lane_d)
    mixed.step()
    dec.step()
    assert torch.allclose(dec.last_logits[0], mixed.last_logits[0], atol=1e-5, rtol=0)
    pre.release_handoff(h)
    assert pre.block_mgr.pages_in_use == 0


def test_adoption_defers_and_counts(setup):
    """``adopt_handoff`` defers (None, ``kv_defer_count`` +1, nothing consumed) when the
    pool cannot hold the import peak, and ``can_adopt_handoff`` says so first."""
    tparams, prompts = setup[1], setup[2]
    pre = make_engine(tparams, role="prefill")
    dec = make_engine(tparams, role="decode", kv_pages=6)
    for p in (prompts[3], prompts[1]):  # 32 and 16 context slots, 6 new tokens each
        pre.submit(p, max_new_tokens=6)
    pre.step()
    first, second = pre.take_handoffs()
    assert dec.can_adopt_handoff(first)
    assert dec.adopt_handoff(first, pre.export_page_block(first)) is not None
    assert dec.block_mgr.pages_in_use == 5  # 4 adopted context pages + 1 own
    assert not dec.can_adopt_handoff(second)  # 2 imported + 2 own > 1 free
    assert dec.adopt_handoff(second, pre.export_page_block(second)) is None
    assert dec.block_mgr.stats()["defer_count"] == 1 and dec.block_mgr.pages_in_use == 5
    assert not pre.can_adopt_handoff(second)
    with pytest.raises(RuntimeError, match="prefill-role"):
        pre.adopt_handoff(second, pre.export_page_block(second))
    for h in (first, second):
        pre.release_handoff(h)
    assert pre.block_mgr.pages_in_use == 0


def test_kv_page_transfer_same_device(setup):
    """The same-device transfer is a no-op move: the block comes back as it was, 0.0 s,
    its bytes and one valid ``serving.handoff/v1`` record accounted."""

    class Sink:
        enabled = True

        def __init__(self):
            self.records = []

        def emit(self, record):
            self.records.append(record)

    block = [{"k": torch.ones(2, 8, 1, 4), "v": torch.zeros(2, 8, 1, 4)}]
    stats, sink = TransferStats(), Sink()
    out, nbytes, dur = kv_page_transfer(block, src_replica=0, dst_replica=1, uid=7, pages=2,
                                        device="cpu", stats=stats, telemetry=sink)
    assert out is block and nbytes == 2 * 2 * 8 * 4 * 4 and dur == 0.0
    assert stats.summary() == {"transfers": 1, "transfer_bytes": nbytes, "transfer_s": 0.0}
    assert [validate_record(r) for r in sink.records] == [[]]


# ------------------------------------------------------------------ admission
def test_kv_demand_role_pricing(setup):
    """Mirrors test_kv_demand_role_pricing: 16/24/32, as JAX's engines price it."""
    jparams, tparams, _ = setup
    for mk, params in ((make_engine, tparams), (make_jax_engine, jparams)):
        assert mk(params, role="prefill").kv_demand(5, 8) == 16
        assert mk(params).kv_demand(5, 8) == 24
        assert mk(params, role="decode").kv_demand(5, 8) == 32


def test_prompt_only_prefill_pool_not_rejected(setup):
    """Mirrors test_prompt_only_prefill_pool_not_rejected: a prefill pool with room for
    context pages only (4 pages) serves a 21-token prompt a mixed engine of that pool
    refuses."""
    tparams = setup[1]
    with pytest.raises(Exception):
        make_engine(tparams, kv_pages=4).kv_demand(21, 6)
    three_way(setup, prompts=setup[2][:4], engine_kw={"prefill": {"kv_pages": 4}})


def test_adoption_defers_on_decode_pool_pressure(setup):
    """Mirrors test_adoption_defers_on_decode_pool_pressure: a decode pool with room
    for about one adoption holds the handoff queue (counted defers, equal to JAX's)."""
    prompts = [p[:5] for p in setup[2]]
    router, _, _, _ = three_way(setup, prompts=prompts, engine_kw={"decode": {"kv_pages": 4}})
    assert router.counters["handoff_defers"] > 0


# ------------------------------------------------------------------- failover
def _stream_capture():
    streams = {}

    def cbs(i):
        streams[i] = []

        def on_token(tok, i=i):
            streams[i].append(int(tok))

        def on_retry(i=i):
            streams[i].clear()

        return on_token, on_retry

    return streams, cbs


def _kill_run(setup, roles, kill, steps_before, max_new=8):
    """Serve every prompt with streams through the port's router and JAX's, kill
    replica ``kill`` after ``steps_before`` steps → (port router, requests, streams,
    the prefill replica's ``admitted`` at the kill), with tokens and streams equal to
    the mixed engine's and counters equal to JAX's."""
    jparams, tparams, prompts = setup
    refs = baseline(tparams, prompts, max_new)
    runs = []
    for jax_side, params in ((False, tparams), (True, jparams)):
        streams, cbs = _stream_capture()
        router = make_disagg(params, roles, factory=True, jax_side=jax_side,
                             replica_restarts=2)
        greqs = []
        for i, p in enumerate(prompts):
            ot, orr = cbs(i)
            greqs.append(router.submit(p, max_new_tokens=max_new, on_token=ot, on_retry=orr))
        for _ in range(steps_before):
            router.step()
        admitted = router.replicas[0].engine.admitted
        router.kill(kill)
        drain(router)
        for i, g in enumerate(greqs):
            assert g.status == "done", (g.uid, g.status, g.reason)
            assert streams[i] == refs[g.prompt.tobytes()]
            assert g.retries_used == 0
        assert_pools_clean(router)
        runs.append((router, greqs, streams, admitted))
    (router, greqs, streams, admitted), (jrouter, jgreqs, _, _) = runs
    assert tokens_of(greqs) == tokens_of(jgreqs)
    assert ({k: router.counters[k] for k in ROUTER_COUNTERS}
            == {k: jrouter.counters[k] for k in ROUTER_COUNTERS})
    return router, greqs, streams, admitted


def test_decode_replica_death_readopts_byte_identical(setup):
    """Mirrors test_decode_replica_death_readopts_byte_identical: the dead decode
    replica's requests adopt again from the source pages the handoff records still
    hold; the prefill replica admits nothing more."""
    router, _, _, admitted = _kill_run(setup, ("prefill", "decode", "decode"), 1, 3)
    assert router.counters["readopted"] > 0
    assert router.replicas[0].engine.admitted == admitted


def test_prefill_replica_death_reprefills_zero_loss(setup):
    """Mirrors test_prefill_replica_death_reprefills_zero_loss: exported records die
    with the prefill replica's pool; their requests prefill again on the restarted
    replica."""
    router, _, _, _ = _kill_run(setup, ("prefill", "decode"), 0, 1)
    assert router.counters["replica_restarts"] >= 1


def test_cancel_in_handoff_limbo(setup):
    """Mirrors test_cancel_in_handoff_limbo: a request cancelled between export and
    adoption releases its record (source pages free) with the streamed first token."""
    tparams, prompts = setup[1], setup[2]
    router = make_disagg(tparams)
    greqs = [router.submit(p, max_new_tokens=8) for p in prompts[:5]]
    router.step()
    router.step()
    limbo = [g for g in greqs if g.status == "running" and g._rid is None
             and g.uid in router._live_handoffs]
    assert limbo, "no request in handoff limbo — geometry drifted"
    victim = limbo[0]
    assert router.cancel(victim.uid)
    assert victim.status == "cancelled" and victim.reason == "cancelled_handoff"
    assert len(victim.tokens) == 1
    drain(router)
    assert_pools_clean(router)


# ------------------------------------------------------------------ surface
def test_warm_surface_by_role(setup):
    """Mirrors test_decode_only_warm_surface: a decode engine's graph surface holds no
    prefill program, a prefill engine's no decode, super-step or verify graph."""
    tparams = setup[1]
    dec = make_engine(tparams, role="decode", decode_steps=4, spec_k=2)
    keys = dec._program_surface(16)
    assert keys and all(isinstance(k[0], int) or k[0] == "spec" for k in keys), keys
    assert [e["name"] for e in dec.warm_programs(16)] == [
        "serving.decode_multi_paged", "serving.decode_multi_paged",
        "serving.spec_multi_paged", "serving.spec_multi_paged"]
    pre = make_engine(tparams, role="prefill", prompt_buckets=(16, 32))
    names = {e["name"] for e in pre.warm_programs(16)}
    assert names == {"serving.prefill", "serving.prefill_chunk"}
    assert dec._row is None  # a decode engine holds no prefill row cache


def test_handoff_records_and_transfer_accounting(setup):
    """Mirrors the record half of test_handoff_records_span_and_trace_report: one valid
    ``serving.handoff/v1`` record per handoff (src 0, dst 1, bytes > 0), routing
    records for dispatch and handoff, and ``transfer_stats`` equal to the records."""

    class Sink:
        enabled = True

        def __init__(self):
            self.records = []

        def emit(self, record):
            self.records.append(record)

    tparams, prompts = setup[1], setup[2]
    tel = Sink()
    router = make_disagg(tparams, telemetry=tel)
    greqs = [router.submit(p, max_new_tokens=6) for p in prompts]
    drain(router)
    assert all(g.status == "done" for g in greqs)
    handoffs = [r for r in tel.records if r["schema"] == SERVING_HANDOFF_SCHEMA]
    assert len(handoffs) == router.counters["handoffs"] > 0
    assert all(validate_record(r) == [] for r in tel.records)
    assert all(r["src_replica"] == 0 and r["dst_replica"] == 1 and r["nbytes"] > 0
               for r in handoffs)
    routes = {r["reason"] for r in tel.records if r["schema"] == FLEET_ROUTE_SCHEMA}
    assert {"dispatch", "handoff"} <= routes
    assert router.transfer_stats.count == len(handoffs)
    assert router.transfer_stats.bytes == sum(r["nbytes"] for r in handoffs)
    page_bytes = router.replicas[0].engine.kv_page_bytes
    assert all(r["nbytes"] == r["pages"] * page_bytes for r in handoffs)


def test_accelerator_builder_roles(setup):
    """Mirrors test_accelerator_builder_roles: ``replica_roles`` → DisaggRouter, a list
    without roles → FleetRouter."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.serving_gateway import ServingGateway
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    tparams, prompts = setup[1], setup[2]
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    try:
        acc = Accelerator(device="cpu", gateway_config=GatewayConfig(
            enabled=True, replica_roles="prefill,decode"))
        router = acc.build_serving_gateway([make_engine(tparams, role="prefill"),
                                            make_engine(tparams, role="decode")])
        assert isinstance(router, DisaggRouter)
        g = router.submit(prompts[0], max_new_tokens=4)
        drain(router)
        assert g.status == "done"
        acc.gateway_config = GatewayConfig(enabled=True)
        fleet = acc.build_serving_gateway([make_engine(tparams), make_engine(tparams)])
        assert isinstance(fleet, FleetRouter) and not isinstance(fleet, DisaggRouter)
        assert isinstance(acc.build_serving_gateway(make_engine(tparams)), ServingGateway)
        acc.gateway_config = GatewayConfig(enabled=False)
        eng = make_engine(tparams)
        assert acc.build_serving_gateway(eng) is eng
        with pytest.raises(ValueError, match="gateway enabled"):
            acc.build_serving_gateway([eng])
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()


# ------------------------------------------------------ faults and tracing (slice 15)
def _crash_plans(jax_side):
    mod = jfaults if jax_side else tfaults
    return [mod.FaultPlan([mod.FaultSpec("serving.prefill", "crash", prob=0.2, max_fires=1)],
                          seed=11),
            mod.FaultPlan([mod.FaultSpec("serving.decode", "crash", prob=0.15, max_fires=1)],
                          seed=12),
            None]


def test_injected_crash_faults_failover(setup):
    """Mirrors test_injected_crash_faults_failover: seeded ``crash`` clauses at
    serving.prefill and serving.decode kill replicas mid-trace (``EngineCrashed`` out
    of ``step()`` is the router's failover signal); every request ends done with the
    undisturbed stream, and the plans fire where JAX's do with the same counters."""
    jparams, tparams, prompts = setup
    refs = baseline(tparams, prompts, max_new=8)
    out = []
    for jax_side, params in ((False, tparams), (True, jparams)):
        plans = _crash_plans(jax_side)
        streams = {i: [] for i in range(len(prompts))}
        router = make_disagg(params, ("prefill", "decode", "decode"), factory=True,
                             jax_side=jax_side, plans=plans, replica_restarts=3)
        greqs = [router.submit(p, max_new_tokens=8,
                               on_token=lambda t, i=i: streams[i].append(int(t)),
                               on_retry=lambda i=i: streams[i].clear())
                 for i, p in enumerate(prompts)]
        drain(router)
        assert all(g.status == "done" for g in greqs), [(g.status, g.reason) for g in greqs]
        assert [streams[i] for i in range(len(prompts))] == [refs[p.tobytes()]
                                                              for p in prompts]
        out.append(([p.fired for p in plans if p is not None],
                    {k: router.counters[k] for k in ROUTER_COUNTERS}))
    assert out[0] == out[1]
    assert sum(len(f) for f in out[0][0]) >= 1 and out[0][1]["replica_kills"] >= 1


def test_handoff_records_span_and_trace_report(setup):
    """Mirrors test_handoff_records_span_and_trace_report: one ``handoff`` span per
    handoff record, ``trace_report``'s handoff breakdown and per-role stall split; the
    port's report over its spans equals the JAX package's."""
    from accelerate_tpu.commands.trace_report import trace_report as jax_trace_report
    from accelerate_tpu_torch.commands.trace_report import trace_report
    from accelerate_tpu_torch.telemetry import TRACE_SPAN_SCHEMA, Telemetry
    from accelerate_tpu_torch.utils.dataclasses import TelemetryConfig

    tparams, prompts = setup[1], setup[2]
    tel = Telemetry(TelemetryConfig(enabled=True, compile_events=False, memory_stats=False))
    router = make_disagg(tparams, telemetry=tel, tracer=Tracer(tel))
    greqs = [router.submit(p, max_new_tokens=6) for p in prompts]
    drain(router)
    assert all(g.status == "done" for g in greqs)
    handoffs = [r for r in tel.records if r.get("schema") == SERVING_HANDOFF_SCHEMA]
    assert len(handoffs) == router.counters["handoffs"] > 0
    assert all(validate_record(r) == [] for r in tel.records)
    spans = [r for r in tel.records if r.get("schema") == TRACE_SPAN_SCHEMA]
    hspans = [s for s in spans if s["span"] == "handoff"]
    assert len(hspans) == len(handoffs)
    assert [(s["src_replica"], s["dst_replica"], s["pages"], s["nbytes"]) for s in hspans] \
        == [(r["src_replica"], r["dst_replica"], r["pages"], r["nbytes"]) for r in handoffs]
    report = trace_report(spans)
    assert report == jax_trace_report(spans)
    assert "handoff_s" in report["breakdown"] and "handoff_s" in report["critical_path_share"]
    assert report["stall_by_role"]["n_requests"] == len(prompts)
    for t in report["traces"]:
        assert t["handoffs"] == 1
        assert t["stall_prefill_s"] is not None and t["stall_decode_s"] is not None


def test_adopt_fault_finalizes_failed(setup, monkeypatch):
    """An exception out of ``adopt_handoff`` other than ``EngineCrashed`` ends the
    request FAILED with ``adopt_fault:<kind>`` (the record released), as in JAX; the
    others finish with their streams."""
    jparams, tparams, prompts = setup
    out = []
    for jax_side, params in ((False, tparams), (True, jparams)):
        router = make_disagg(params, jax_side=jax_side)
        decode = router.replicas[1].engine
        real = decode.adopt_handoff

        def flaky(h, block, *a, real=real, **k):
            if h.uid == 2:
                raise RuntimeError("page import failed")
            return real(h, block, *a, **k)

        monkeypatch.setattr(decode, "adopt_handoff", flaky)
        greqs = [router.submit(p, max_new_tokens=6) for p in prompts]
        drain(router)
        assert_pools_clean(router)
        out.append(([(g.status, g.reason, [int(t) for t in g.tokens]) for g in greqs],
                    router.counters["failed"]))
    assert out[0] == out[1]
    statuses, failed = out[0]
    assert failed == 1 and statuses[2][:2] == ("failed", "adopt_fault:RuntimeError")


def test_decode_engine_recovery_reprefills(setup, monkeypatch):
    """A decode-role engine with recovery armed holds a prefill row cache: a hang past
    its watchdog rebuilds its lanes and re-admits the survivors through prefill
    (prompt + emitted tokens), as JAX's decode engine does; streams equal the mixed
    engine's and JAX's, every pool drains."""
    import time

    jparams, tparams, prompts = setup
    refs = baseline(tparams, prompts)
    clock = {"t": 0.0}

    def advance(dt):
        clock["t"] += dt

    monkeypatch.setattr(time, "sleep", advance)
    assert make_engine(tparams, role="decode")._row is None  # unarmed: no row cache
    out = []
    for jax_side, params in ((False, tparams), (True, jparams)):
        mod = jfaults if jax_side else tfaults
        plan = mod.FaultPlan([mod.FaultSpec("serving.decode", "hang", prob=1.0, start=2,
                                            max_fires=1, attributed=False, hang_s=0.4)])
        router = make_disagg(params, jax_side=jax_side, plans=[None, plan],
                             engine_kw={"decode": {"step_timeout_s": 0.25}})
        decode = router.replicas[1].engine
        decode._watchdog._clock = lambda: clock["t"]
        if not jax_side:
            assert decode._row is not None
        greqs = [router.submit(p, max_new_tokens=6) for p in prompts]
        drain(router)
        assert_pools_clean(router)
        assert all(g.status == "done" for g in greqs)
        assert decode.recovered_admissions > 0
        out.append((tokens_of(greqs), plan.fired,
                    {k: decode.stats()[k] for k in ("step_failures", "recovered_admissions",
                                                    "bisect_rounds", "quarantined")}))
    assert out[0] == out[1]
    assert out[0][0] == [refs[p.tobytes()] for p in prompts]
