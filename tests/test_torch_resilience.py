"""The port's fault boundary against the JAX package's, on the CPU at fp32.

Mirrors tests/test_resilience.py (the fault plan, the engine's quarantine, bisection,
watchdog and rebuild, the gateway's FAILED terminals, breaker and degradation rungs,
restart replay, deadline eviction of parked requests, the train step's non-finite
guard and its ``train.step`` draws). Fixtures follow that file: the ``tiny`` config at
fp32, the JAX ``init_params`` weights converted for the port
(``models/convert.params_from_jax``), prompts of 5/9/3/7/6/4 tokens from
``default_rng(0)``, engines of ``max_slots=3, max_len=64, prompt_bucket=16``.

Each engine scenario runs the same seeded ``FaultPlan`` through the JAX engine and the
port's and holds them equal: the fired ``(site, kind, uid, invocation)`` list, the
quarantined uids and their reasons, every request's greedy tokens and the fault
boundary's counters. Sampled survivors are held to the port's own undisturbed run
(the port draws from torch generators, JAX from keys: ROADMAP §C).

Hang faults sleep 0.4 s against a 0.25 s watchdog on a virtual clock: the
engines' watchdogs read it, and ``time.sleep`` advances it instead of sleeping, so only
the injected hang can trip a watchdog, however loaded the host, and no test waits.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.resilience import faults as jf
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu import serving_gateway as jgw
from accelerate_tpu.telemetry import Telemetry as JaxTelemetry
from accelerate_tpu.utils.dataclasses import GatewayConfig as JaxGatewayConfig
from accelerate_tpu.utils.dataclasses import TelemetryConfig as JaxTelemetryConfig
from accelerate_tpu_torch import serving_gateway as tgw
from accelerate_tpu_torch.generation import GenerationConfig
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.resilience import faults as tf
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.telemetry import (FAULT_SCHEMA, GATEWAY_REQUEST_SCHEMA,
                                            RECOVERY_SCHEMA, SCHEMA_REGISTRY, Telemetry,
                                            Tracer, validate_record)
from accelerate_tpu_torch.utils.dataclasses import FaultConfig, GatewayConfig, TelemetryConfig

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
ENGINE = dict(max_slots=3, max_len=64, prompt_bucket=16)
HANG = dict(hang_s=0.4)
BUDGET = 0.25
COUNTERS = ("step_failures", "quarantined", "recovered_admissions", "bisect_rounds",
            "watchdog_timeouts", "admitted", "evicted")


@pytest.fixture(scope="module", autouse=True)
def _no_jax_persistent_cache():
    """Compile the JAX references afresh (tokens are compared exactly)."""
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


SIDES = {"port": (ContinuousBatcher, TCFG, 1, tf), "jax": (JaxBatcher, JCFG, 0, jf)}


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_plan(side, specs, seed=0):
    mod = SIDES[side][3]
    return mod.FaultPlan([mod.FaultSpec(**kw) for kw in specs], seed=seed)


VCLOCK = ManualClock()


@pytest.fixture(autouse=True)
def _virtual_sleep(monkeypatch):
    """``time.sleep`` (an injected hang) advances the watchdogs' virtual clock."""
    monkeypatch.setattr(time, "sleep", VCLOCK.advance)


def make_engine(setup, side, **kw):
    batcher, cfg, pi, _ = SIDES[side]
    eng = batcher(setup[pi], cfg, **{**ENGINE, **kw})
    if eng._watchdog is not None:
        eng._watchdog._clock = VCLOCK
    return eng


def run_engine(setup, side, specs=None, prompts=None, n_new=8, **kw):
    """One engine drained on ``prompts`` (default all) under the plan ``specs`` →
    (requests, engine, plan)."""
    plan = make_plan(side, specs) if specs else None
    eng = make_engine(setup, side, faults=plan, **kw)
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in (prompts or setup[2])]
    done = eng.run()
    assert len(done) == len(reqs)  # failed requests are returned too
    return reqs, eng, plan


def both(setup, specs=None, **kw):
    """:func:`run_engine` on the port's engine and JAX's → the two outcomes, each
    ``(tokens, failed reasons, counters, fired)``."""
    out = {}
    for side in SIDES:
        reqs, eng, plan = run_engine(setup, side, specs, **kw)
        stats = eng.stats()
        out[side] = ([[int(t) for t in r.tokens] for r in reqs], [r.failed for r in reqs],
                     {k: stats[k] for k in COUNTERS}, plan.fired if plan else None)
    return out["port"], out["jax"]


def clean_tokens(setup, prompts=None, n_new=8, **kw):
    reqs, _, _ = run_engine(setup, "port", None, prompts, n_new, **kw)
    return [[int(t) for t in r.tokens] for r in reqs]


# ------------------------------------------------------------------ fault plan
def test_fault_plan_deterministic_by_seed():
    """The same (seed, site invocation) fires the same pattern as JAX's plan, whatever
    other sites interleave."""
    def pattern(mod, seed, interleave):
        plan = mod.FaultPlan([mod.FaultSpec("serving.decode", "error", prob=0.3)], seed=seed)
        out = []
        for _ in range(40):
            if interleave:
                plan.draw("serving.prefill")
            out.append(plan.draw("serving.decode") is not None)
        return out

    assert pattern(tf, 7, False) == pattern(tf, 7, True) == pattern(jf, 7, False)
    assert pattern(tf, 7, False) != pattern(tf, 8, False)
    # Scoped streams (seed, crc32(scope), i) as well.
    plans = [mod.FaultPlan.from_spec("seed=3; train.step:crash:0.2", scope="gang1")
             for mod in (tf, jf)]
    for _ in range(30):
        for p in plans:
            p.draw("train.step")
    assert plans[0].fired == plans[1].fired and plans[0].fired


def test_fault_plan_window_budget_and_match():
    for mod in (tf, jf):
        plan = mod.FaultPlan([mod.FaultSpec("s", "error", prob=1.0, start=2, stop=4),
                              mod.FaultSpec("s", "hang", prob=1.0, start=10, max_fires=1)])
        kinds = [None if s is None else s.kind for s in (plan.draw("s") for _ in range(12))]
        assert kinds[:6] == [None, None, "error", "error", None, None]
        assert kinds[10] == "hang" and kinds[11] is None
        plan = mod.FaultPlan([mod.FaultSpec("s", "error", match_uid=5)])
        assert plan.draw("s", uids=[1, 2]) is None
        assert plan.draw("s", uids=[1, 5]) is not None
        assert plan.fired[0]["uid"] == 5
        assert plan.stats()["by_site"] == {"s": 1}


def test_fault_spec_parse_roundtrip():
    text = ("seed=7; serving.decode:error:0.1,max=3,uid=5 ;"
            "ckpt.save:crash,start=2; serving.decode:hang,hang_s=0.5,attributed=false")
    (specs, seed), (jspecs, jseed) = tf.parse_fault_spec(text), jf.parse_fault_spec(text)
    assert seed == jseed == 7
    assert [dataclasses.asdict(s) for s in specs] == [dataclasses.asdict(s) for s in jspecs]
    assert specs[0].prob == 0.1 and specs[0].max_fires == 3 and specs[0].match_uid == 5
    assert specs[2].hang_s == 0.5 and specs[2].attributed is False
    with pytest.raises(ValueError, match="unknown key"):
        tf.parse_fault_spec("s:error,bogus=1")
    with pytest.raises(ValueError, match="kind"):
        tf.parse_fault_spec("s:explode")


def test_fault_config_env(monkeypatch):
    monkeypatch.delenv("ACCELERATE_FAULTS", raising=False)
    assert FaultConfig().enabled is False and FaultConfig().build_plan() is None
    monkeypatch.setenv("ACCELERATE_FAULTS", "serving.decode:error:0.5")
    fc = FaultConfig()
    assert fc.enabled and fc.spec == "serving.decode:error:0.5"
    plan = fc.build_plan()
    assert isinstance(plan, tf.FaultPlan) and plan.specs[0].prob == 0.5
    monkeypatch.setenv("ACCELERATE_FAULTS", "0")
    assert FaultConfig().enabled is False
    monkeypatch.setenv("ACCELERATE_FAULTS", "1")
    with pytest.raises(ValueError, match="no fault clauses"):
        FaultConfig()


def test_watchdog():
    clock = ManualClock()
    wd = tf.StepWatchdog(0.5, clock=clock)
    t0 = wd.open()
    clock.advance(0.4)
    wd.check(t0)
    t0 = wd.open()
    clock.advance(0.6)
    with pytest.raises(tf.StepTimeout):
        wd.check(t0)
    assert wd.timeouts == 1
    with pytest.raises(ValueError):
        tf.StepWatchdog(0)


def test_new_schemas_registered():
    assert FAULT_SCHEMA in SCHEMA_REGISTRY and RECOVERY_SCHEMA in SCHEMA_REGISTRY
    assert validate_record({"schema": FAULT_SCHEMA, "site": "serving.decode",
                            "kind": "error"}) == []
    assert validate_record({"schema": RECOVERY_SCHEMA, "action": "rebuild"}) == []
    assert validate_record({"schema": FAULT_SCHEMA}) != []


# ------------------------------------------------------- engine crash recovery
POISON = [dict(site="serving.decode", kind="error", prob=1.0, match_uid=1, max_fires=1)]
BISECT = [dict(site="serving.decode", kind="error", prob=1.0, match_uid=2, attributed=False)]
HANG_ONCE = [dict(site="serving.decode", kind="hang", prob=1.0, max_fires=1,
                  attributed=False, **HANG)]


@pytest.mark.parametrize("case", [
    "poison", "bisect", "hang", "poison_paged_multistep", "bisect_paged_multistep",
    "hang_paged", "bisect_spec", "hang_spec_fused"])
def test_decode_faults_match_jax(setup, case):
    """Mirrors test_poison_quarantine_preserves_survivors_bitwise,
    test_unattributed_fault_bisects_to_the_poison and
    test_watchdog_converts_hang_into_recovery, on the dense N = 1 engine and on the
    paged super-step and speculative engines: the same quarantined request and reason,
    every survivor's tokens bitwise the undisturbed run's and JAX's, equal counters."""
    specs, kw = {
        "poison": (POISON, {}),
        "bisect": (BISECT, {}),
        "hang": (HANG_ONCE, {"step_timeout_s": BUDGET}),
        "poison_paged_multistep": (POISON, {"page_size": 8, "decode_steps": 4}),
        "bisect_paged_multistep": (BISECT, {"page_size": 8, "decode_steps": 4}),
        "hang_paged": (HANG_ONCE, {"page_size": 8, "step_timeout_s": BUDGET}),
        "bisect_spec": (BISECT, {"spec_k": 2}),
        "hang_spec_fused": (HANG_ONCE, {"spec_k": 2, "decode_steps": 4, "page_size": 8,
                                        "step_timeout_s": BUDGET}),
    }[case]
    clean = clean_tokens(setup, **{k: v for k, v in kw.items() if k != "step_timeout_s"})
    port, ref = both(setup, specs, **kw)
    assert port == ref
    tokens, failed, counters, fired = port
    victim = {"poison": 1, "bisect": 2}.get(case.split("_")[0])
    for i, toks in enumerate(tokens):
        if i == victim:
            assert failed[i] == "step_fault:error"
        else:
            assert failed[i] is None and toks == clean[i], i
    if victim is None:
        assert counters["watchdog_timeouts"] == 1 and counters["quarantined"] == 0
        assert counters["recovered_admissions"] > 0
    if case.startswith("bisect"):
        assert counters["bisect_rounds"] >= 1


def test_prefill_fault_quarantines_admitting_request(setup):
    specs = [dict(site="serving.prefill", kind="error", prob=1.0, max_fires=1, start=2)]
    port, ref = both(setup, specs)
    assert port == ref
    tokens, failed, _, fired = port
    assert [f for f in failed if f] == ["prefill_fault:error"]
    clean = clean_tokens(setup)
    for i, f in enumerate(failed):
        assert tokens[i] == ([] if f else clean[i])  # failed AT admission: nothing streamed


def test_paged_kv_admit_fault_releases_cleanly(setup):
    specs = [dict(site="serving.kv_admit", kind="error", prob=1.0, max_fires=1, start=1)]
    port, ref = both(setup, specs, page_size=8)
    assert port == ref
    tokens, failed, _, _ = port
    assert sum(f is not None for f in failed) == 1
    clean = clean_tokens(setup, page_size=8)
    assert all(tokens[i] == clean[i] for i, f in enumerate(failed) if f is None)
    _, eng, _ = run_engine(setup, "port", specs, page_size=8)
    assert eng.block_mgr.stats()["pages_in_use"] == 0


def test_recovery_with_prefix_cache_engine(setup):
    """One transient unattributed fault on a prefix-cache engine convicts nobody; every
    request recovers through the right-aligned chunked re-prefill with the undisturbed
    tokens (the dense snapshots survive the rebuild)."""
    specs = [dict(site="serving.decode", kind="hang", prob=1.0, max_fires=1,
                  attributed=False, **HANG)]
    port, ref = both(setup, specs, prefix_cache=4, step_timeout_s=BUDGET)
    assert port == ref
    tokens, failed, counters, _ = port
    assert counters["step_failures"] == 1 and counters["quarantined"] == 0
    assert counters["recovered_admissions"] > 0
    assert failed == [None] * 6 and tokens == clean_tokens(setup, prefix_cache=4)


def test_paged_prefix_recovery_rebuild(setup):
    """A rebuild on a paged engine with registered prefixes drains the registry against
    the old manager first; survivors bitwise, no refcount underflow, the pool empty."""
    prompts = [np.tile(setup[2][1], 4)[:32].astype(np.int32)] + list(setup[2][:3])
    specs = [dict(site="serving.decode", kind="hang", prob=1.0, start=3, max_fires=1,
                  attributed=False, **HANG)]
    kw = dict(page_size=8, prefix_cache=4, prompts=prompts)
    port, ref = both(setup, specs, step_timeout_s=BUDGET, **kw)
    assert port == ref
    tokens, failed, counters, _ = port
    assert counters["step_failures"] == 1 and counters["recovered_admissions"] > 0
    assert failed == [None] * 4 and tokens == clean_tokens(setup, **kw)
    _, eng, _ = run_engine(setup, "port", specs, step_timeout_s=BUDGET, **kw)
    while eng._evict_prefix_lru():
        pass
    assert eng.block_mgr.stats()["pages_in_use"] == 0


def test_bisect_hold_released_when_no_lanes_active(setup):
    """With the probe half quarantined and the queue empty, the held suspect is
    released, not stranded."""
    specs = [dict(site="serving.decode", kind="error", prob=1.0, max_fires=2,
                  attributed=False)]
    kw = dict(prompts=setup[2][:2], n_new=6, max_slots=2)
    port, ref = both(setup, specs, **kw)
    assert port == ref
    tokens, failed, _, _ = port
    clean = clean_tokens(setup, **kw)
    survivors = [i for i, f in enumerate(failed) if f is None]
    assert survivors and all(tokens[i] == clean[i] for i in survivors)


@pytest.mark.parametrize("kw", [{}, {"decode_steps": 4, "page_size": 8},
                                {"spec_k": 2, "decode_steps": 4}])
def test_recovery_sampled_request_resumes_key_schedule(setup, kw):
    """A sampled survivor of a rebuild resumes at emission ``len(tokens)``: its tokens
    equal its own undisturbed run's (the super-step's noise drawn ahead is dropped for
    requeued lanes and drawn again from the record)."""
    gen = GenerationConfig(max_new_tokens=8, temperature=0.8, top_k=5)

    def run(faults=None, timeout=None):
        eng = make_engine(setup, "port", faults=faults, step_timeout_s=timeout, **kw)
        reqs = [eng.submit(p, gen=gen, seed=100 + i) for i, p in enumerate(setup[2][:4])]
        eng.run()
        return reqs

    clean = run()
    faulted = run(make_plan("port", POISON))
    assert faulted[1].failed is not None
    for i in (0, 2, 3):
        assert faulted[i].tokens == clean[i].tokens, i
    rebuilt = run(make_plan("port", HANG_ONCE), BUDGET)
    assert all(r.failed is None for r in rebuilt)
    assert [r.tokens for r in rebuilt] == [r.tokens for r in clean]
    assert any(r.recoveries for r in rebuilt)


def test_recovery_zero_extra_captures(setup):
    """Mirrors test_recovery_zero_extra_compiles: a recovery runs only programs in the
    engine's warm surface (so after ``warm_programs()`` the card captures none), a
    survivor whose context outgrew every bucket rides the warmed chunk pair, and the
    rebuild resets the cache IN PLACE: every plane keeps its ``data_ptr``."""
    kw = dict(page_size=8, decode_steps=4, prompt_buckets=(4, 8))
    prompts = [p for p in setup[2] if len(p) <= 8]  # every prompt fits a rung
    late_hang = [dict(HANG_ONCE[0], start=1)]
    eng = make_engine(setup, "port", faults=make_plan("port", late_hang),
                      step_timeout_s=BUDGET, **kw)
    surface = set(eng._program_surface(8))
    assert len(eng.warm_programs(8)) == len(surface)
    ptrs = [t.data_ptr() for planes in eng.cache["layers"] for t in planes.values()]
    ptrs += [eng.cache["valid"].data_ptr(), eng._row["valid"].data_ptr()]
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.run()
    assert eng.step_failures == 1 and eng.recovered_admissions > 0
    used = set(eng.graphs) | set(eng.prefill_graphs)
    assert used <= surface, used - surface
    assert ("prefill", 16) in used  # a recovered context past the top rung: chunks
    assert ptrs == ([t.data_ptr() for planes in eng.cache["layers"] for t in planes.values()]
                    + [eng.cache["valid"].data_ptr(), eng._row["valid"].data_ptr()])
    assert [r.tokens for r in reqs] == clean_tokens(setup, prompts, **kw)
    assert eng.stats()["rebuild_s"] > 0


def test_fault_and_recovery_telemetry_records(setup):
    """The fault and recovery records (site, kind, uid, action, step) equal JAX's, and
    every record the engine emits validates."""
    recs = {}
    for side, tel in (("port", Telemetry(TelemetryConfig(enabled=True, compile_events=False,
                                                             memory_stats=False))),
                      ("jax", JaxTelemetry(JaxTelemetryConfig(
                          enabled=True, compile_events=False, memory_stats=False)))):
        plan = make_plan(side, POISON + HANG_ONCE)
        eng = make_engine(setup, side, faults=plan, telemetry=tel, step_timeout_s=BUDGET,
                          page_size=8)
        for p in setup[2][:4]:
            eng.submit(p, max_new_tokens=6)
        eng.run()
        recs[side] = tel.records
    for r in recs["port"]:
        assert validate_record(r) == [], r

    def key(r):
        return (r["schema"], r.get("site"), r.get("kind"), r.get("action"), r.get("uid"),
                r.get("step"), r.get("survivors"), r.get("tokens_kept"))

    wanted = (FAULT_SCHEMA, RECOVERY_SCHEMA)
    port = [key(r) for r in recs["port"] if r["schema"] in wanted]
    ref = [key(r) for r in recs["jax"] if r["schema"] in wanted]
    assert port == ref
    assert any(k[3] == "quarantine" and k[4] == 1 for k in port)
    assert any(k[3] == "rebuild" for k in port) and any(k[3] == "readmit" for k in port)


def test_recovery_trace_shows_two_attempts(setup):
    """A recovered request's trace carries a second admit/prefill pair; the span kinds
    per request equal JAX's on the same manual clock."""
    kinds = {}
    for side, mod, cfg_cls, tracer_cls in (
            ("port", tgw, GatewayConfig, Tracer),
            ("jax", jgw, JaxGatewayConfig, _jax_tracer())):
        spans = []
        tracer = tracer_cls(sink=spans.append)
        clock = ManualClock()
        plan = make_plan(side, [dict(site="serving.decode", kind="hang", prob=1.0,
                                     max_fires=1, start=1, attributed=False, **HANG)])
        eng = make_engine(setup, side, max_slots=2, faults=plan, tracer=tracer,
                          step_timeout_s=BUDGET)
        gw = mod.ServingGateway(eng, cfg_cls(enabled=True), clock=clock, tracer=tracer)
        greqs = [gw.submit(p, max_new_tokens=6) for p in setup[2][:2]]
        while gw.queue_depth or gw.running_count:
            gw.step()
            clock.advance(1.0)
        assert all(g.terminal for g in greqs)
        recovered = [g for g in greqs if g.status == "done" and g.recoveries > 0]
        assert recovered
        mine = [s["span"] for s in spans if s["uid"] == recovered[0].uid]
        assert mine.count("prefill") >= 2 and mine[-1] == "terminal"
        kinds[side] = [(s["uid"], s["span"], s["t0"], s["t1"]) for s in spans]
    assert [(u, k) for u, k, _, _ in kinds["port"]] == [(u, k) for u, k, _, _ in kinds["jax"]]


def _jax_tracer():
    from accelerate_tpu.telemetry.tracing import Tracer as JaxTracer

    return JaxTracer


# --------------------------------------------------------------- gateway layer
def test_gateway_failed_terminal_status_and_record(setup):
    out = {}
    for side, mod, cfg_cls, tel in (
            ("port", tgw, GatewayConfig, Telemetry(TelemetryConfig(
                enabled=True, compile_events=False, memory_stats=False))),
            ("jax", jgw, JaxGatewayConfig, JaxTelemetry(JaxTelemetryConfig(
                enabled=True, compile_events=False, memory_stats=False)))):
        plan = make_plan(side, [dict(site="serving.decode", kind="error", prob=1.0,
                                     match_uid=0, max_fires=1)])
        gw = mod.ServingGateway(make_engine(setup, side, faults=plan), cfg_cls(enabled=True),
                                telemetry=tel)
        greqs = [gw.submit(p, max_new_tokens=6) for p in setup[2][:3]]
        gw.run()
        recs = [r for r in tel.records if r.get("schema") == GATEWAY_REQUEST_SCHEMA
                and r["status"] == "failed"]
        out[side] = ([(g.status, g.reason, [int(t) for t in g.tokens]) for g in greqs],
                     gw.counters["failed"], len(recs), gw.slo_summary()["by_status"]["failed"])
        if side == "port":
            assert validate_record(recs[0]) == []
    assert out["port"] == out["jax"]
    statuses = out["port"][0]
    assert [s for s in statuses if s[0] == "failed"][0][1] == "step_fault:error"
    assert out["port"][1:] == (1, 1, 1)


def _breaker_script(setup, side, specs, cfg_kw, script):
    mod, cfg_cls = (tgw, GatewayConfig) if side == "port" else (jgw, JaxGatewayConfig)
    clock = ManualClock()
    eng = make_engine(setup, side, max_slots=2, faults=make_plan(side, specs))
    gw = mod.ServingGateway(eng, cfg_cls(enabled=True, **cfg_kw), clock=clock)
    return script(gw, clock, setup[2])


def test_circuit_breaker_transitions_manual_clock(setup):
    """closed → open (circuit_open refusals) → half-open after the cooldown (one probe,
    others refused circuit_probe) → closed on the probe's success; equal to JAX's."""
    def script(gw, clock, prompts):
        greqs = [gw.submit(p, max_new_tokens=6) for p in prompts[:4]]
        for _ in range(40):
            gw.step()
            clock.advance(1.0)
            if gw._breaker_state == "open":
                break
        trace = [(gw._breaker_state, gw.breaker_openings)]
        trace.append(gw.submit(prompts[4], max_new_tokens=4).reason)
        clock.advance(10.0)
        probe = gw.submit(prompts[4], max_new_tokens=4)
        trace.append((probe.status, gw._breaker_state))
        trace.append(gw.submit(prompts[5], max_new_tokens=4).reason)
        while gw.queue_depth or gw.running_count:
            gw.step()
            clock.advance(1.0)
        trace.append((probe.status, gw._breaker_state, gw.breaker_closings))
        trace.append([(g.status, g.reason, [int(t) for t in g.tokens]) for g in greqs])
        return trace

    specs = [dict(site="serving.decode", kind="error", prob=1.0, max_fires=2,
                  attributed=False)]
    cfg = dict(breaker_threshold=2, breaker_window_s=100.0, breaker_cooldown_s=5.0)
    port = _breaker_script(setup, "port", specs, cfg, script)
    assert port == _breaker_script(setup, "jax", specs, cfg, script)
    assert port[0] == ("open", 1) and port[1] == "circuit_open"
    assert port[2] == ("queued", "half_open") and port[3] == "circuit_probe"
    assert port[4] == ("done", "closed", 1)


def test_breaker_reopens_on_failure_during_half_open(setup):
    def script(gw, clock, prompts):
        gw.submit(prompts[0], max_new_tokens=6)
        gw.submit(prompts[1], max_new_tokens=6)
        for _ in range(10):
            gw.step()
            clock.advance(1.0)
            if gw._breaker_state == "open":
                break
        trace = [gw._breaker_state]
        clock.advance(10.0)
        probe = gw.submit(prompts[2], max_new_tokens=6)
        trace.append(gw._breaker_state)
        for _ in range(30):
            gw.step()
            clock.advance(1.0)
            if gw._breaker_state == "open":
                break
        trace.append((gw._breaker_state, gw.breaker_openings, probe.status))
        return trace

    specs = [dict(site="serving.decode", kind="error", prob=1.0, attributed=False)]
    cfg = dict(breaker_threshold=1, breaker_window_s=100.0, breaker_cooldown_s=5.0)
    port = _breaker_script(setup, "port", specs, cfg, script)
    assert port == _breaker_script(setup, "jax", specs, cfg, script)
    assert port[0] == "open" and port[1] == "half_open"
    assert port[2][0] == "open" and port[2][1] >= 2


def test_degradation_rungs(setup):
    """Rung 1 turns speculation off, rung 2 halves the admission bounds, a close
    restores everything; as JAX's."""
    out = []
    for side, mod, cfg_cls in (("port", tgw, GatewayConfig), ("jax", jgw, JaxGatewayConfig)):
        clock = ManualClock()
        eng = make_engine(setup, side, spec_k=2)
        gw = mod.ServingGateway(eng, cfg_cls(
            enabled=True, breaker_threshold=1, degrade=True, max_queue=8,
            breaker_window_s=100.0, breaker_cooldown_s=5.0), clock=clock)
        trace = [eng.spec_enabled]
        gw._breaker_open(clock())
        trace.append((gw.degrade_level, eng.spec_enabled))
        gw._breaker_open(clock())
        trace.append((gw.degrade_level, gw._effective_bounds()[0]))
        gw._breaker_close(clock())
        trace.append((gw.degrade_level, gw._effective_bounds()[0], eng.spec_enabled))
        out.append(trace)
    assert out[0] == out[1] == [True, (1, False), (2, 4), (0, 8, True)]


def test_spec_off_mid_run_lands_on_decode_multi(setup, monkeypatch):
    """Rung 1 on a fused speculative engine lands the next dispatches on the plain
    super-step, never N = 1, with the undisturbed greedy tokens."""
    eng = make_engine(setup, "port", spec_k=2, decode_steps=4)
    assert eng._spec_fused()
    gw = tgw.ServingGateway(eng, GatewayConfig(enabled=True, degrade=True),
                            clock=ManualClock())
    reqs = [eng.submit(p, max_new_tokens=24) for p in setup[2][:3]]
    eng.step()
    assert eng.spec_graphs and not eng.graphs
    gw._breaker_open(0.0)
    assert eng.spec_enabled is False

    def no_n1(active):
        raise AssertionError("a degraded fused engine fell back to the N = 1 step")

    monkeypatch.setattr(eng, "_plain_step", no_n1)
    eng.run()
    assert (4, False, False) in eng.graphs
    assert [r.tokens for r in reqs] == clean_tokens(setup, prompts=setup[2][:3], n_new=24)


def test_engine_restart_replay_streams_identical(setup):
    """Requests that die with the engine replay: ``on_retry`` resets the stream and the
    transcripts end equal to an undisturbed run's (and JAX's)."""
    def run_with(side, restart_after=None):
        mod, cfg_cls = (tgw, GatewayConfig) if side == "port" else (jgw, JaxGatewayConfig)
        gw = mod.ServingGateway(make_engine(setup, side, max_slots=2), cfg_cls(enabled=True))
        streams = {i: [] for i in range(len(setup[2]))}
        greqs = [gw.submit(p, max_new_tokens=6,
                           on_token=lambda t, i=i: streams[i].append(int(t)),
                           on_retry=lambda i=i: streams[i].clear())
                 for i, p in enumerate(setup[2])]
        steps = 0
        while gw.queue_depth or gw.running_count:
            gw.step()
            steps += 1
            if restart_after is not None and steps == restart_after:
                assert gw.reattach_engine(make_engine(setup, side, max_slots=2))
        return gw, greqs, streams

    _, clean, clean_streams = run_with("port")
    gw, reqs, streams = run_with("port", restart_after=3)
    jgw_, jreqs, jstreams = run_with("jax", restart_after=3)
    assert gw.counters["replayed"] == jgw_.counters["replayed"] >= 1
    assert streams == clean_streams == jstreams
    assert all(r.status == "done" and r.retries_used == 0 for r in reqs)


def test_deadline_eviction_reaches_recovery_parked_requests(setup):
    """A request recovery parked in the engine's queue or bisection hold is cancelled
    by deadline eviction, not left generating as a zombie; as JAX's."""
    out = []
    for side, mod, cfg_cls in (("port", tgw, GatewayConfig), ("jax", jgw, JaxGatewayConfig)):
        clock = ManualClock()
        plan = make_plan(side, [dict(site="serving.decode", kind="error", prob=1.0, start=1,
                                     max_fires=1, attributed=False)])
        eng = make_engine(setup, side, max_slots=2, faults=plan)
        gw = mod.ServingGateway(eng, cfg_cls(enabled=True), clock=clock)
        greqs = [gw.submit(p, max_new_tokens=8, deadline_s=50.0) for p in setup[2][:2]]
        for _ in range(3):
            gw.step()
            clock.advance(1.0)
        parked = len(eng.queue) + len(eng._bisect_hold)
        assert parked >= 1
        clock.advance(100.0)
        gw.step()
        assert all(g.terminal and g.status == "expired" for g in greqs)
        assert not eng.queue and not eng._bisect_hold
        assert all(r is None for r in eng.slot_req)
        before = [list(g.tokens) for g in greqs]
        for _ in range(5):
            assert gw.step() == []
            clock.advance(1.0)
        assert [list(g.tokens) for g in greqs] == before
        out.append((parked, [(g.status, g.reason, [int(t) for t in g.tokens]) for g in greqs]))
    assert out[0] == out[1]


# ----------------------------------------------------------- training guard
def _train_setup(**acc_kw):
    from accelerate_tpu_torch import optim as topt
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(device="cpu", **acc_kw)
    state = acc.create_train_state({"w": torch.tensor([1.0, -2.0, 3.0])}, topt.sgd(0.1))
    return acc, state


def _loss(p, b):
    return ((p["w"] * b["x"]) ** 2).sum()


BATCHES = [{"x": np.full(3, 0.1 * (i + 1), np.float32)} for i in range(4)]


def test_train_step_fault_injection_nonfinite():
    """A ``train.step:nonfinite`` clause poisons the batch's float leaves with NaN,
    the real guard path: the update is skipped, counted, and a fault record emitted;
    the plan fires at the invocation JAX's does."""
    acc, state = _train_setup(
        fault_config=FaultConfig(enabled=True, spec="train.step:nonfinite,start=1,max=1"),
        telemetry_config=TelemetryConfig(enabled=True, memory_stats=False))
    step = acc.build_train_step(_loss, skip_nonfinite_steps=3)
    state, m0 = step(state, BATCHES[0])
    assert not m0["nonfinite"]
    before = state.params["w"].clone()
    state, m1 = step(state, BATCHES[1])  # the injection fires here
    assert m1["nonfinite"] and step.nonfinite_total == 1
    assert torch.equal(state.params["w"], before)
    state, m2 = step(state, BATCHES[2])
    assert not m2["nonfinite"]
    faults = [r for r in acc.telemetry.records if r["schema"] == FAULT_SCHEMA]
    assert len(faults) == 1 and faults[0]["kind"] == "nonfinite"
    assert validate_record(faults[0]) == []
    ref = jf.FaultPlan.from_spec("train.step:nonfinite,start=1,max=1")
    for _ in range(3):
        ref.draw("train.step")
    assert acc.fault_plan.fired == ref.fired


@pytest.mark.parametrize("kind,exc", [("error", tf.InjectedFault), ("crash", tf.StageCrashed)])
def test_train_step_error_and_crash_draws(kind, exc):
    """``error`` raises its InjectedFault at the step boundary and ``crash`` a
    StageCrashed naming the plan's gang; the telemetry bracket unwinds either way."""
    from accelerate_tpu_torch.telemetry.compile_monitor import _current_label

    acc, state = _train_setup(
        fault_config=FaultConfig(enabled=True, spec=f"train.step:{kind},start=1,max=1"),
        telemetry_config=TelemetryConfig(enabled=True, memory_stats=False))
    step = acc.build_train_step(_loss)
    state, _ = step(state, BATCHES[0])
    with pytest.raises(exc) as info:
        step(state, BATCHES[1])
    assert info.value.site == "train.step"
    if kind == "crash":
        assert info.value.gang_id == "gang0"
    assert _current_label() is None and not acc.telemetry.timer.running
    state, _ = step(state, BATCHES[2])
    assert acc.telemetry.last_step_record["step"] == 2


def test_skip_nonfinite_guard_raises_the_resilience_error():
    """The guard's abort is ``resilience.faults.NonFiniteStepError`` (one class,
    re-exported by the accelerator module)."""
    from accelerate_tpu_torch import accelerator as tacc

    assert tacc.NonFiniteStepError is tf.NonFiniteStepError
    acc, state = _train_setup()
    step = acc.build_train_step(_loss, skip_nonfinite_steps=2)
    bad = {"x": np.full(3, np.nan, np.float32)}
    state, _ = step(state, bad)
    with pytest.raises(tf.NonFiniteStepError):
        step(state, bad)
