"""The port's serving gateway and fleet router against the JAX package's, on the CPU.

Mirrors a subset of tests/test_serving_gateway.py and tests/test_fleet.py: the queue
policies (each scenario through the port's policy and JAX's), the config, SLO
admission and its machine-readable refusals, shedding, deadlines, cancel, preemption
with replay, the circuit breaker, and the fleet's routing records, kill → migrate →
restart, drain, rolling restart, decommission and retirement. Engines are the ``tiny``
config at fp32 (``max_slots=2, max_len=64, prompt_bucket=16``) with the JAX weights
converted; a manual clock makes deadlines and aging deterministic. Greedy tokens and
gateway counters are held equal to JAX's gateway on the same script.

The breaker tests here move ``step_failures`` on an engine subclass;
tests/test_torch_resilience.py drives the breaker from real ``FaultPlan`` faults. At
the end: a ``crash`` clause failing a fleet replica over, and the tracer threaded
through the fleet's replicas (span streams equal JAX's). The metrics plane and
``serve-bench`` wait for their slices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu import serving_gateway as jgw
from accelerate_tpu.telemetry import slo as jslo
from accelerate_tpu.utils.dataclasses import GatewayConfig as JaxGatewayConfig
from accelerate_tpu_torch import serving_gateway as tgw
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.telemetry import Tracer
from accelerate_tpu_torch.telemetry import slo as tslo
from accelerate_tpu_torch.telemetry.schemas import (FLEET_ROUTE_SCHEMA, GATEWAY_REQUEST_SCHEMA,
                                                    GATEWAY_SLO_SCHEMA, REPLICA_HEALTH_SCHEMA,
                                                    validate_record)
from accelerate_tpu_torch.utils.dataclasses import GatewayConfig

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
ENGINE = dict(max_slots=2, max_len=64, prompt_bucket=16)
COUNTERS = ("submitted", "admitted", "done", "rejected", "shed", "cancelled", "expired",
            "evicted", "retried", "replayed")


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
               for n in (5, 9, 3, 7, 6, 4)]
    return jparams, tparams, prompts


@dataclasses.dataclass
class Item:
    """The scheduling attributes a policy sees."""

    uid: int
    priority: int = 0
    deadline_at: object = None
    tenant: str = "default"
    cost: int = 10
    t_submit: float = 0.0


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Sink:
    """A duck-typed telemetry: ``enabled`` and ``emit(record)``."""

    enabled = True

    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)


SIDES = {"port": (tgw, GatewayConfig, ContinuousBatcher, TCFG, 1),
         "jax": (jgw, JaxGatewayConfig, JaxBatcher, JCFG, 0)}


def make_gateway(setup, side="port", clock=None, telemetry=None, engine_kw=None,
                 **cfg_kwargs):
    mod, config, batcher, cfg, pi = SIDES[side]
    cfg_kwargs.setdefault("enabled", True)
    engine = batcher(setup[pi], cfg, **{**ENGINE, "max_slots": cfg_kwargs.pop("max_slots", 2),
                                        **(engine_kw or {})})
    kw = {} if clock is None else {"clock": clock}
    return mod.ServingGateway(engine, config(**cfg_kwargs), telemetry=telemetry, **kw)


def make_fleet(setup, side="port", n=2, clock=None, telemetry=None, factory=True,
               engines=None, **cfg_kwargs):
    mod, config, batcher, cfg, pi = SIDES[side]
    cfg_kwargs.setdefault("enabled", True)
    cfg_kwargs.setdefault("breaker_threshold", 2)
    cfg_kwargs.setdefault("breaker_window_s", 100.0)
    cfg_kwargs.setdefault("breaker_cooldown_s", 5.0)

    def build(rid):
        return batcher(setup[pi], cfg, **ENGINE)

    kw = {} if clock is None else {"clock": clock}
    return mod.FleetRouter(engines or [build(i) for i in range(n)], config(**cfg_kwargs),
                           telemetry=telemetry, engine_factory=build if factory else None,
                           **kw)


def both(setup, script, maker=make_gateway, **kw):
    """Run ``script(gateway, side) -> result`` on the port's gateway and JAX's → the two
    results, each with the gateway's counters."""
    out = {}
    for side in SIDES:
        gw = maker(setup, side, **kw)
        res = script(gw, side)
        out[side] = (res, {k: gw.counters[k] for k in COUNTERS if k in gw.counters})
    return out["port"], out["jax"]


def toks(greqs):
    return [[int(t) for t in g.tokens] for g in greqs]


# ------------------------------------------------------------------- policy units
def _policy_fifo(mod):
    pol = mod.FifoPolicy()
    for uid in (3, 1, 7):
        pol.push(Item(uid))
    return [pol.pop(0.0).uid for _ in range(3)] + [pol.pop(0.0)]


def _policy_priority_aged(mod):
    pol = mod.PriorityPolicy(aging_s=10.0)
    pol.push(Item(0, priority=0))
    pol.push(Item(1, priority=2))
    out = [pol.pop(1.0).uid]
    pol.push(Item(2, priority=0))
    pol.push(Item(3, priority=2, t_submit=25.0))
    return out + [pol.pop(25.0).uid for _ in range(3)]


def _policy_shed_candidate(mod):
    pol = mod.PriorityPolicy(aging_s=10.0)
    for uid, prio in ((0, 3), (1, 0), (2, 0)):
        pol.push(Item(uid, priority=prio))
    return pol.shed_candidate(1.0).uid


def _policy_edf(mod):
    pol = mod.EdfPolicy()
    for uid, d in ((0, None), (1, 50.0), (2, 10.0), (3, None)):
        pol.push(Item(uid, deadline_at=d))
    return [pol.pop(0.0).uid for _ in range(4)]


def _policy_wfq(mod):
    pol = mod.WfqPolicy()
    for uid in range(4):
        pol.push(Item(uid, tenant="A"))
    for uid in (4, 5):
        pol.push(Item(uid, tenant="B"))
    return [pol.pop(0.0).uid for _ in range(6)]


def _policy_wfq_weights(mod):
    pol = mod.WfqPolicy(tenant_weights={"B": 2.0})
    for uid, t in ((0, "A"), (1, "A"), (2, "B"), (3, "B")):
        pol.push(Item(uid, tenant=t))
    return [pol.pop(0.0).uid for _ in range(4)]


def _policy_wfq_take_and_refund(mod):
    pol = mod.WfqPolicy()
    pol.push(Item(0, tenant="A"))
    pol.take(0, now=0.0)
    charged = pol._tenant_finish["A"]
    pol.push(Item(1, tenant="A"))
    pol.remove(1)
    return charged, pol._tenant_finish["A"], pol._v


POLICY_CASES = {
    "fifo": (_policy_fifo, [1, 3, 7, None]),
    "priority_aged": (_policy_priority_aged, [1, 0, 2, 3]),
    "shed_candidate": (_policy_shed_candidate, 2),
    "edf": (_policy_edf, [2, 1, 0, 3]),
    "wfq": (_policy_wfq, [0, 4, 1, 5, 2, 3]),
    "wfq_weights": (_policy_wfq_weights, [2, 0, 3, 1]),
    "wfq_take_and_refund": (_policy_wfq_take_and_refund, (10.0, 10.0, 0.0)),
}


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_policy_matches_jax(case):
    """Mirrors the policy unit tests: each scenario gives the expected order through
    the port's policy and through JAX's."""
    fn, want = POLICY_CASES[case]
    assert fn(tgw) == fn(jgw) == want


def test_policy_names_match_config_vocabulary():
    from accelerate_tpu_torch.utils.dataclasses import _GATEWAY_POLICIES

    assert set(tgw.POLICIES) == set(_GATEWAY_POLICIES) == set(jgw.POLICIES)
    for name, cls in tgw.POLICIES.items():
        assert cls.name == name


def test_gateway_config_env_and_validation(monkeypatch):
    """Mirrors test_gateway_config_env_policy_value and test_gateway_config_validation."""
    monkeypatch.setenv("ACCELERATE_GATEWAY", "edf")
    cfg = GatewayConfig()
    assert cfg.enabled and cfg.policy == "edf"
    monkeypatch.setenv("ACCELERATE_GATEWAY", "1")
    assert GatewayConfig().policy == "fifo" and GatewayConfig().enabled
    monkeypatch.setenv("ACCELERATE_GATEWAY", "0")
    assert not GatewayConfig().enabled
    monkeypatch.setenv("ACCELERATE_GATEWAY", "prio")
    with pytest.raises(ValueError, match="ACCELERATE_GATEWAY"):
        GatewayConfig()
    monkeypatch.delenv("ACCELERATE_GATEWAY")
    assert not GatewayConfig().enabled
    for kw, match in ((dict(policy="lifo"), "policy"), (dict(overload="panic"), "overload"),
                      (dict(aging_s=0.0), "aging_s"),
                      (dict(policy="wfq", tenant_weights={"a": 0.0}), "tenant_weights"),
                      (dict(decode_steps=0), "decode_steps"),
                      (dict(replica_restarts=-1), "replica_restarts")):
        with pytest.raises(ValueError, match=match):
            GatewayConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JaxGatewayConfig(**kw)


def test_slo_percentile_math():
    """Mirrors test_slo_percentile_math: the same summaries as JAX's."""
    vals = [0.5, 0.1, None, 0.3, 0.9, 0.2]
    assert tslo.latency_summary(vals) == jslo.latency_summary(vals)
    assert tslo.percentile([1.0, 2.0, 3.0, 4.0], 95) == jslo.percentile([1.0, 2.0, 3.0, 4.0], 95)
    assert tslo.latency_summary([None]) == {"count": 0}
    assert tslo.slo_attainment(vals, 0.3) == jslo.slo_attainment(vals, 0.3) == 0.6


# ------------------------------------------------------------------- integration
def test_fifo_gateway_matches_engine_and_jax(setup):
    """Mirrors test_fifo_gateway_matches_engine_results_and_order: the fifo gateway
    reproduces the bare engine's schedule and tokens, streams equal the token lists,
    and the tokens and completion order equal JAX's gateway."""
    tparams, prompts = setup[1], setup[2]
    n_new = [6, 4, 8, 3, 5, 7]
    engine = ContinuousBatcher(tparams, TCFG, **ENGINE)
    ereqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    engine_done = [r.uid for r in engine.run()]

    def script(gw, side):
        streamed = {i: [] for i in range(len(prompts))}
        greqs = [gw.submit(p, max_new_tokens=n, on_token=streamed[i].append)
                 for i, (p, n) in enumerate(zip(prompts, n_new))]
        done = [r.uid for r in gw.run()]
        assert all(g.status == "done" and g.ttft_s is not None and g.tpot_s is not None
                   for g in greqs)
        assert toks(greqs) == [[int(t) for t in streamed[i]] for i in range(len(prompts))]
        return done, toks(greqs)

    port, jax_ = both(setup, script, policy="fifo")
    assert port == jax_
    assert port[0][0] == engine_done
    assert port[0][1] == [list(map(int, r.tokens)) for r in ereqs]


def test_rejected_at_admission_machine_readable(setup):
    """Mirrors test_rejected_at_admission_machine_readable: queue_full, token_budget
    and unservable refusals are terminal results, with JAX's reasons and counters."""

    def script(gw, side):
        a = gw.submit(setup[2][0], max_new_tokens=3)
        b = gw.submit(setup[2][1], max_new_tokens=3)
        gw.run()
        return a.status, b.status, b.reason

    assert both(setup, script, max_slots=1, max_queue=1) == (
        (("done", "rejected", "queue_full"), {**dict.fromkeys(COUNTERS, 0), "submitted": 2,
                                              "admitted": 1, "done": 1, "rejected": 1}),) * 2

    def script2(gw, side):
        c = gw.submit(setup[2][0], max_new_tokens=3)
        d = gw.submit(setup[2][1], max_new_tokens=3)
        e = gw.submit(setup[2][2], max_new_tokens=200)
        gw.run()
        return c.status, d.reason, e.status, e.reason.split(":")[0], c.cost

    port, jax_ = both(setup, script2, max_slots=1, max_queued_tokens=20)
    assert port == jax_
    assert port[0] == ("done", "token_budget", "rejected", "unservable", 19)


def test_shed_lowest_priority_first_and_atomic(setup):
    """Mirrors test_shed_lowest_priority_first and
    test_shed_is_atomic_when_blocked_by_a_more_urgent_item."""
    prompts = setup[2]

    def shed(gw, side):
        lo1 = gw.submit(prompts[0], max_new_tokens=3, priority=0)
        lo2 = gw.submit(prompts[1], max_new_tokens=3, priority=0)
        hi = gw.submit(prompts[2], max_new_tokens=3, priority=5)
        eq = gw.submit(prompts[3], max_new_tokens=3, priority=0)
        gw.run()
        return [(g.status, g.reason) for g in (lo1, lo2, hi, eq)]

    port, jax_ = both(setup, shed, max_slots=1, policy="priority", max_queue=2,
                      overload="shed")
    assert port == jax_
    assert port[0] == [("done", None), ("shed", "overload_shed"), ("done", None),
                       ("rejected", "queue_full")]

    def atomic(gw, side):
        lo = gw.submit(prompts[0], max_new_tokens=3, priority=0)
        hi = gw.submit(prompts[1], max_new_tokens=20, priority=9)
        mid = gw.submit(prompts[2], max_new_tokens=14, priority=4)
        gw.run()
        return [(g.status, g.reason) for g in (lo, hi, mid)]

    port, jax_ = both(setup, atomic, max_slots=1, policy="priority", max_queued_tokens=60,
                      overload="shed")
    assert port == jax_
    assert port[0][2] == ("rejected", "token_budget") and port[1]["shed"] == 0


def test_deadlines_and_cancel(setup):
    """Mirrors test_deadline_evicts_running_and_frees_slot_same_step,
    test_deadline_expires_queued_requests and test_cancel_queued_vs_in_flight."""
    prompts = setup[2]

    def script(gw, side):
        clock = gw._clock
        a = gw.submit(prompts[0], max_new_tokens=20, deadline_s=5.0)
        b = gw.submit(prompts[1], max_new_tokens=10)
        c = gw.submit(prompts[2], max_new_tokens=3, deadline_s=2.0)
        gw.step()
        first = (a.status, b.status, c.status)
        clock.advance(6.0)
        gw.step()  # a evicted, c expired in the queue, b admitted into a's lane
        second = [(g.status, g.reason) for g in (a, b, c)]
        d = gw.submit(prompts[3], max_new_tokens=5)
        gw.step()
        assert gw.cancel(b.uid) and gw.cancel(d.uid)
        assert not gw.cancel(b.uid) and not gw.cancel(12345)
        e = gw.submit(prompts[4], max_new_tokens=3)
        gw.run()
        return (first, second, [(g.status, g.reason) for g in (b, d, e)],
                len(a.tokens), len(b.tokens), toks([e]),
                gw.stats()["engine"]["evicted_external"])

    port, jax_ = both(setup, script, clock=ManualClock(), max_slots=1)
    assert port == jax_
    (first, second, cancelled, n_a, n_b, _, evicted), _ = port
    assert first == ("running", "queued", "queued")
    assert second == [("expired", "deadline_running"), ("running", None),
                      ("expired", "deadline_queued")]
    assert cancelled == [("cancelled", "cancelled_running"), ("cancelled", "cancelled_queued"),
                         ("done", None)]
    assert n_a >= 1 and n_b >= 1 and evicted == 2


def test_preemption_with_bounded_retry(setup):
    """Mirrors test_preemption_with_bounded_retry and
    test_preempt_evicted_terminal_keeps_partial_tokens: the victim replays from scratch
    (``on_retry`` before the stream restarts) while its budget lasts, then is evicted
    with the tokens it streamed; the preemptor takes the freed lane directly."""
    prompts = setup[2]

    def script(gw, side):
        resets, streamed = [], []
        low = gw.submit(prompts[0], max_new_tokens=12, priority=0,
                        on_retry=lambda: (resets.append(True), streamed.clear()),
                        on_token=streamed.append)
        gw.step()
        hi = gw.submit(prompts[1], max_new_tokens=3, priority=5)
        gw.step()
        mid = (low.status, low.retries_used, low.tokens == [], hi.status, len(resets))
        gw.run()
        return mid, (low.status, hi.status), toks([low, hi]), [int(t) for t in streamed]

    port, jax_ = both(setup, script, max_slots=1, policy="fifo", preempt=True, max_retries=1)
    assert port == jax_
    mid, final, tokens, streamed = port[0]
    assert mid == ("queued", 1, True, "running", 1) and final == ("done", "done")
    assert streamed == tokens[0] and port[1]["retried"] == 1

    def evict(gw, side):
        streamed = []
        low = gw.submit(prompts[0], max_new_tokens=12, on_token=streamed.append)
        gw.step()
        gw.step()
        gw.submit(prompts[1], max_new_tokens=3, priority=5)
        gw.step()
        gw.run()
        return low.status, low.reason, toks([low])[0] == [int(t) for t in streamed]

    port, jax_ = both(setup, evict, max_slots=1, policy="priority", preempt=True,
                      max_retries=0)
    assert port == jax_ and port[0] == ("evicted", "preempted", True)


def test_gateway_records_validate(setup):
    """One valid ``gateway.request/v1`` record per terminal request and the aggregate
    ``gateway.slo/v1`` record (``run(report_slo=True)``)."""
    tel = Sink()
    gw = make_gateway(setup, telemetry=tel, max_queue=3)
    greqs = [gw.submit(p, max_new_tokens=3) for p in setup[2]]
    _, record = gw.run(report_slo=True)
    reqs = [r for r in tel.records if r["schema"] == GATEWAY_REQUEST_SCHEMA]
    assert len(reqs) == len(greqs) and all(validate_record(r) == [] for r in tel.records)
    assert record["schema"] == GATEWAY_SLO_SCHEMA and validate_record(record) == []
    assert record["slo"]["by_status"]["rejected"] == 3 and record["done"] == 3


class FlakyEngine(ContinuousBatcher):
    """An engine whose ``step_failures`` counter a test moves directly."""

    fail_steps = 0

    def step(self):
        if self.fail_steps:
            self.fail_steps -= 1
            self.step_failures = getattr(self, "step_failures", 0) + 1
        return super().step()


@pytest.mark.parametrize("script", ["open_close", "probe_fails", "disabled"])
def test_circuit_breaker_matches_jax(script):
    """The breaker's state machine against JAX's on the same failures and gates."""
    events = {"open_close": [("fail", 2, 0.0), ("gate", 1, 1.0), ("gate", 2, 6.0),
                             ("gate", 3, 6.5), ("close", None, 7.0), ("gate", 4, 7.0)],
              "probe_fails": [("fail", 3, 0.0), ("gate", 1, 5.0), ("fail", 1, 5.5),
                              ("gate", 2, 6.0), ("gate", 3, 11.0)],
              "disabled": [("fail", 9, 0.0), ("gate", 1, 0.0)]}[script]
    trace = []
    for mod in (tgw, jgw):
        br = mod.CircuitBreaker(0 if script == "disabled" else 2, 60.0, 5.0)
        out = []
        for kind, arg, now in events:
            if kind == "fail" and br.record_failures(arg, now):
                br.open(now)
            elif kind == "gate":
                out.append(br.gate(arg, now))
            elif kind == "close":
                br.close(now)
            out.append((br.state, br.probe_uid, br.openings, br.closings))
        trace.append(out)
    assert trace[0] == trace[1]


def test_gateway_breaker_opens_and_degrades(setup):
    """Step failures past the threshold open the gateway's breaker (submissions are
    refused ``circuit_open``) and, with ``degrade``, turn speculation off through
    ``set_spec_enabled``; after the cooldown one probe is admitted and its success
    closes the breaker and restores speculation."""
    clock = ManualClock()
    engine = FlakyEngine(setup[1], TCFG, **ENGINE, spec_k=2)
    gw = tgw.ServingGateway(engine, GatewayConfig(
        enabled=True, breaker_threshold=2, breaker_cooldown_s=5.0, degrade=True), clock=clock)
    engine.fail_steps = 2
    a = gw.submit(setup[2][0], max_new_tokens=3)
    gw.step()
    gw.step()
    assert gw.stats()["breaker_state"] == "open" and gw.degrade_level == 1
    assert not engine.spec_enabled
    refused = gw.submit(setup[2][1], max_new_tokens=3)
    assert refused.status == "rejected" and refused.reason == "circuit_open"
    gw.run()
    assert a.status == "done"
    clock.advance(6.0)
    probe = gw.submit(setup[2][2], max_new_tokens=3)
    other = gw.submit(setup[2][3], max_new_tokens=3)
    assert other.reason == "circuit_probe"
    gw.run()
    assert probe.status == "done" and gw.stats()["breaker_state"] == "closed"
    assert engine.spec_enabled and gw.degrade_level == 0


def test_gateway_refuses_unported_telemetry(setup):
    """The gateway's telemetry hooks, all ported now: a tracer is handed to the engine;
    ``GatewayConfig.metrics`` over an enabled telemetry builds the metrics plane as one
    of its sinks (``stats()["metrics"]``); an armed flight recorder gets the gateway's
    capsule state, the plane and the clock; the ``decode_steps`` pairing is still
    refused."""
    from accelerate_tpu_torch.telemetry import MetricsPlane, Telemetry
    from accelerate_tpu_torch.utils.dataclasses import TelemetryConfig

    engine = ContinuousBatcher(setup[1], TCFG, **ENGINE)
    tracer = Tracer(sink=lambda record: None)
    tgw.ServingGateway(engine, GatewayConfig(enabled=True), tracer=tracer)
    assert engine.tracer is tracer
    engine = ContinuousBatcher(setup[1], TCFG, **ENGINE)
    tel = Telemetry(TelemetryConfig(enabled=True, recorder=True, compile_events=False,
                                    memory_stats=False))
    gw = tgw.ServingGateway(engine, GatewayConfig(enabled=True, metrics=True), telemetry=tel)
    assert isinstance(gw.metrics, MetricsPlane) and gw.metrics.enabled
    assert "metrics" in gw.stats()
    assert tel.recorder.metrics is gw.metrics
    assert tel.recorder._state_providers["gateway"] == gw._capsule_state
    assert gw._capsule_state()["lanes"] == [None] * ENGINE["max_slots"]
    assert tgw.ServingGateway(engine, GatewayConfig(enabled=True),
                              telemetry=Sink()).metrics is None
    with pytest.raises(ValueError, match="decode_steps"):
        tgw.ServingGateway(engine, GatewayConfig(enabled=True, decode_steps=4))


# ------------------------------------------------------------------------ fleet
def test_fleet_matches_single_engine_and_emits_records(setup):
    """Mirrors test_fleet_matches_single_engine_outputs and
    test_fleet_routes_to_least_loaded_and_emits_records."""
    prompts = setup[2]
    single = make_gateway(setup)
    sreqs = [single.submit(p, max_new_tokens=6) for p in prompts]
    single.run()
    tel = Sink()
    fleet = make_fleet(setup, n=2, telemetry=tel)
    freqs = [fleet.submit(p, max_new_tokens=6) for p in prompts]
    fleet.run()
    assert toks(freqs) == toks(sreqs)
    routes = [r for r in tel.records if r["schema"] == FLEET_ROUTE_SCHEMA]
    health = [r for r in tel.records if r["schema"] == REPLICA_HEALTH_SCHEMA]
    assert len(routes) == fleet.counters["admitted"] == len(prompts)
    assert all(validate_record(r) == [] for r in tel.records)
    assert {r["replica"] for r in routes} == {r["replica"] for r in health} == {0, 1}
    assert all(0.0 <= r["health"] <= 1.0 for r in health)
    with pytest.raises(ValueError, match="geometry"):
        tgw.FleetRouter([ContinuousBatcher(setup[1], TCFG, **ENGINE),
                         ContinuousBatcher(setup[1], TCFG, **{**ENGINE, "max_len": 128})],
                        GatewayConfig(enabled=True))
    with pytest.raises(ValueError, match="degrade"):
        make_fleet(setup, degrade=True)


def test_kill_migrates_inflight_and_restarts(setup):
    """Mirrors test_kill_migrates_inflight_lossless: killing a replica mid-decode
    replays its requests on the survivor (streams end equal to an undisturbed fleet's,
    no retry budget spent) and the replica comes back through the supervisor; tokens
    and counters equal JAX's fleet."""
    prompts = setup[2]

    def script(fleet, side):
        streams = {i: [] for i in range(len(prompts))}
        greqs = [fleet.submit(p, max_new_tokens=8, on_token=streams[i].append,
                              on_retry=streams[i].clear) for i, p in enumerate(prompts)]
        fleet.step()
        fleet.step()
        fleet.kill(0)
        assert fleet.replicas[0].engine.crashed
        fleet.run()
        assert all(g.status == "done" and g.retries_used == 0 for g in greqs)
        assert [[int(t) for t in streams[i]] for i in streams] == toks(greqs)
        return (toks(greqs), fleet.replicas[0].restarts, fleet.counters["migrated"],
                fleet.counters["replica_kills"])

    port, jax_ = both(setup, script, maker=make_fleet)
    assert port == jax_
    clean = make_fleet(setup)
    creqs = [clean.submit(p, max_new_tokens=8) for p in prompts]
    clean.run()
    assert port[0][0] == toks(creqs)
    assert port[0][1:] == (1, port[0][2], 1) and port[0][2] >= 1


def test_all_replicas_retired_fails_backlog(setup):
    """Mirrors test_all_replicas_retired_fails_backlog_machine_readably."""

    def script(fleet, side):
        greqs = [fleet.submit(p, max_new_tokens=8) for p in setup[2]]
        fleet.step()
        fleet.kill(0)
        fleet.kill(1)
        returned = {g.uid for g in fleet.run()}
        down = [g.uid for g in greqs if g.status == "failed" and g.reason == "fleet_down"]
        assert down and set(down) <= returned
        late = fleet.submit(setup[2][0], max_new_tokens=4)
        return [r.state for r in fleet.replicas], down, late.reason

    port, jax_ = both(setup, script, maker=make_fleet, factory=False, replica_restarts=0)
    assert port == jax_ and port[0][0] == ["retired", "retired"]
    assert port[0][2] == "fleet_down"


def test_drain_probe_and_deadline_migration(setup):
    """Mirrors test_drain_finishes_inflight_then_probes and
    test_drain_deadline_migrates_remainder."""
    prompts = setup[2]

    def drain(fleet, side):
        greqs = [fleet.submit(p, max_new_tokens=8) for p in prompts[:4]]
        fleet.step()
        fleet.drain(0, deadline_s=1000.0)
        fleet.run()
        rep0 = fleet.replicas[0]
        mid = (rep0.restarts, rep0.state, rep0.breaker.state, fleet.counters["migrated"])
        probe = fleet.submit(prompts[4], max_new_tokens=4)
        fleet.run()
        return mid, probe.status, rep0.breaker.state, toks(greqs + [probe])

    port, jax_ = both(setup, drain, maker=make_fleet)
    assert port == jax_
    assert port[0][:3] == ((1, "active", "half_open", 0), "done", "closed")

    def deadline(fleet, side):
        streams = {i: [] for i in range(len(prompts))}
        greqs = [fleet.submit(p, max_new_tokens=12, on_token=streams[i].append,
                              on_retry=streams[i].clear) for i, p in enumerate(prompts)]
        fleet.step()
        fleet.drain(0, deadline_s=2.0)
        fleet._clock.advance(5.0)
        fleet.run()
        assert all(g.status == "done" for g in greqs)
        assert [[int(t) for t in streams[i]] for i in streams] == toks(greqs)
        return fleet.counters["migrated"], fleet.replicas[0].restarts, toks(greqs)

    port, jax_ = both(setup, deadline, maker=make_fleet, clock=ManualClock())
    assert port == jax_ and port[0][0] >= 1 and port[0][1] == 1


def test_rolling_restart_and_decommission(setup):
    """Mirrors test_rolling_restart_cycles_every_replica; then ``decommission`` drains
    a replica and retires it without charging its restart budget."""
    prompts = setup[2]
    fleet = make_fleet(setup)
    fleet.rolling_restart(deadline_s=1000.0)
    greqs, pending = [], [p for p in prompts for _ in range(2)]
    for _ in range(200):
        if pending:
            greqs.append(fleet.submit(pending.pop(0), max_new_tokens=4))
        fleet.step()
        if not pending and not fleet.queue_depth and not fleet.running_count and all(
                r.restarts == 1 and r.breaker.state == "closed" for r in fleet.replicas):
            break
    assert all(r.restarts == 1 and r.state == tgw.ACTIVE for r in fleet.replicas)
    assert all(g.status == "done" for g in greqs)
    fleet.decommission(1, deadline_s=1000.0)
    g = fleet.submit(prompts[0], max_new_tokens=4)
    fleet.run()
    assert g.status == "done" and g._rid == 0  # never routed to the draining replica
    assert fleet.replicas[1].state == tgw.RETIRED
    assert fleet.supervisor.attempts_used("replica1") == 0
    assert fleet.counters["replica_retired"] == 1


def test_breaker_trip_isolates_replica_keeps_serving(setup):
    """Mirrors test_breaker_trip_isolates_replica_keeps_serving: failures on one
    replica open ITS breaker and migrate its requests; the other serves everything
    and no request is refused."""
    flaky = FlakyEngine(setup[1], TCFG, **ENGINE)
    flaky.fail_steps = 10 ** 6
    fleet = make_fleet(setup, engines=[flaky, ContinuousBatcher(setup[1], TCFG, **ENGINE)],
                       breaker_cooldown_s=1e9)
    greqs = [fleet.submit(p, max_new_tokens=6) for p in setup[2]]
    fleet.run()
    assert fleet.counters["rejected"] == 0 and fleet.counters["migrated"] >= 1
    assert [r.breaker.state for r in fleet.replicas] == ["open", "closed"]
    single = make_gateway(setup)
    sreqs = [single.submit(p, max_new_tokens=6) for p in setup[2]]
    single.run()
    assert all(g.status == "done" for g in greqs) and toks(greqs) == toks(sreqs)


# ------------------------------------------------------ faults and tracing (slice 15)
def test_injected_crash_fault_fails_over(setup):
    """Mirrors tests/test_fleet.py::test_injected_crash_fault_fails_over: a seeded
    ``crash`` clause raises ``EngineCrashed`` past the engine's recovery boundary, and
    the fleet router turns it into migration and restart: every request done, the
    plan firing where JAX's does; a bare engine surfaces the crash and is marked
    crashed."""
    from accelerate_tpu.resilience import faults as jfaults
    from accelerate_tpu_torch.resilience import faults as tfaults

    out = []
    for side, faults in (("port", tfaults), ("jax", jfaults)):
        _, _, batcher, cfg, pi = SIDES[side]
        plan = faults.FaultPlan([faults.FaultSpec("serving.decode", "crash", prob=1.0,
                                                  start=2, max_fires=1)], seed=3)
        engines = [batcher(setup[pi], cfg, **ENGINE, faults=plan),
                   batcher(setup[pi], cfg, **ENGINE)]
        fleet = make_fleet(setup, side, engines=engines)
        greqs = [fleet.submit(p, max_new_tokens=8) for p in setup[2]]
        fleet.run()
        out.append((toks(greqs), [g.status for g in greqs], plan.fired,
                    fleet.counters["replica_kills"], fleet.counters["migrated"]))
        bare = batcher(setup[pi], cfg, **ENGINE, faults=faults.FaultPlan(
            [faults.FaultSpec("serving.decode", "crash", prob=1.0)], seed=0))
        bare.submit(setup[2][0], max_new_tokens=8)
        with pytest.raises(faults.EngineCrashed):
            bare.run()
        assert bare.crashed
    assert out[0] == out[1]
    assert out[0][1] == ["done"] * len(setup[2]) and out[0][3] == 1
    assert out[0][2][0]["kind"] == "crash"


def test_fleet_threads_tracer_through_replicas(setup):
    """The fleet router hands its tracer to every replica (a restarted one too): each
    request's trace has its queue, prefill, decode and terminal spans, and the span
    stream equals JAX's fleet's on a manual clock."""
    from accelerate_tpu.telemetry.tracing import Tracer as JaxTracer

    streams = []
    for side, tracer_cls in (("port", Tracer), ("jax", JaxTracer)):
        spans = []
        clock = ManualClock()
        mod, config, batcher, cfg, pi = SIDES[side]
        tracer = tracer_cls(sink=spans.append, clock=clock)

        def build(rid):
            return batcher(setup[pi], cfg, **ENGINE)

        fleet = mod.FleetRouter([build(0), build(1)], config(
            enabled=True, breaker_threshold=2, breaker_window_s=100.0,
            breaker_cooldown_s=5.0), clock=clock, tracer=tracer, engine_factory=build)
        greqs = [fleet.submit(p, max_new_tokens=5) for p in setup[2]]
        fleet.step()
        clock.advance(0.5)
        fleet.kill(0)  # the replayed requests' traces record the retry
        while fleet.queue_depth or fleet.running_count:
            fleet.step()
            clock.advance(0.5)
        assert all(g.status == "done" for g in greqs)
        assert all(rep.engine.tracer is tracer for rep in fleet.replicas)
        for g in greqs:
            kinds = {s["span"] for s in spans if s["uid"] == g.uid}
            assert {"queue", "prefill", "decode", "terminal"} <= kinds
        streams.append([(s["uid"], s["span"], s["t0"], s["t1"], s.get("step"),
                         s.get("tokens"), s.get("attempt")) for s in spans])
    assert streams[0] == streams[1]
    assert any(s[1] == "retry" for s in streams[0])
