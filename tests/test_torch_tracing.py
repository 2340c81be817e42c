"""The port's request tracing and record schemas against the JAX package's, on the CPU.

Mirrors tests/test_tracing.py:64-354 (the schema registry, engine records validating,
the disabled tracer's zero cost, the gateway's clock alignment, prefill span modes,
span sums reconstructing TTFT/TPOT, preemption and shed traces, speculative spans,
engine queue waits) and :553 (``trace-report`` over the port's JSONL). Engines are the
``tiny`` config at fp32 with the JAX weights converted; on a manual clock the port's
gateway and engine emit the same span stream as JAX's (kind, uid, times and the
attributes the report reads), and the JAX package's ``trace_report`` gives the same
report over the port's spans as the port's own copy. ``workload.py``'s trace generation
and replay are not ported: the p95 test drives the gateway with a scripted arrival
process instead.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import serving_gateway as jgw
from accelerate_tpu.commands import trace_report as jtr
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu.telemetry import schemas as jschemas
from accelerate_tpu.telemetry.tracing import Tracer as JaxTracer
from accelerate_tpu.utils.dataclasses import GatewayConfig as JaxGatewayConfig
from accelerate_tpu_torch.commands import trace_report as ttr
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.serving_gateway import ServingGateway
from accelerate_tpu_torch.telemetry import (SCHEMA_REGISTRY, TRACE_SPAN_SCHEMA, Telemetry,
                                            Tracer, percentile, validate_record)
from accelerate_tpu_torch.utils.dataclasses import GatewayConfig, TelemetryConfig

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
ENGINE = dict(max_slots=2, max_len=64, prompt_bucket=16)


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


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _tel(**kw):
    return Telemetry(TelemetryConfig(enabled=True, compile_events=False, memory_stats=False,
                                     **kw))


def _spans(tel):
    return [r for r in tel.records if r.get("schema") == TRACE_SPAN_SCHEMA]


def engine(setup, **kw):
    return ContinuousBatcher(setup[1], TCFG, **{**ENGINE, **kw})


# ------------------------------------------------------------------ schema registry
def test_registry_covers_every_known_stream():
    for expect in ("step", "serving", "serving.kv", "serving.spec", "serving.throughput",
                   "serving.handoff", "gateway.request", "gateway.slo", "elastic.restart",
                   "trace.span", "fault", "recovery", "replica.health", "fleet.route"):
        assert f"accelerate_tpu.telemetry.{expect}/v1" in SCHEMA_REGISTRY, expect
    for reg in SCHEMA_REGISTRY.values():
        assert "schema" in reg.required and len(reg.required) > 1


def test_registry_required_keys_match_jax():
    """Every port schema id is the JAX package's, with the same required keys: one
    consumer reads both streams."""
    for sid, reg in SCHEMA_REGISTRY.items():
        assert reg.required == jschemas.SCHEMA_REGISTRY[sid].required, sid


def test_validate_record_flags_problems():
    assert validate_record({"no": "schema"})
    assert validate_record({"schema": "accelerate_tpu.telemetry.bogus/v9"})
    missing = validate_record({"schema": "accelerate_tpu.telemetry.gateway.request/v1"})
    assert missing and "missing required keys" in missing[0]


def test_engine_serving_records_validate_against_registry(setup):
    """Every record a paged speculative engine emits validates; the stream of schemas,
    steps and the counters the records carry equal the JAX engine's."""
    from accelerate_tpu.telemetry import Telemetry as JaxTelemetry
    from accelerate_tpu.utils.dataclasses import TelemetryConfig as JaxTelemetryConfig

    streams = []
    for batcher, params, cfg, tel in (
            (ContinuousBatcher, setup[1], TCFG, _tel()),
            (JaxBatcher, setup[0], JCFG, JaxTelemetry(JaxTelemetryConfig(
                enabled=True, compile_events=False, memory_stats=False)))):
        eng = batcher(params, cfg, **ENGINE, telemetry=tel, page_size=8, spec_k=2)
        for p in setup[2][:3]:
            eng.submit(p, max_new_tokens=4)
        eng.run(report_throughput=True)
        keys = ("step", "decode_steps", "decode_tokens", "active_slots", "admitted",
                "evicted", "pages_in_use", "kv_alloc_count", "step_proposed",
                "step_accepted", "proposed_total", "tokens_generated", "requests_finished")
        streams.append([(r["schema"],) + tuple(r.get(k) for k in keys) for r in tel.records])
        if batcher is ContinuousBatcher:
            assert all(validate_record(r) == [] for r in tel.records)
    assert streams[0] == streams[1]
    kinds = {s[0] for s in streams[0]}
    assert {"accelerate_tpu.telemetry.serving.kv/v1",
            "accelerate_tpu.telemetry.serving.spec/v1",
            "accelerate_tpu.telemetry.serving.throughput/v1"} <= kinds


# --------------------------------------------------------------- disabled overhead
def test_disabled_tracer_zero_clock_calls_zero_spans(setup, monkeypatch):
    """Tracing and telemetry off cost the decode loop two attribute reads: no clock
    read, no span, no record, no synchronization."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda self: syncs.append(self))
    tel_off = Telemetry(TelemetryConfig())
    assert tel_off.enabled is False
    clock_calls = []

    def counting_clock():
        clock_calls.append(1)
        return 0.0

    tracer = Tracer(tel_off, clock=counting_clock)
    assert tracer.enabled is False
    for kw in ({}, {"page_size": 8, "decode_steps": 4}, {"spec_k": 2}):
        eng = engine(setup, tracer=tracer, telemetry=tel_off, **kw)
        gw = ServingGateway(eng, GatewayConfig(enabled=True), tracer=tracer,
                            telemetry=tel_off)
        for p in setup[2][:3]:
            gw.submit(p, max_new_tokens=5)
        assert all(r.status == "done" for r in gw.run())
    assert clock_calls == [] and syncs == []
    assert tracer.spans_emitted == 0 and tel_off.records == []
    assert tracer.start(0) is None


def test_gateway_aligns_tracer_clock(setup):
    """A tracer left on its default clock takes the gateway's injected clock, so the
    gateway's and the engine's spans share one timeline."""
    tel = _tel()
    tracer = Tracer(tel)
    clock = ManualClock()
    eng = engine(setup, tracer=tracer)
    gw = ServingGateway(eng, GatewayConfig(enabled=True), telemetry=tel, clock=clock,
                        tracer=tracer)
    assert tracer._clock is clock
    gw.submit(setup[2][0], max_new_tokens=3)
    clock.advance(1.0)
    gw.run()
    spans = _spans(tel)
    assert {s["span"] for s in spans} >= {"queue", "prefill", "decode", "terminal"}
    assert all(0.0 <= s["t0"] <= s["t1"] < 100.0 for s in spans)


def test_prefix_engine_prefill_span_mode(setup):
    """On a prefix-cache engine a cold prompt's prefill span says ``chunk`` and a
    registry hit ``prefix``."""
    tel = _tel()
    tracer = Tracer(tel)
    eng = engine(setup, prompt_bucket=8, prefix_cache=4, tracer=tracer)
    gw = ServingGateway(eng, GatewayConfig(enabled=True), telemetry=tel, tracer=tracer)
    shared = np.random.default_rng(3).integers(1, JCFG.vocab_size, 16).astype(np.int32)
    cold = gw.submit(np.concatenate([shared, [5, 6, 7]]), max_new_tokens=2)
    gw.run()
    warm = gw.submit(np.concatenate([shared, [9, 8]]), max_new_tokens=2)
    gw.run()
    by_uid = {s["uid"]: s for s in _spans(tel) if s["span"] == "prefill"}
    assert (by_uid[cold.uid]["mode"], by_uid[cold.uid]["prefix_hit"]) == ("chunk", False)
    assert (by_uid[warm.uid]["mode"], by_uid[warm.uid]["prefix_hit"]) == ("prefix", True)


# --------------------------------------------------------------- span reconstruction
def _span_stream(setup, side, engine_kw, script, clock):
    """One gateway script on ``side``'s stack with a sink tracer on ``clock`` → the
    spans."""
    spans = []
    if side == "port":
        tracer = Tracer(sink=spans.append, clock=clock)
        eng = engine(setup, tracer=tracer, **engine_kw)
        gw = ServingGateway(eng, GatewayConfig(enabled=True, policy="priority",
                                               preempt=True, max_retries=1),
                            clock=clock, tracer=tracer)
    else:
        tracer = JaxTracer(sink=spans.append, clock=clock)
        eng = JaxBatcher(setup[0], JCFG, **ENGINE, tracer=tracer, **engine_kw)
        gw = jgw.ServingGateway(eng, JaxGatewayConfig(enabled=True, policy="priority",
                                                      preempt=True, max_retries=1),
                                clock=clock, tracer=tracer)
    script(gw, clock)
    return spans


ATTRS = ("uid", "span", "t0", "t1", "dur_s", "step", "occupancy", "tokens", "n_steps",
         "proposed", "accepted", "host_s", "mode", "width", "prompt_len", "prefix_hit",
         "lane", "attempt", "outcome", "status", "reason", "n_tokens", "ttft_s", "tpot_s")


@pytest.mark.parametrize("engine_kw", [{}, {"page_size": 8, "decode_steps": 4},
                                       {"spec_k": 2, "page_size": 8}])
def test_span_stream_matches_jax(setup, engine_kw):
    """The port's gateway and engine emit JAX's span stream on a manual clock: queue,
    admit, prefill, decode (its step, occupancy, tokens and host gap), preempt, retry,
    first token and terminal spans, in order, with the same attributes."""
    def script(gw, clock):
        low = [gw.submit(p, max_new_tokens=12, priority=0) for p in setup[2][:2]]
        gw.step()
        clock.advance(0.5)
        for i, p in enumerate(setup[2][2:5]):
            gw.submit(p, max_new_tokens=6, priority=1 + i % 3)
        while gw.queue_depth or gw.running_count:
            gw.step()
            clock.advance(0.25)
        assert all(g.status == "done" for g in low)

    port = _span_stream(setup, "port", engine_kw, script, ManualClock())
    ref = _span_stream(setup, "jax", engine_kw, script, ManualClock())
    assert [tuple(s.get(k) for k in ATTRS) for s in port] == \
        [tuple(s.get(k) for k in ATTRS) for s in ref]
    assert {"preempt", "retry", "first_token", "decode"} <= {s["span"] for s in port}


def test_span_sums_match_terminal_ttft_tpot(setup):
    """On the real clock, each request's spans reconstruct its own terminal TTFT and
    TPOT: the first-token event reuses the gateway's clock read (exact), the queue and
    prefill spans with the stall between them (other requests' admissions in the same
    step) cover it, and TPOT is the decode window over n - 1."""
    tel = _tel()
    tracer = Tracer(tel)
    eng = engine(setup, tracer=tracer)
    gw = ServingGateway(eng, GatewayConfig(enabled=True, policy="priority", max_queue=16),
                        telemetry=tel, tracer=tracer)
    greqs = [gw.submit(p, max_new_tokens=6, tenant=f"t{i % 2}", priority=i % 3)
             for i, p in enumerate(setup[2])]
    gw.run()
    assert all(r.status == "done" for r in greqs)
    spans = _spans(tel)
    assert spans and all(validate_record(s) == [] for s in spans)
    for greq in greqs:
        mine = [s for s in spans if s["uid"] == greq.uid]
        assert {"queue", "admit", "prefill", "decode", "first_token",
                "terminal"} <= {s["span"] for s in mine}
        queue = next(s for s in mine if s["span"] == "queue")
        prefill = next(s for s in mine if s["span"] == "prefill")
        first_t = next(s["t1"] for s in mine if s["span"] == "first_token")
        assert abs((first_t - queue["t0"]) - greq.ttft_s) < 1e-6
        stall = prefill["t0"] - queue["t1"]
        assert stall >= 0
        assert abs((queue["dur_s"] + stall + prefill["dur_s"]) - greq.ttft_s) < 0.05
        decode = [s for s in mine if s["span"] == "decode"]
        assert len(decode) == len(greq.tokens) - 1
        span_tpot = (max(s["t1"] for s in decode) - first_t) / (len(greq.tokens) - 1)
        assert abs(span_tpot - greq.tpot_s) < 0.05
        assert all(s["step"] >= 1 for s in decode)


def test_trace_report_reproduces_gateway_p95_ttft(tmp_path, setup):
    """``trace_report`` over the port's JSONL reproduces the gateway's p95 TTFT from
    spans alone (exactly: the first-token event reuses the gateway's clock read), and
    equals the JAX package's report over the same spans."""
    jdir = str(tmp_path / "run")
    tel = _tel(jsonl_dir=jdir)
    clock = ManualClock()
    tracer = Tracer(tel, clock=clock)
    eng = engine(setup, tracer=tracer)
    gw = ServingGateway(eng, GatewayConfig(enabled=True, policy="edf", max_queue=4,
                                           overload="shed"),
                        telemetry=tel, clock=clock, tracer=tracer)
    rng = np.random.default_rng(3)
    greqs = []
    for i in range(16):  # a scripted bursty arrival process with deadlines
        for _ in range(int(rng.integers(0, 3))):
            p = setup[2][int(rng.integers(0, len(setup[2])))]
            greqs.append(gw.submit(p, max_new_tokens=int(rng.integers(2, 6)),
                                   deadline_s=float(rng.uniform(2.0, 8.0))))
        gw.step()
        clock.advance(float(rng.uniform(0.2, 1.0)))
    while gw.queue_depth or gw.running_count:
        gw.step()
        clock.advance(0.5)
    tel.close()
    spans = ttr.load_spans(os.path.join(jdir, "telemetry.jsonl"))
    report = ttr.trace_report(spans)
    assert report == jtr.trace_report(spans)
    gw_ttfts = [r.ttft_s for r in greqs if r.status == "done"]
    assert report["ttft"]["count"] == len(gw_ttfts) > 0
    assert report["ttft"]["p95"] == round(percentile(gw_ttfts, 95), 6)
    assert report["by_status"]["done"] == sum(r.status == "done" for r in greqs)
    assert set(report["by_status"]) >= {"done"} and len(report["traces"]) == len(greqs)
    shares = [v for v in report["critical_path_share"].values() if v is not None]
    assert abs(sum(shares) - 1.0) < 1e-6


def test_preempt_retry_spans(setup):
    """A preempted, retried request's trace has the preempt and retry events, a second
    queue span with attempt 1 and its terminal span last."""
    tel = _tel()
    tracer = Tracer(tel)
    eng = engine(setup, max_slots=1, tracer=tracer)
    gw = ServingGateway(eng, GatewayConfig(enabled=True, policy="priority", preempt=True,
                                           max_retries=1), telemetry=tel, tracer=tracer)
    low = gw.submit(setup[2][0], max_new_tokens=8, priority=0)
    gw.step()
    gw.submit(setup[2][1], max_new_tokens=3, priority=5)
    gw.step()
    gw.run()
    assert low.status == "done" and low.retries_used == 1
    mine = [s for s in _spans(tel) if s["uid"] == low.uid]
    assert {"preempt", "retry"} <= {s["span"] for s in mine}
    assert [s["attempt"] for s in mine if s["span"] == "queue"] == [0, 1]
    assert mine[-1]["span"] == "terminal" and mine[-1]["status"] == "done"


def test_shed_and_rejected_traces_close(setup):
    """Requests that never run still get whole traces: a queue span to their end and
    the terminal event with its reason; no trace state outlives them."""
    tel = _tel()
    tracer = Tracer(tel)
    eng = engine(setup, max_slots=1, tracer=tracer)
    gw = ServingGateway(eng, GatewayConfig(enabled=True, policy="priority", max_queue=1,
                                           overload="shed"), telemetry=tel, tracer=tracer)
    gw.submit(setup[2][0], max_new_tokens=8)
    gw.step()
    low = gw.submit(setup[2][1], max_new_tokens=4, priority=0)
    high = gw.submit(setup[2][2], max_new_tokens=4, priority=5)
    assert low.status == "shed" and high.status == "queued"
    mine = [s for s in _spans(tel) if s["uid"] == low.uid]
    assert {"shed", "queue", "terminal"} <= {s["span"] for s in mine}
    term = next(s for s in mine if s["span"] == "terminal")
    assert (term["status"], term["reason"]) == ("shed", "overload_shed")
    assert next(s for s in mine if s["span"] == "shed")["shed_for"] == high.uid
    assert low.uid not in tracer._traces


def test_spec_decode_spans_account_every_token(setup):
    """Speculative paged decode spans carry proposals and acceptances; their token sums
    (+1 for the prefill's) equal each transcript, and their steps join the
    ``serving.spec/v1`` records."""
    tel = _tel()
    tracer = Tracer(tel)
    for kw in ({"spec_k": 2, "page_size": 8}, {"spec_k": 2, "decode_steps": 4}):
        tel.records.clear()
        eng = engine(setup, tracer=tracer, telemetry=tel, **kw)
        gw = ServingGateway(eng, GatewayConfig(enabled=True), telemetry=tel, tracer=tracer)
        greqs = [gw.submit(p, max_new_tokens=6) for p in setup[2][:4]]
        gw.run()
        assert all(r.status == "done" for r in greqs)
        decode = [s for s in _spans(tel) if s["span"] == "decode"]
        assert decode and all({"proposed", "accepted", "step"} <= set(s) for s in decode)
        per_uid = {}
        for s in decode:
            per_uid[s["uid"]] = per_uid.get(s["uid"], 0) + s["tokens"]
        assert all(per_uid[g.uid] + 1 == len(g.tokens) for g in greqs)
        spec_steps = {r["step"] for r in tel.records
                      if r.get("schema") == "accelerate_tpu.telemetry.serving.spec/v1"}
        assert {s["step"] for s in decode} <= spec_steps


def test_engine_queue_wait_percentiles(setup):
    """The bare engine reports per-request queue-wait percentiles measured at
    admission, and an honest zero-count block before any."""
    eng = engine(setup, max_slots=1)
    for p in setup[2][:4]:
        eng.submit(p, max_new_tokens=2)
    now = time.monotonic()
    for i, req in enumerate(eng.queue):
        req.enqueued_at = now - (i + 1)
    eng.run()
    qw = eng.stats()["queue_wait"]
    assert qw["count"] == 4 and all(qw[k] > 0 for k in ("mean", "p50", "p95", "p99"))
    assert qw["p99"] >= qw["p50"]
    assert engine(setup, max_slots=1).stats()["queue_wait"] == {"count": 0}


# ------------------------------------------------------------------ trace-report
def test_trace_report_cli(tmp_path, capsys, setup):
    """``trace_report_command`` end to end: spans JSONL in, the critical-path summary
    out (and the JAX package's summary over the same file), one request's timeline,
    machine-readable JSON, an empty file refused."""
    jdir = str(tmp_path / "run")
    tel = _tel(jsonl_dir=jdir, rotate_bytes=4096)
    tracer = Tracer(tel)
    eng = engine(setup, tracer=tracer)
    gw = ServingGateway(eng, GatewayConfig(enabled=True), telemetry=tel, tracer=tracer)
    for p in setup[2][:3]:
        gw.submit(p, max_new_tokens=4)
    gw.run()
    tel.close()
    assert len(os.listdir(jdir)) > 1  # the rotated set, read as one run directory

    assert ttr.main([jdir]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["n_traces"] == 3 and summary["by_status"]["done"] == 3
    assert set(summary["breakdown"]) == {"queue_s", "retry_s", "prefill_s", "handoff_s",
                                         "decode_s", "host_s", "stall_s"}
    ref = jtr.trace_report(jtr.load_spans(jdir))
    assert summary == json.loads(json.dumps({k: v for k, v in ref.items() if k != "traces"}))

    assert ttr.main([jdir, "--uid", "0"]) == 0
    out = capsys.readouterr().out
    assert "prefill" in out and "terminal" in out
    assert ttr.main([jdir, "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)["traces"]) == 3
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    assert ttr.main([empty]) == 1
