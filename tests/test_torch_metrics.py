"""The port's metrics plane, alert engine, Prometheus export and metrics-dump against
the JAX package's, on the CPU.

The modules are stdlib-only in both packages, so every comparison here is EXACT: one
record stream, built from a numpy seed under a manual clock, goes through the JAX
``MetricsPlane``/``AlertEngine`` and the port's (``scenario(JAX) == scenario(PORT)``):
``stats()`` equal, ``prometheus_text`` byte for byte, the same alert transitions. Each
test mirrors the test of ``tests/test_metrics.py`` named in its docstring and keeps that
test's own assertions on the port's side. The engine-level tests run the port's
``ContinuousBatcher`` (``tiny`` at fp32, the JAX weights through ``params_from_jax``)
beside the JAX engine on a manual clock.

Not mirrored: the MPMD stage-step and train-report tests (``tests/test_metrics.py``
from line 558; pipeline stage records come with the pipeline-parallel slice) and the
docs-catalog drift gate (the port keeps no docs copy of the catalog).
"""

import dataclasses
import gzip
import json
import os
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerate_tpu.telemetry as jtel
import accelerate_tpu.telemetry.alerts as jalerts
import accelerate_tpu.telemetry.exporter as jexp
import accelerate_tpu.telemetry.metrics as jmetrics
import accelerate_tpu.telemetry.schemas as jschemas
import accelerate_tpu.utils.dataclasses as jdc
import accelerate_tpu_torch.telemetry as ttel
import accelerate_tpu_torch.telemetry.alerts as talerts
import accelerate_tpu_torch.telemetry.exporter as texp
import accelerate_tpu_torch.telemetry.metrics as tmetrics
import accelerate_tpu_torch.telemetry.schemas as tschemas
import accelerate_tpu_torch.utils.dataclasses as tdc
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu.serving_gateway import ServingGateway as JaxGateway
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.serving_gateway import ServingGateway

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
ENGINE = dict(max_slots=2, max_len=64, prompt_bucket=16, page_size=8)


def _side(metrics, alerts, exporter, schemas, telemetry, dc):
    return types.SimpleNamespace(
        m=metrics, MetricsPlane=metrics.MetricsPlane, AlertEngine=alerts.AlertEngine,
        AlertRule=alerts.AlertRule, default_alert_rules=alerts.default_alert_rules,
        prometheus_text=exporter.prometheus_text, MetricsExporter=exporter.MetricsExporter,
        s=schemas, Telemetry=telemetry.Telemetry, TelemetryConfig=dc.TelemetryConfig)


JAX = _side(jmetrics, jalerts, jexp, jschemas, jtel, jdc)
PORT = _side(tmetrics, talerts, texp, tschemas, ttel, tdc)
HEALTH = "accelerate_tpu.telemetry.replica.health/v1"


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


def _tel(side, **kw):
    return side.Telemetry(side.TelemetryConfig(enabled=True, compile_events=False,
                                               memory_stats=False, **kw))


def _request_record(side, uid, status="done", tokens=5, ttft=0.3, deadline_met=True):
    return {"schema": side.s.GATEWAY_REQUEST_SCHEMA, "uid": uid, "status": status,
            "reason": None, "tenant": "default", "priority": 0, "n_tokens": tokens,
            "retries_used": 0, "queue_wait_s": 0.1, "ttft_s": ttft, "tpot_s": 0.02,
            "deadline_met": deadline_met}


def both(scenario):
    """Run ``scenario(side)`` through the JAX modules and the port's; the results must
    be equal. Returns the port's."""
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    return got


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and message are the result
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------------------------- registry
def test_metric_registry_names_and_catalog():
    """Mirrors test_metric_registry_names_and_catalog: the minted naming shape, and the
    registry (names, kinds, labels, sources, descriptions) and its catalog table equal
    JAX's."""
    for name in tmetrics.registered_metrics():
        spec = tmetrics.METRIC_REGISTRY[name]
        assert name.startswith("accelerate_tpu_") and not name.endswith("_")
        assert spec.kind in ("counter", "gauge", "histogram")
        if spec.kind == "counter":
            assert name.endswith("_total"), f"{name}: counters end in _total"
    assert ({k: dataclasses.astuple(v) for k, v in tmetrics.METRIC_REGISTRY.items()}
            == {k: dataclasses.astuple(v) for k, v in jmetrics.METRIC_REGISTRY.items()})
    rows = jmetrics.metric_table_markdown().splitlines()[1:-1]  # JAX's drift markers
    assert tmetrics.metric_table_markdown().splitlines() == rows


def test_plane_rejects_unregistered_and_wrong_kind():
    """Mirrors test_plane_rejects_unregistered_and_wrong_kind."""
    def scenario(side):
        plane = side.MetricsPlane(enabled=True, clock=lambda: 0.0)
        return [_raises(lambda: plane.inc("accelerate_tpu_not_a_metric_total")),
                _raises(lambda: plane.inc(side.m.M_QUEUE_DEPTH)),
                _raises(lambda: plane.set_gauge(side.m.M_FAULTS_TOTAL, 1.0))]

    got = both(scenario)
    assert [g[0] for g in got] == ["KeyError", "ValueError", "ValueError"]
    assert "unregistered metric" in got[0][1] and "gauge" in got[1][1]


# ------------------------------------------------------------- disabled contract
def test_disabled_plane_zero_clock_calls_no_sink():
    """Mirrors test_disabled_plane_zero_clock_calls_no_sink."""
    tel_off = ttel.Telemetry(tdc.TelemetryConfig())
    assert tel_off.enabled is False
    calls = []

    def counting_clock():
        calls.append(1)
        return 0.0

    plane = tmetrics.MetricsPlane(tel_off, clock=counting_clock)
    assert plane.enabled is False and tel_off.sinks == []
    plane.inc(tmetrics.M_FAULTS_TOTAL, site="x")
    plane.set_gauge(tmetrics.M_QUEUE_DEPTH, 3)
    plane.observe(tmetrics.M_TTFT_SECONDS, 0.5)
    plane.consume(_request_record(PORT, 0))
    assert calls == [] and plane.records_consumed == 0
    assert plane.stats() == {"enabled": False}
    eng = talerts.AlertEngine(plane, talerts.default_alert_rules())
    assert plane.alert_engines == [] and eng.active() == [] and calls == []


# ------------------------------------------------------------------ aggregation
def test_plane_windows_counters_gauges():
    """Mirrors test_plane_windows_counters_gauges; the stats and the Prometheus text at
    both instants equal JAX's byte for byte."""
    def scenario(side):
        t = [0.0]
        tel = _tel(side)
        plane = side.MetricsPlane(tel, clock=lambda: t[0], window_s=10.0)
        for i in range(5):
            t[0] = float(i)
            tel.emit(_request_record(side, i, ttft=0.1 * (i + 1)))
        early = (plane.stats(), side.prometheus_text(plane))
        t[0] = 100.0
        return {"early": early, "late": (plane.stats(), side.prometheus_text(plane)),
                "increase": plane.window_increase(side.m.M_REQUESTS_TOTAL, 10.0),
                "attainment": plane.attainment()}

    got = both(scenario)
    stats = got["early"][0]
    done = f'{tmetrics.M_REQUESTS_TOTAL}{{status="done"}}'
    assert stats["counters"][done] == 5
    assert stats["slo"] == {"window_good": 5, "window_bad": 0, "attainment": 1.0}
    hist = stats["histograms"]["accelerate_tpu_gateway_ttft_seconds"]
    assert hist["count"] == 5 and hist["p50"] == pytest.approx(0.3)
    late = got["late"][0]
    assert late["counters"][done] == 5
    assert late["histograms"]["accelerate_tpu_gateway_ttft_seconds"] == {"count": 0}
    assert got["increase"] == 0 and got["attainment"] is None


def test_plane_labeled_gauges_and_serving_records():
    """Mirrors test_plane_labeled_gauges_and_serving_records."""
    def scenario(side):
        tel = _tel(side)
        plane = side.MetricsPlane(tel, clock=lambda: 0.0)
        tel.emit({"schema": side.s.SERVING_SCHEMA, "telemetry_rev": 2, "queued": 7,
                  "active_slots": 2, "max_slots": 4, "slot_occupancy": 0.5,
                  "admitted": 2, "evicted": 0, "decode_steps": 1, "decode_tokens": 2})
        queue = plane.gauge_value(side.m.M_QUEUE_DEPTH)
        for rid, health, slots, queued, fails in ((0, 0.9, 1, 0, 0), (1, 0.4, 2, 3, 1)):
            tel.emit({"schema": HEALTH, "replica": rid, "state": "active",
                      "role": "mixed", "health": health, "breaker_state": "closed",
                      "active_slots": slots, "queued": queued, "step_failures": fails})
        return queue, plane.gauge_value(side.m.M_REPLICA_HEALTH), plane.stats()

    queue, per_replica, _ = both(scenario)
    assert queue == 7
    assert per_replica == {'accelerate_tpu_replica_health{replica="0"}': 0.9,
                           'accelerate_tpu_replica_health{replica="1"}': 0.4}


# ----------------------------------------------------------------------- alerts
def test_alert_rule_validation():
    """Mirrors test_alert_rule_validation: the same refusals with the same messages."""
    def scenario(side):
        R, m = side.AlertRule, side.m
        cases = [
            lambda: R("x", metric="accelerate_tpu_nope", threshold=1),
            lambda: R("x", metric=m.M_TTFT_SECONDS, threshold=1),
            lambda: R("x"),
            lambda: R("x", kind="burn_rate", fast_window_s=300, slow_window_s=60),
            lambda: R("x", kind="burn_rate", objective=1.5),
            lambda: side.AlertEngine(side.MetricsPlane(enabled=True, clock=lambda: 0.0),
                                     [R("a", metric=m.M_QUEUE_DEPTH, threshold=1),
                                      R("a", metric=m.M_QUEUE_DEPTH, threshold=2)]),
            lambda: R("x", kind="sustained_low"),
            lambda: R("x", kind="sustained_low", metric=m.M_REPLICA_ACTIVE_SLOTS,
                      threshold=2.0, clear_threshold=1.0),
            lambda: R("x", kind="sustained_low", metric=m.M_REPLICA_ACTIVE_SLOTS,
                      threshold=2.0, window_s=0.0),
            lambda: R("x", kind="sustained_low", metric=m.M_REPLICA_ACTIVE_SLOTS,
                      threshold=2.0, reduce="mean"),
        ]
        return [_raises(c) for c in cases]

    got = both(scenario)
    assert all(g is not None and g[0] == "ValueError" for g in got)
    for g, needle in zip(got, ("unregistered metric", "histogram", "name a metric",
                               "multiwindow", "objective", "duplicate", "name a metric",
                               "clear_threshold", "window_s", "reduce")):
        assert needle in g[1]


def test_threshold_rules_fire_and_resolve():
    """Mirrors test_threshold_rules_fire_and_resolve; the transitions equal JAX's."""
    def scenario(side):
        t = [0.0]
        tel = _tel(side)
        plane = side.MetricsPlane(tel, clock=lambda: t[0], window_s=100.0)
        m = side.m
        engine = side.AlertEngine(plane, [
            side.AlertRule("queue-deep", metric=m.M_QUEUE_DEPTH, threshold=5.0),
            side.AlertRule("faults", metric=m.M_FAULTS_TOTAL, threshold=0.0,
                           window_s=10.0),
            side.AlertRule("replica-low", metric=m.M_REPLICA_HEALTH, op="<",
                           threshold=0.5),
        ], eval_interval_s=0.0)
        states = []
        tel.emit({"schema": side.s.SERVING_SCHEMA, "queued": 9, "slot_occupancy": 1.0})
        states.append(dict(engine.states))
        tel.emit({"schema": side.s.SERVING_SCHEMA, "queued": 1, "slot_occupancy": 0.2})
        states.append(dict(engine.states))
        t[0] = 1.0
        tel.emit({"schema": side.s.FAULT_SCHEMA, "site": "serving.decode", "kind": "error"})
        states.append(dict(engine.states))
        t[0] = 50.0
        engine.evaluate()
        states.append(dict(engine.states))
        for rid, state, health in ((0, "active", 0.9), (1, "restarting", 0.0)):
            tel.emit({"schema": HEALTH, "replica": rid, "state": state, "role": "mixed",
                      "health": health, "breaker_state": "closed", "active_slots": 0,
                      "queued": 0, "step_failures": 0})
        states.append(dict(engine.states))
        return {"states": states, "fired": list(engine.fired),
                "valid": [side.s.validate_record(r) for r in engine.fired],
                "mirrored": plane.counter_value("accelerate_tpu_alerts_total",
                                                rule="queue-deep", state="firing"),
                "text": side.prometheus_text(plane)}

    got = both(scenario)
    s = got["states"]
    assert s[0]["queue-deep"] == "firing" and s[1]["queue-deep"] == "ok"
    assert s[2]["faults"] == "firing" and s[3]["faults"] == "ok"
    assert s[4]["replica-low"] == "firing"
    assert all(v == [] for v in got["valid"]) and got["mirrored"] == 1


def test_burn_rate_multiwindow_semantics():
    """Mirrors test_burn_rate_multiwindow_semantics; the states, error rates and
    transitions equal JAX's."""
    def scenario(side):
        t = [0.0]
        tel = _tel(side)
        plane = side.MetricsPlane(tel, clock=lambda: t[0], window_s=400.0)
        rule = side.AlertRule("burn", kind="burn_rate", objective=0.9, fast_window_s=30.0,
                              slow_window_s=300.0, burn_threshold=2.0)
        engine = side.AlertEngine(plane, [rule], eval_interval_s=0.0)
        out = []
        for i in range(60):
            t[0] = float(i)
            tel.emit(_request_record(side, i))
        out.append(engine.states["burn"])
        for i in range(8):
            t[0] = 60.0 + i
            tel.emit(_request_record(side, 100 + i, status="failed", tokens=0, ttft=None))
        out.append((plane.error_rate(30.0), plane.error_rate(300.0), engine.states["burn"]))
        for i in range(20):
            t[0] = 70.0 + i * 3
            tel.emit(_request_record(side, 200 + i, status="failed", tokens=0, ttft=None))
        out.append(engine.states["burn"])
        for i in range(20):
            t[0] = 140.0 + i
            tel.emit(_request_record(side, 300 + i))
        out.append((plane.error_rate(300.0), engine.states["burn"]))
        return out, list(engine.fired)

    (healthy, blip, burning, recovered), _ = both(scenario)
    assert healthy == "ok"
    assert blip[0] > 0.2 and blip[1] < 0.2 and blip[2] == "ok"
    assert burning == "firing"
    assert recovered[0] > 0.2 and recovered[1] == "ok"


def test_sustained_low_hysteresis_fire_clear_refire():
    """Mirrors test_sustained_low_hysteresis_fire_clear_refire."""
    def scenario(side):
        t = [0.0]
        tel = _tel(side)
        plane = side.MetricsPlane(tel, clock=lambda: t[0], window_s=100.0)
        rule = side.AlertRule("idle", kind="sustained_low",
                              metric=side.m.M_REPLICA_ACTIVE_SLOTS, threshold=2.0,
                              clear_threshold=3.0, window_s=10.0, reduce="sum")
        engine = side.AlertEngine(plane, [rule], eval_interval_s=0.0)
        states = []
        for now, (r0, r1) in ((0.0, (0, 1)), (5.0, (0, 0)), (10.0, (0, 1)), (12.0, (1, 1)),
                              (14.0, (2, 1)), (15.0, (0, 0)), (20.0, (0, 1)),
                              (25.0, (0, 0))):
            t[0] = now
            for rid, slots in ((0, r0), (1, r1)):
                tel.emit({"schema": HEALTH, "replica": rid, "state": "active",
                          "role": "mixed", "health": 1.0, "breaker_state": "closed",
                          "active_slots": slots, "queued": 0, "step_failures": 0})
            states.append(engine.states["idle"])
        return states, list(engine.fired)

    states, fired = both(scenario)
    assert states == ["ok", "ok", "firing", "firing", "ok", "ok", "ok", "firing"]
    assert [r["state"] for r in fired if r["rule"] == "idle"] == \
        ["firing", "resolved", "firing"]
    assert all(tschemas.validate_record(r) == [] for r in fired)


def test_threshold_rules_on_derived_gauges_fire():
    """Mirrors test_threshold_rules_on_derived_gauges_fire."""
    def scenario(side):
        t = [0.0]
        tel = _tel(side)
        plane = side.MetricsPlane(tel, clock=lambda: t[0], window_s=100.0)
        engine = side.AlertEngine(plane, [
            side.AlertRule("attainment-low", metric=side.m.M_SLO_ATTAINMENT, op="<",
                           threshold=0.9),
            side.AlertRule("bad-requests", metric=side.m.M_SLO_WINDOW_BAD, threshold=2.0),
        ], eval_interval_s=0.0)
        before = plane.gauge_value(side.m.M_SLO_ATTAINMENT)
        for i in range(4):
            t[0] = float(i)
            tel.emit(_request_record(side, i))
        quiet = engine.active()
        for i in range(6):
            t[0] = 4.0 + i
            tel.emit(_request_record(side, 100 + i, status="failed", tokens=0, ttft=None))
        return (before, quiet, plane.gauge_value(side.m.M_SLO_ATTAINMENT),
                plane.gauge_value(side.m.M_SLO_WINDOW_BAD), sorted(engine.active()))

    before, quiet, attainment, bad, active = both(scenario)
    assert before is None and quiet == []
    assert attainment == pytest.approx(0.4) and bad == 6.0
    assert active == ["attainment-low", "bad-requests"]


def test_jsonl_rotation_indices_stay_monotonic(tmp_path):
    """Mirrors test_jsonl_rotation_indices_stay_monotonic: the port's files roll as
    JAX's do (the same names for the same stream)."""
    def scenario(side):
        jsonl_dir = str(tmp_path / ("jax" if side is JAX else "port"))
        tel = _tel(side, jsonl_dir=jsonl_dir, rotate_bytes=200)
        for i in range(6):
            tel.emit(_request_record(side, i))
        first = sorted(f for f in os.listdir(jsonl_dir) if f != "telemetry.jsonl")
        os.remove(os.path.join(jsonl_dir, first[0]))
        for i in range(6):
            tel.emit(_request_record(side, 100 + i))
        tel.close()
        return first, sorted(f for f in os.listdir(jsonl_dir) if f != "telemetry.jsonl")

    first, rolled = both(scenario)
    assert len(first) >= 2 and first[0] not in rolled
    indices = [int(f.split(".")[1]) for f in rolled]
    assert indices == sorted(indices) and len(set(indices)) == len(indices)
    assert max(indices) > int(first[-1].split(".")[1])


# ------------------------------------------------------------ engine-level planes
def _gateway_run(side, setup, prompts, tel, n_new=4, metrics=True):
    """A gateway with the metrics plane over a paged engine of the side's framework,
    on a manual clock that advances 1 s a step → (gateway, clock)."""
    jparams, tparams, _ = setup
    t = [0.0]
    if side is JAX:
        eng = JaxBatcher(jparams, JCFG, telemetry=tel, **ENGINE)
        gw = JaxGateway(eng, jdc.GatewayConfig(enabled=True, metrics=metrics),
                        telemetry=tel, clock=lambda: t[0])
    else:
        eng = ContinuousBatcher(tparams, TCFG, telemetry=tel, **ENGINE)
        gw = ServingGateway(eng, tdc.GatewayConfig(enabled=True, metrics=metrics),
                            telemetry=tel, clock=lambda: t[0])
    for p in prompts:
        gw.submit(p, max_new_tokens=n_new)
    while gw.queue_depth or gw.running_count:
        gw.step()
        t[0] += 1.0
    gw.emit_slo_record()
    return gw, t


def test_prometheus_scrape_matches_stats_to_the_digit(setup):
    """Mirrors test_prometheus_scrape_matches_stats_to_the_digit: one HTTP scrape of the
    port's exporter on 127.0.0.1 equals ``stats()`` to the digit; the plane over the
    port's engine and gateway equals the plane over JAX's (stats and text) on the same
    manual clock."""
    def scenario(side):
        gw, t = _gateway_run(side, setup, setup[2][:4], _tel(side))
        return gw.metrics.stats(), side.prometheus_text(gw.metrics)

    stats, text = both(scenario)
    assert stats["counters"][f'{tmetrics.M_REQUESTS_TOTAL}{{status="done"}}'] == 4

    gw, _ = _gateway_run(PORT, setup, setup[2][:4], _tel(PORT))
    assert gw.metrics is not None and gw.metrics.enabled
    stats = gw.stats()["metrics"]
    exporter = texp.MetricsExporter(gw.metrics, port=0)
    with exporter:
        url = f"http://127.0.0.1:{exporter.port}"
        body = urllib.request.urlopen(f"{url}/metrics").read().decode()
        health = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
    assert health["ok"] and health["records_consumed"] > 0
    parsed = {}
    for line in body.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        series, value = line.rsplit(" ", 1)
        parsed[series] = float(value)
    for table in ("counters", "gauges"):
        for series, value in stats[table].items():
            if value is None:
                continue
            assert parsed[series] == float(value), series
    text2 = texp.prometheus_text(gw.metrics, now=0.0)
    for series, block in gw.metrics.stats(now=0.0)["histograms"].items():
        if not block.get("count"):
            continue
        name = series.split("{", 1)[0]
        for q, p in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            assert f'{name}{{quantile="{q}"}} {repr(float(block[p]))}' in text2


def test_metrics_dump_offline_equals_live(setup, tmp_path):
    """Mirrors test_metrics_dump_offline_equals_live: the port's recorded JSONL (rotated,
    one file gzipped) re-aggregated offline gives the live plane's counters; and the
    offline stats equal JAX's ``aggregate_records`` over the same records."""
    from accelerate_tpu.commands.metrics_dump import aggregate_records as jax_aggregate
    from accelerate_tpu_torch.commands.metrics_dump import aggregate_records
    from accelerate_tpu_torch.commands.trace_report import load_records

    jsonl_dir = str(tmp_path / "run")
    tel = _tel(PORT, jsonl_dir=jsonl_dir, rotate_bytes=2048)
    gw, _ = _gateway_run(PORT, setup, setup[2], tel)
    rotated = [f for f in os.listdir(jsonl_dir)
               if f.startswith("telemetry.") and f != "telemetry.jsonl"]
    assert rotated, "rotation never fired — shrink rotate_bytes"
    victim = os.path.join(jsonl_dir, sorted(rotated)[0])
    with open(victim, "rb") as f:
        blob = f.read()
    with gzip.open(victim + ".gz", "wb") as f:
        f.write(blob)
    os.remove(victim)
    records = load_records(jsonl_dir)
    assert len(records) == len(tel.records)
    offline = aggregate_records(records)
    assert offline.stats()["counters"] == gw.metrics.stats()["counters"]
    assert offline.stats() == jax_aggregate(records).stats()
    assert texp.prometheus_text(offline) == jexp.prometheus_text(jax_aggregate(records))


def test_metrics_dump_cli_smoke(capsys):
    """Mirrors test_metrics_dump_cli_smoke: the port's ``--smoke`` over its own engine
    (on the CPU here) reconciles and exits 0."""
    from accelerate_tpu_torch.commands.metrics_dump import main

    assert main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "accelerate_tpu_gateway_requests_total" in out and "SMOKE FAILURE" not in out


def test_metrics_dump_cli_on_files(tmp_path, capsys):
    """Mirrors test_metrics_dump_cli_on_files; both CLIs print the same JSON and the
    same Prometheus text for one file."""
    from accelerate_tpu.commands.metrics_dump import (metrics_dump_command as jax_cmd,
                                                      metrics_dump_command_parser as jax_parser)
    from accelerate_tpu_torch.commands.metrics_dump import main

    path = tmp_path / "t.jsonl"
    with open(path, "w") as f:
        for i in range(3):
            f.write(json.dumps(_request_record(PORT, i)) + "\n")
    outs = {}
    for fmt in ("json", "prometheus"):
        assert main([str(path), "--format", fmt]) == 0
        port = capsys.readouterr().out
        assert jax_cmd(jax_parser().parse_args([str(path), "--format", fmt])) == 0
        assert port == capsys.readouterr().out
        outs[fmt] = port
    stats = json.loads(outs["json"])
    assert stats["counters"][f'{tmetrics.M_REQUESTS_TOTAL}{{status="done"}}'] == 3
    assert main([]) == 1


# --------------------------------------------------------- gateway/bench wiring
def test_gateway_metrics_knob_off_and_disabled_telemetry(setup):
    """Mirrors test_gateway_metrics_knob_off_and_disabled_telemetry."""
    eng = ContinuousBatcher(setup[1], TCFG, max_slots=2, max_len=64, prompt_bucket=16)
    gw = ServingGateway(eng, tdc.GatewayConfig(enabled=True))
    assert gw.metrics is None and "metrics" not in gw.stats()
    gw2 = ServingGateway(eng, tdc.GatewayConfig(enabled=True, metrics=True),
                         telemetry=ttel.Telemetry(tdc.TelemetryConfig()))
    assert gw2.metrics is None
    with pytest.raises(ValueError, match="metrics_window_s"):
        tdc.GatewayConfig(enabled=True, metrics_window_s=0.0)


@pytest.fixture(scope="module")
def chaos_artifacts(setup):
    """``run_chaos_bench`` at the JAX test's arguments through both packages (the port's
    over the JAX weights, on the CPU)."""
    from accelerate_tpu.commands.serve_bench import run_chaos_bench as jax_chaos
    from accelerate_tpu.compile_cache.warmup import build_model_config
    from accelerate_tpu_torch.commands.serve_bench import _model, run_chaos_bench

    kw = dict(requests=12, max_slots=2, max_len=64, prompt_bucket=16, chaos_rate=0.15,
              seed=0)
    cfg, _ = _model("smoke", 64, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jl.init_params(build_model_config("smoke", 64))),
                             cfg, device="cpu")
    return jax_chaos(**kw), run_chaos_bench(**kw, device="cpu", params=params)


def test_chaos_bench_alert_invariants(chaos_artifacts):
    """Mirrors test_chaos_bench_alert_invariants on the port's artifact; its alert and
    plane blocks equal JAX's."""
    want, artifact = chaos_artifacts
    assert artifact["alerts_clean_silent"] is True
    assert artifact["alerts_chaos_expected"] is True
    assert "step-failure-burst" in artifact["alerts_chaos_fired"]
    assert artifact["clean"]["alerts"]["transitions"] == 0
    chaos_alerts = artifact["chaos"]["alerts"]
    assert chaos_alerts["transitions"] >= 1
    for fired in chaos_alerts["fired"]:
        assert fired["rule"] in {r.name for r in talerts.default_alert_rules()}
    faults = [v for k, v in artifact["chaos"]["metrics"]["counters"].items()
              if k.startswith(tmetrics.M_FAULTS_TOTAL)]
    assert sum(faults) == artifact["fault_plan"]["fired"]
    for arm in ("clean", "chaos"):
        assert artifact[arm]["alerts"] == want[arm]["alerts"]
        assert artifact[arm]["metrics"] == want[arm]["metrics"]
    assert artifact["alerts_chaos_fired"] == want["alerts_chaos_fired"]


# ------------------------------------------------------------- coverage matrix
@pytest.fixture(scope="module")
def record_corpus(setup, tmp_path_factory):
    """Real records of every schema the port registers, each from its real emitter
    (mirrors tests/test_metrics.py's ``record_corpus`` for the port's 18 schemas)."""
    from accelerate_tpu_torch.resilience.faults import FaultPlan, FaultSpec
    from accelerate_tpu_torch.serving_gateway import Autoscaler, DisaggRouter, FleetRouter

    _, tparams, prompts = setup
    capsules = str(tmp_path_factory.mktemp("capsules"))
    tel = _tel(PORT, recorder=True, capsule_dir=capsules)
    plane = tmetrics.MetricsPlane(tel, window_s=1e9)
    talerts.AlertEngine(plane, talerts.default_alert_rules(objective=0.9,
                                                           burn_threshold=3.0),
                        eval_interval_s=0.0)
    tel._step_begin()
    tel._step_end(fence_on=torch.zeros(()))
    tracer = ttel.Tracer(tel)
    plan = FaultPlan([FaultSpec("serving.decode", "error", prob=1.0, max_fires=1)], seed=0)
    eng = ContinuousBatcher(tparams, TCFG, max_slots=2, max_len=64, prompt_bucket=16,
                            page_size=8, spec_k=2, telemetry=tel, tracer=tracer, faults=plan)
    gw = ServingGateway(eng, tdc.GatewayConfig(enabled=True), telemetry=tel, tracer=tracer)
    for p in prompts[:4]:
        gw.submit(p, max_new_tokens=4)
    gw.run(report_slo=True)
    eng2 = ContinuousBatcher(tparams, TCFG, max_slots=2, max_len=64, prompt_bucket=16,
                             telemetry=tel)
    eng2.submit(prompts[0], max_new_tokens=3)
    eng2.run(report_throughput=True)

    def build_engine(rid):
        return ContinuousBatcher(tparams, TCFG, max_slots=2, max_len=64, prompt_bucket=16,
                                 telemetry=tel)

    router = FleetRouter([build_engine(0), build_engine(1)],
                         tdc.GatewayConfig(enabled=True, breaker_threshold=3,
                                           replica_restarts=2),
                         telemetry=tel, engine_factory=build_engine)
    for p in prompts[:4]:
        router.submit(p, max_new_tokens=4)
    router.step()
    router.kill(0)
    router.run()
    scaler = Autoscaler(router, min_replicas=1, max_replicas=3, cooldown_s=0.0,
                        predictive=False, queue_backlog_per_replica=1.0)
    for p in prompts[:6]:
        router.submit(p, max_new_tokens=3)
    scaler.poll()
    assert scaler.events, "backlog did not trigger a scale-up"
    router.run()

    def role_engine(rid, role):
        return ContinuousBatcher(tparams, TCFG, role=role, max_slots=2, max_len=64,
                                 prompt_bucket=16, page_size=8, telemetry=tel)

    disagg = DisaggRouter([role_engine(0, "prefill"), role_engine(1, "decode")],
                          tdc.GatewayConfig(enabled=True), telemetry=tel,
                          roles=["prefill", "decode"])
    disagg.submit(prompts[0], max_new_tokens=4)
    disagg.run()
    plane.snapshot_record(emit=True)
    return tel.records


def test_registry_coverage_matrix(record_corpus):
    """Mirrors test_registry_coverage_matrix over the port's registry: every schema it
    registers has a real emitted record, each record validates, and each registration's
    required keys equal JAX's."""
    by_schema = {}
    for rec in record_corpus:
        by_schema.setdefault(rec.get("schema"), []).append(rec)
    missing = sorted(set(tschemas.SCHEMA_REGISTRY) - set(by_schema))
    assert not missing, f"schemas with no real emitted record: {missing}"
    for schema, recs in by_schema.items():
        assert schema in tschemas.SCHEMA_REGISTRY, schema
        for rec in recs:
            assert tschemas.validate_record(rec) == [], (schema, rec)
    for schema, reg in tschemas.SCHEMA_REGISTRY.items():
        assert reg.required == jschemas.SCHEMA_REGISTRY[schema].required, schema
    assert len(tschemas.SCHEMA_REGISTRY) == 18
