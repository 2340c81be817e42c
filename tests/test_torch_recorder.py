"""The port's flight recorder, trace sampling, incident capsules and capsule-report
against the JAX package's, on the CPU.

The recorder, the tracer and capsule-report are stdlib-only in both packages: the same
record stream under a manual clock goes through the JAX objects and the port's, and the
results are compared EXACTLY (rings, drop counts, sampling decisions, promoted spans,
capsules equal apart from the provenance block, which stamps each framework's own
runtime). Each test mirrors the test of ``tests/test_recorder.py`` named in its
docstring and keeps that test's assertions on the port's side. The engine-level tests
run the port's ``ContinuousBatcher`` (``tiny`` at fp32, the JAX weights through
``params_from_jax``) on a virtual clock beside the JAX engine.
"""

import dataclasses
import json
import os
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerate_tpu.commands.capsule_report as jcr
import accelerate_tpu.commands.trace_report as jtr
import accelerate_tpu.resilience.faults as jfaults
import accelerate_tpu.serving_gateway as jgw
import accelerate_tpu.telemetry as jtel
import accelerate_tpu.telemetry.metrics as jmetrics
import accelerate_tpu.telemetry.recorder as jrec
import accelerate_tpu.telemetry.schemas as jschemas
import accelerate_tpu.utils.dataclasses as jdc
import accelerate_tpu_torch.commands.capsule_report as tcr
import accelerate_tpu_torch.commands.trace_report as ttr
import accelerate_tpu_torch.resilience.faults as tfaults
import accelerate_tpu_torch.serving_gateway as tgw
import accelerate_tpu_torch.telemetry as ttel
import accelerate_tpu_torch.telemetry.metrics as tmetrics
import accelerate_tpu_torch.telemetry.recorder as trec
import accelerate_tpu_torch.telemetry.schemas as tschemas
import accelerate_tpu_torch.utils.dataclasses as tdc
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import ContinuousBatcher

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)


def _side(tel, rec, metrics, schemas, gw, faults, dc, tr, cr):
    return types.SimpleNamespace(
        Telemetry=tel.Telemetry, Tracer=tel.Tracer, FlightRecorder=rec.FlightRecorder,
        load_capsule=rec.load_capsule, list_capsules=rec.list_capsules,
        MetricsPlane=metrics.MetricsPlane, m=metrics, s=schemas,
        ServingGateway=gw.ServingGateway, VirtualClock=gw.VirtualClock,
        generate_workload=gw.generate_workload, replay_trace=gw.replay_trace,
        FaultPlan=faults.FaultPlan, FaultSpec=faults.FaultSpec,
        GatewayConfig=dc.GatewayConfig, TelemetryConfig=dc.TelemetryConfig, tr=tr, cr=cr)


JAX = _side(jtel, jrec, jmetrics, jschemas, jgw, jfaults, jdc, jtr, jcr)
PORT = _side(ttel, trec, tmetrics, tschemas, tgw, tfaults, tdc, ttr, tcr)


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
               for n in (5, 9, 3, 7)]
    return jparams, tparams, prompts


def _engine(side, setup, **kw):
    jparams, tparams, _ = setup
    if side is JAX:
        return JaxBatcher(jparams, JCFG, **kw)
    return ContinuousBatcher(tparams, TCFG, **kw)


def _tel(side, **kw):
    return side.Telemetry(side.TelemetryConfig(enabled=True, compile_events=False,
                                               memory_stats=False, **kw))


def _alert(rule, state="firing", t=0.0):
    return {"schema": "accelerate_tpu.telemetry.alert/v1", "rule": rule, "state": state,
            "severity": "page", "kind": "burn_rate", "t": t, "value": 1.0}


def _recovery(reason, t):
    return {"schema": "accelerate_tpu.telemetry.recovery/v1", "action": "rebuild",
            "reason": reason, "t": t}


def _strip(capsule):
    """A loaded capsule without its location and its provenance (each framework stamps
    its own runtime there)."""
    manifest = {k: v for k, v in capsule["manifest"].items() if k != "provenance"}
    ring = [{k: v for k, v in r.items() if k != "provenance"} for r in capsule["ring"]]
    return {"manifest": manifest, "ring": ring, "state": capsule["state"],
            "name": os.path.basename(capsule["path"])}


def both(scenario, tmp_path=None):
    """``scenario(side[, dir])`` through the JAX objects and the port's: equal
    results. Returns the port's."""
    if tmp_path is None:
        want, got = scenario(JAX), scenario(PORT)
    else:
        want, got = scenario(JAX, tmp_path / "jax"), scenario(PORT, tmp_path / "port")
    assert got == want
    return got


# --------------------------------------------------------------- zero overhead
def test_disabled_recorder_zero_clock_calls():
    """Mirrors test_disabled_recorder_zero_clock_calls."""
    tel_off = ttel.Telemetry(tdc.TelemetryConfig())
    assert tel_off.recorder is None
    calls = []

    def counting_clock():
        calls.append(1)
        return 0.0

    rec = trec.FlightRecorder(telemetry=tel_off, clock=counting_clock,
                              capsule_dir="/nonexistent")
    assert rec.enabled is False and rec._consume not in tel_off.sinks
    rec.buffer({"schema": tschemas.TRACE_SPAN_SCHEMA, "trace_id": "x"})
    rec.add_state_provider("g", dict)
    assert rec.capture("fault:x") is None and rec.promote("x") == 0
    assert calls == [] and len(rec.ring) == 0 and rec.records_seen == 0


def test_disabled_sampler_zero_clock_calls():
    """Mirrors test_disabled_sampler_zero_clock_calls."""
    tel_off = ttel.Telemetry(tdc.TelemetryConfig(trace_sample_every=4,
                                                 trace_sample_seed=7))
    calls = []
    tracer = ttel.Tracer(tel_off, clock=lambda: calls.append(1) or 0.0)
    assert tracer.enabled is False and tracer.start(0) is None
    tracer.span(None, "queue", 0.0, 1.0)
    tracer.promote(None)
    assert calls == [] and tracer.traces_started == 0


def test_head_sampling_every_kth_and_seeded_prob():
    """Mirrors test_head_sampling_every_kth_and_seeded_prob; the decisions equal JAX's
    for the same seed."""
    def scenario(side):
        calls = []
        tracer = side.Tracer(sink=lambda r: None, clock=lambda: calls.append(1) or 0.0,
                             sample_every=3)
        every = [tracer.start(i, t=float(i)).sampled for i in range(9)]
        a = side.Tracer(sink=lambda r: None, sample_every=1, sample_prob=0.5,
                        sample_seed=42)
        prob = [a.start(i, t=0.0).sampled for i in range(64)]
        return every, (tracer.traces_started, tracer.traces_sampled), calls, prob

    every, counts, calls, prob = both(scenario)
    assert every == [True, False, False] * 3 and counts == (9, 3) and calls == []
    b = ttel.Tracer(sink=lambda r: None, sample_every=1, sample_prob=0.5, sample_seed=42)
    assert [b.start(i, t=0.0).sampled for i in range(64)] == prob
    assert True in prob and False in prob


def test_sampling_config_resolves_from_telemetry(tmp_path):
    """Mirrors test_sampling_config_resolves_from_telemetry: ``TelemetryConfig.recorder``
    builds the port's recorder and the tracer buffers into it."""
    tel = _tel(PORT, recorder=True, capsule_dir=str(tmp_path / "caps"),
               trace_sample_every=5, trace_sample_seed=3)
    tracer = ttel.Tracer(tel)
    assert isinstance(tel.recorder, trec.FlightRecorder) and tel.recorder.enabled
    assert tracer.sample_every == 5 and tracer.recorder is tel.recorder
    assert os.path.isdir(str(tmp_path / "caps"))


# ----------------------------------------------------------- ring + drop metric
def test_ring_drop_accounting():
    """Mirrors test_ring_drop_accounting; ring, stats and plane equal JAX's."""
    def scenario(side):
        tel = _tel(side)
        plane = side.MetricsPlane(enabled=True, clock=lambda: 0.0)
        rec = side.FlightRecorder(telemetry=tel, ring_size=4, snapshot_every=0,
                                  metrics=plane)
        for i in range(10):
            tel.emit(_recovery(f"r{i}", float(i)))
        return list(rec.ring), rec.records_seen, rec.dropped, rec.stats(), plane.stats()

    ring, seen, dropped, stats, plane = both(scenario)
    assert len(ring) == 4 and seen == 10 and dropped == 6 and stats["dropped"] == 6
    assert plane["counters"][tmetrics.M_RECORDER_DROPPED_TOTAL] == 6


# ------------------------------------------------------------- tail promotion
def test_tail_promotion_ttft_parity_and_silent_happy_path(tmp_path, setup):
    """Mirrors test_tail_promotion_ttft_parity_and_silent_happy_path over the port's
    engine and gateway on a virtual clock; the JSONL span stream (promoted spans
    only) and the request endings equal the JAX engine's."""
    def scenario(side, root):
        jdir = str(root / "run")
        tel = _tel(side, jsonl_dir=jdir, recorder=True, capsule_dir=str(root / "caps"),
                   trace_sample_prob=0.0)
        clock = side.VirtualClock()
        tracer = side.Tracer(tel, clock=clock)
        eng = _engine(side, setup, max_slots=2, max_len=64, prompt_bucket=16,
                      tracer=tracer)
        gw = side.ServingGateway(
            eng, side.GatewayConfig(enabled=True, policy="edf", max_queue=8,
                                    overload="shed"),
            telemetry=tel, clock=clock, tracer=tracer)
        trace = side.generate_workload("tenant_flood", 24, seed=3, mean_iat_s=3.0)
        greqs = side.replay_trace(gw, trace, JCFG.vocab_size, clock, seed=3, load=4.0)
        rng = np.random.default_rng(9)
        breached = gw.submit(rng.integers(1, JCFG.vocab_size, 6).astype(np.int32),
                             max_new_tokens=20, deadline_s=5.0)
        late_happy = gw.submit(rng.integers(1, JCFG.vocab_size, 6).astype(np.int32),
                               max_new_tokens=3)
        gw.step()
        running = breached.status
        clock.advance(6.0)
        gw.run()
        greqs = list(greqs) + [breached, late_happy]
        tel.close()
        spans = [r for r in side.tr.load_records([jdir])
                 if r.get("schema") == "accelerate_tpu.telemetry.trace.span/v1"]
        # A trace id ends in a process-wide sequence number: compare by first sight.
        ids = {}
        spans = [{**s, "trace_id": ids.setdefault(s["trace_id"], len(ids))} for s in spans]
        return {"running": running,
                "ends": [(r.uid, r.status, r.reason, r.ttft_s, r.deadline_met,
                          list(map(int, r.tokens))) for r in greqs],
                "spans": spans, "buffered": tracer.spans_buffered,
                "promoted": tracer.traces_promoted}

    got = both(scenario, tmp_path)
    ends = {e[0]: e for e in got["ends"]}
    assert got["running"] == "running"
    breached, late_happy = got["ends"][-2], got["ends"][-1]
    assert breached[1] == "expired" and breached[3] is not None and late_happy[1] == "done"
    bad = {u for u, s, _, _, met, _ in got["ends"]
           if s in ("failed", "expired", "shed") or (s == "done" and met is False)}
    happy = {u for u, s, _, _, met, _ in got["ends"] if s == "done" and met is not False}
    assert bad and happy
    spans = got["spans"]
    assert spans and got["buffered"] > 0
    assert {s["uid"] for s in spans} <= bad and not ({s["uid"] for s in spans} & happy)
    assert got["promoted"] == len({s["trace_id"] for s in spans})
    by_uid = {}
    for s in spans:
        by_uid.setdefault(s["uid"], []).append(s)
    checked = 0
    for uid in bad:
        if uid not in by_uid or ends[uid][3] is None:
            continue
        rebuilt = ttr._reconstruct(by_uid[uid])
        assert round(rebuilt["ttft_s"], 6) == round(ends[uid][3], 6), uid
        assert rebuilt["status"] == ends[uid][1]
        checked += 1
    assert checked >= 1


# ------------------------------------------------------------------- capsules
def test_capsule_write_cooldown_and_atomicity(tmp_path):
    """Mirrors test_capsule_write_cooldown_and_atomicity; the capsules equal JAX's
    apart from provenance."""
    def scenario(side, root):
        caps = str(root / "caps")
        tel = _tel(side)
        t = [0.0]
        rec = side.FlightRecorder(telemetry=tel, ring_size=32, snapshot_every=0,
                                  clock=lambda: t[0], capsule_dir=caps,
                                  capsule_cooldown_s=30.0)
        rec.add_state_provider("table", lambda: {"lanes": [1, None]})
        rec.add_state_provider("broken", lambda: 1 / 0)
        tel.emit(_alert("slo-burn-rate", t=0.0))
        t[0] = 1.0
        tel.emit(_alert("slo-burn-rate", t=1.0))
        tel.emit(_alert("step-failure-burst", t=1.0))
        t[0] = 100.0
        tel.emit(_alert("slo-burn-rate", t=100.0))
        tel.emit(_alert("slo-burn-rate", state="resolved", t=100.0))
        paths = side.list_capsules(caps)
        cuts = [r for r in tel.records if r.get("schema") == side.s.CAPSULE_SCHEMA]
        return {"written": (rec.capsules_written, rec.capsules_suppressed),
                "tmp": [p for p in os.listdir(caps) if p.endswith(".tmp")],
                "single": side.list_capsules(paths[0]) == [paths[0]],
                "capsules": [_strip(side.load_capsule(p)) for p in paths],
                "cuts": len(cuts), "cuts_in_ring": any(r in rec.ring for r in cuts)}

    got = both(scenario, tmp_path)
    assert got["written"] == (3, 1) and len(got["capsules"]) == 3
    assert got["tmp"] == [] and got["single"]
    manifest = got["capsules"][0]["manifest"]
    assert tschemas.validate_record({**manifest, "provenance": {}}) == []
    assert manifest["trigger"] == "alert:slo-burn-rate"
    assert manifest["state_keys"] == ["broken", "table"]
    state = got["capsules"][0]["state"]
    assert state["table"] == {"lanes": [1, None]}
    assert "ZeroDivisionError" in state["broken"]["error"]
    assert got["capsules"][0]["ring"][-1]["rule"] == "slo-burn-rate"
    assert got["cuts"] == 3 and not got["cuts_in_ring"]
    prov = trec.load_capsule(trec.list_capsules(str(tmp_path / "port" / "caps"))[0])[
        "manifest"]["provenance"]
    assert set(prov) == {"git_commit", "torch", "cuda", "device"}
    assert prov["torch"] == torch.__version__ and prov["device"] == "cpu"


def test_rotation_recorder_interplay(tmp_path):
    """Mirrors test_rotation_recorder_interplay; the span stream and the capsule's ring
    spans equal JAX's."""
    def scenario(side, root):
        jdir, caps = str(root / "run"), str(root / "caps")
        tel = _tel(side, jsonl_dir=jdir, rotate_bytes=2048, recorder=True,
                   capsule_dir=caps, trace_sample_prob=0.0)
        tracer = side.Tracer(tel, clock=lambda: 0.0)
        handle = tracer.start(7, t=0.0)
        sampled = handle.sampled
        tracer.span(handle, "queue", 0.0, 1.0)
        tracer.span(handle, "prefill", 1.0, 2.0)
        for i in range(60):
            tel.emit(_recovery(f"filler-{i:04d}" + "x" * 40, float(i)))
        tel.emit(_alert("slo-burn-rate", t=60.0))
        promoted = tracer.promote(handle)
        tracer.span(handle, "terminal", 2.0, 3.0)
        tel.close()
        segments = sorted(f for f in os.listdir(jdir) if f.startswith("telemetry."))
        spans = [r for r in side.tr.load_records([jdir])
                 if r.get("schema") == "accelerate_tpu.telemetry.trace.span/v1"]
        capsule = side.load_capsule(side.list_capsules(caps)[0])
        ring_spans = [r for r in capsule["ring"]
                      if r.get("schema") == "accelerate_tpu.telemetry.trace.span/v1"]
        return {"sampled": sampled, "promoted": promoted, "segments": segments,
                "spans": [(s["span"], s["trace_id"] == handle.trace_id) for s in spans],
                "ring_spans": [s["span"] for s in ring_spans],
                "stats": tel.recorder.stats()["promoted_traces"]}

    got = both(scenario, tmp_path)
    assert got["sampled"] is False and got["promoted"] == 2 and len(got["segments"]) >= 3
    assert got["spans"] == [("queue", True), ("prefill", True), ("terminal", True)]
    assert got["ring_spans"] == ["queue", "prefill"] and got["stats"] == 1


def test_gateway_capsule_state_provider(tmp_path, setup):
    """Mirrors test_gateway_capsule_state_provider: an injected fault on the port's
    engine cuts a ``fault:serving.decode`` capsule carrying the gateway's state (lane
    table, fault firing log); the recorder is bound to the gateway's plane; the
    capsule's state and ring equal the JAX engine's."""
    def scenario(side, root):
        caps = str(root / "caps")
        tel = _tel(side, recorder=True, capsule_dir=caps)
        plan = side.FaultPlan([side.FaultSpec("serving.decode", "error", prob=1.0,
                                              max_fires=1)], seed=0)
        clock = side.VirtualClock()
        eng = _engine(side, setup, max_slots=2, max_len=64, prompt_bucket=16,
                      telemetry=tel, faults=plan)
        gw = side.ServingGateway(eng, side.GatewayConfig(enabled=True, metrics=True),
                                 telemetry=tel, clock=clock)
        for p in setup[2][:3]:
            gw.submit(p, max_new_tokens=4)
        while gw.queue_depth or gw.running_count:
            gw.step()
            clock.advance(1.0)
        paths = side.list_capsules(caps)
        fault_caps = [_strip(side.load_capsule(p)) for p in paths
                      if "fault-serving.decode" in p]
        gstate = fault_caps[0]["state"]["gateway"] if fault_caps else None
        return {"fired": len(plan.fired), "written": tel.recorder.capsules_written,
                "bound": tel.recorder.metrics is gw.metrics,
                "lanes": gstate and gstate["lanes"],
                "fired_sites": gstate and [f["site"] for f in gstate["faults"]["fired"]],
                "counters": gstate and {k: gstate[k] for k in ("queued", "running",
                                                               "submitted", "done")},
                "ring_schemas": [r["schema"] for r in fault_caps[0]["ring"]]
                if fault_caps else None}

    got = both(scenario, tmp_path)
    assert got["fired"] == 1 and got["written"] >= 1 and got["bound"]
    assert len(got["lanes"]) == 2 and got["fired_sites"][0] == "serving.decode"


def test_capsule_report_cli(tmp_path, capsys):
    """Mirrors test_capsule_report_cli; the port's ``--json`` document equals JAX's
    capsule-report over the same capsules, apart from paths and provenance."""
    def scenario(side, root):
        caps = str(root / "caps")
        tel = _tel(side)
        plane = side.MetricsPlane(enabled=True, clock=lambda: 0.0)
        rec = side.FlightRecorder(telemetry=tel, ring_size=64, snapshot_every=0,
                                  clock=lambda: 5.0, capsule_dir=caps, metrics=plane)
        plane.inc(side.m.M_RECORDER_DROPPED_TOTAL)
        rec._append(plane.snapshot_record(now=1.0))
        plane.inc(side.m.M_RECORDER_DROPPED_TOTAL)
        rec._append(plane.snapshot_record(now=3.0))
        tel.emit({"schema": "accelerate_tpu.telemetry.recovery/v1", "action": "quarantine",
                  "reason": "step_fault:error", "t": 4.0})
        tel.emit(_alert("step-failure-burst", t=5.0))
        assert side.cr.capsule_report_command(
            side.cr.capsule_report_command_parser().parse_args([caps])) == 0
        human = capsys.readouterr().out
        assert side.cr.capsule_report_command(
            side.cr.capsule_report_command_parser().parse_args([caps, "--json"])) == 0
        doc = json.loads(capsys.readouterr().out)
        for c in doc["capsules"]:
            c.pop("path")
            c.pop("provenance")
        return doc, ("recovery:quarantine" in human and "alert:step-failure-burst" in human)

    doc, human_ok = both(scenario, tmp_path)
    assert human_ok
    assert [c["trigger"] for c in doc["capsules"]] == ["recovery:quarantine",
                                                      "alert:step-failure-burst"]
    alert_cap = doc["capsules"][1]
    assert alert_cap["alerts_fired"] == ["step-failure-burst"]
    assert [e["event"] for e in alert_cap["timeline"]] == ["recovery", "alert"]
    assert alert_cap["deltas"]["window_s"] == 2.0
    assert alert_cap["deltas"]["counters"][tmetrics.M_RECORDER_DROPPED_TOTAL]["delta"] == 1
    assert tcr.main([str(tmp_path / "empty")]) == 1


# ------------------------------------------------------------- CLI json modes
def test_trace_report_pure_json_mode(tmp_path, capsys, setup):
    """Mirrors test_trace_report_pure_json_mode over the port's engine."""
    jdir = str(tmp_path / "run")
    tel = _tel(PORT, jsonl_dir=jdir)
    tracer = ttel.Tracer(tel)
    eng = _engine(PORT, setup, max_slots=2, max_len=64, prompt_bucket=16, tracer=tracer)
    gw = tgw.ServingGateway(eng, tdc.GatewayConfig(enabled=True), telemetry=tel,
                            tracer=tracer)
    done = [gw.submit(p, max_new_tokens=3) for p in setup[2][:2]]
    gw.run()
    tel.close()
    assert ttr.main([jdir, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["n_traces"] == 2 and doc["by_status"]["done"] == 2
    assert len(doc["traces"]) == 2
    assert ttr.main([jdir, "--json", "--uid", str(done[0].uid)]) == 0
    one = json.loads(capsys.readouterr().out)
    assert one["uid"] == done[0].uid and one["status"] == "done"


def test_metrics_dump_pure_json_modes(tmp_path, capsys):
    """Mirrors test_metrics_dump_pure_json_modes (the smoke over the port's engine on
    the CPU)."""
    from accelerate_tpu_torch.commands.metrics_dump import main

    path = tmp_path / "t.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({
            "schema": tschemas.GATEWAY_REQUEST_SCHEMA, "uid": 0, "status": "done",
            "reason": None, "tenant": "default", "priority": 0, "n_tokens": 4,
            "retries_used": 0, "queue_wait_s": 0.1, "ttft_s": 0.3, "tpot_s": 0.02,
            "deadline_met": True}) + "\n")
    assert main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["records_consumed"] == 1
    assert main(["--smoke", "--json", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["failures"] == [] and doc["records_consumed"] > 0


# ------------------------------------------------------------------- exporter
def test_exporter_scrape_counter_and_healthz_charset():
    """Mirrors test_exporter_scrape_counter_and_healthz_charset on the port's
    exporter (loopback only)."""
    from accelerate_tpu_torch.telemetry.exporter import MetricsExporter

    plane = tmetrics.MetricsPlane(enabled=True, clock=lambda: 0.0)
    with MetricsExporter(plane, port=0) as exporter:
        url = f"http://127.0.0.1:{exporter.port}"
        with urllib.request.urlopen(f"{url}/healthz") as resp:
            assert resp.headers["Content-Type"] == "application/json; charset=utf-8"
            assert json.loads(resp.read())["ok"] is True
        body1 = urllib.request.urlopen(f"{url}/metrics").read().decode()
        body2 = urllib.request.urlopen(f"{url}/metrics").read().decode()
    key_m = f'{tmetrics.M_EXPORTER_SCRAPES_TOTAL}{{endpoint="metrics"}}'
    key_h = f'{tmetrics.M_EXPORTER_SCRAPES_TOTAL}{{endpoint="healthz"}}'
    assert f"{key_m} 1.0" in body1 and f"{key_m} 2.0" in body2 and f"{key_h} 1.0" in body2
    assert plane.stats()["counters"][key_m] == 2
