"""The port's autoscaler, ``spawn_replica`` and the workload generators against the JAX
package's, on the CPU.

Each fleet scenario runs twice, once over the JAX ``FleetRouter`` and engines and once
over the port's (``tiny`` at fp32, the JAX weights through ``params_from_jax``), under
one manual clock script; the scale decisions (``fleet.scale/v1`` records), the request
endings, the streams and the counters must be EQUAL. Each test mirrors the test of
``tests/test_autoscaler.py`` named in its docstring and keeps its assertions on the
port's side.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerate_tpu.serving_gateway as jgw
import accelerate_tpu.telemetry as jtel
import accelerate_tpu.utils.dataclasses as jdc
import accelerate_tpu_torch.serving_gateway as tgw
import accelerate_tpu_torch.telemetry as ttel
import accelerate_tpu_torch.utils.dataclasses as tdc
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu.serving_gateway import workload as jwl
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.serving_gateway import workload as twl
from accelerate_tpu_torch.telemetry.schemas import (FLEET_SCALE_SCHEMA,
                                                    GATEWAY_REQUEST_SCHEMA, validate_record)

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)


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
               for n in (5, 9, 3, 7, 6, 4, 8, 5, 11, 6, 4, 7)]
    return jparams, tparams, prompts


def _side(gw, tel, dc, engine, params_of, cfg):
    return types.SimpleNamespace(gw=gw, tel=tel, dc=dc, engine=engine,
                                 params=params_of, cfg=cfg)


JAX = _side(jgw, jtel, jdc, JaxBatcher, lambda s: s[0], JCFG)
PORT = _side(tgw, ttel, tdc, ContinuousBatcher, lambda s: s[1], TCFG)


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_engine(side, setup, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prompt_bucket", 16)
    return side.engine(side.params(setup), side.cfg, **kw)


def make_fleet(side, setup, n=1, clock=None, telemetry=None, **cfg_kwargs):
    cfg_kwargs.setdefault("enabled", True)
    cfg_kwargs.setdefault("max_queue", 64)
    cfg_kwargs.setdefault("breaker_threshold", 2)
    cfg_kwargs.setdefault("breaker_window_s", 100.0)
    cfg_kwargs.setdefault("breaker_cooldown_s", 5.0)
    kw = {} if clock is None else {"clock": clock}
    return side.gw.FleetRouter([make_engine(side, setup) for _ in range(n)],
                               side.dc.GatewayConfig(**cfg_kwargs), telemetry=telemetry,
                               engine_factory=lambda rid: make_engine(side, setup), **kw)


def submit_with_streams(gw, prompts, max_new=8, **kw):
    streams, greqs = {}, []
    for i, p in enumerate(prompts):
        streams[i] = []
        greqs.append(gw.submit(p, max_new_tokens=max_new,
                               on_token=lambda tok, i=i: streams[i].append(int(tok)),
                               on_retry=lambda i=i: streams[i].clear(), **kw))
    return greqs, streams


def _tel(side):
    return side.tel.Telemetry(side.dc.TelemetryConfig(enabled=True, compile_events=False,
                                                      memory_stats=False))


# ------------------------------------------------------------------ validation
def test_autoscaler_validates_bounds_and_factory(setup):
    """Mirrors test_autoscaler_validates_bounds_and_factory."""
    fleet = make_fleet(PORT, setup, n=1)
    with pytest.raises(ValueError, match="min_replicas"):
        tgw.Autoscaler(fleet, min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        tgw.Autoscaler(fleet, min_replicas=3, max_replicas=2)
    no_factory = tgw.FleetRouter([make_engine(PORT, setup)], tdc.GatewayConfig(enabled=True))
    with pytest.raises(ValueError, match="engine_factory"):
        tgw.Autoscaler(no_factory)
    up, down = tgw.default_autoscale_rules()
    with pytest.raises(ValueError, match="metrics"):
        tgw.Autoscaler(make_fleet(PORT, setup, n=1, metrics=False), up_rules=up,
                       down_rules=down)


def test_spawn_replica_mechanics_and_geometry_guard(setup):
    """Mirrors test_spawn_replica_mechanics_and_geometry_guard; the served tokens and
    the fleet counters equal JAX's, and the disagg router grows its role table."""
    def scenario(side):
        fleet = make_fleet(side, setup, n=1)
        rep = fleet.spawn_replica()
        first = (rep.rid, rep.state, rep.breaker.state, fleet.counters["replica_spawned"])
        with pytest.raises(ValueError, match="role-aware"):
            fleet.spawn_replica("decode")
        bad = side.gw.FleetRouter(
            [make_engine(side, setup)], side.dc.GatewayConfig(enabled=True),
            engine_factory=lambda rid: make_engine(side, setup, max_len=128))
        with pytest.raises(ValueError, match="geometry"):
            bad.spawn_replica()
        greqs = [fleet.submit(p, max_new_tokens=4) for p in setup[2][:4]]
        fleet.run()
        return (first, [(g.status, list(map(int, g.tokens))) for g in greqs],
                rep.breaker.state, dict(fleet.counters))

    first, ends, breaker, counters = both(scenario)
    assert first == (1, "active", "half_open", 1)
    assert all(s == "done" for s, _ in ends) and breaker == "closed"

    def disagg(side):
        def role_engine(rid, role):
            return make_engine(side, setup, role=role, page_size=8)

        router = side.gw.DisaggRouter(
            [role_engine(0, "prefill"), role_engine(1, "decode")],
            side.dc.GatewayConfig(enabled=True, breaker_threshold=2),
            roles=["prefill", "decode"], engine_factory=role_engine)
        with pytest.raises(ValueError, match="needs a role"):
            router.spawn_replica()
        rep = router.spawn_replica("decode")
        greqs = [router.submit(p, max_new_tokens=4) for p in setup[2][:4]]
        router.run()
        dense = side.gw.DisaggRouter(
            [role_engine(0, "prefill"), role_engine(1, "decode")],
            side.dc.GatewayConfig(enabled=True), roles=["prefill", "decode"],
            engine_factory=lambda rid, role: make_engine(side, setup, role=role))
        with pytest.raises(ValueError, match="geometry"):  # a dense engine: page_size 0
            dense.spawn_replica("mixed")
        return (list(router.roles), rep.engine.role, rep.breaker.state,
                [(g.status, list(map(int, g.tokens))) for g in greqs],
                {k: router.counters[k] for k in ("replica_spawned", "handoffs", "done")},
                list(dense.roles), len(dense.replicas), dense.counters["replica_spawned"])

    roles, role, state, ends, counters, dense_roles, dense_n, dense_spawned = both(disagg)
    assert roles == ["prefill", "decode", "decode"] and role == "decode"
    assert state == "closed" and all(s == "done" for s, _ in ends)  # the probe earned it
    assert counters["replica_spawned"] == 1 and counters["handoffs"] == 4
    assert dense_roles == ["prefill", "decode"] and dense_n == 2 and dense_spawned == 0


def both(scenario):
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    return got


# ------------------------------------------------------------------ closed loop
def _closed_loop(side, setup, idle_steps=40):
    """Mirrors tests/test_autoscaler.py's ``_closed_loop`` on one side."""
    clock = ManualClock()
    tel = _tel(side)
    fleet = make_fleet(side, setup, n=1, clock=clock, telemetry=tel, metrics=True,
                       metrics_window_s=60.0)
    up, down = side.gw.default_autoscale_rules(
        queue_window_s=5.0, idle_lane_floor=2.0, idle_clear=3.0, idle_window_s=6.0,
        fast_window_s=5.0, slow_window_s=20.0, burn_threshold=2.0)
    scaler = side.gw.Autoscaler(fleet, min_replicas=1, max_replicas=3, cooldown_s=4.0,
                                down_cooldown_s=3.0, forecast_window_s=5.0, up_rules=up,
                                down_rules=down)
    greqs, streams = submit_with_streams(fleet, setup[2], max_new=8)
    for _ in range(200):
        if not fleet.queue_depth and not fleet.running_count:
            break
        fleet.step()
        clock.advance(1.0)
    for _ in range(idle_steps):
        fleet.step()
        clock.advance(1.0)
    return fleet, scaler, greqs, streams


def _loop_result(side, setup):
    fleet, scaler, greqs, streams = _closed_loop(side, setup)
    plane = fleet.metrics
    return {"events": list(scaler.events), "stats": scaler.stats(),
            "ends": [(g.status, list(map(int, g.tokens))) for g in greqs],
            "streams": streams, "counters": dict(fleet.counters),
            "replicas": len(fleet.replicas), "replica_hours": fleet.replica_hours,
            "plane": plane.stats(),
            "ups": plane.counter_value("accelerate_tpu_fleet_scale_events_total",
                                       action="scale_up"),
            "active": plane.gauge_value("accelerate_tpu_fleet_replicas_active"),
            "hours": plane.counter_value("accelerate_tpu_fleet_replica_hours_total")}


def test_closed_loop_scales_up_then_down(setup):
    """Mirrors test_closed_loop_scales_up_then_down; every scale record, the plane's
    snapshot and the transcripts equal JAX's."""
    got = both(lambda side: _loop_result(side, setup))
    assert all(s == "done" for s, _ in got["ends"])
    stats = got["stats"]
    assert stats["actions"]["scale_up"] >= 1 and stats["actions"]["scale_down"] >= 1
    assert stats["replicas"] == 1
    assert 1 <= got["replicas"] - got["counters"]["replica_retired"] <= 3
    for rec in got["events"]:
        assert rec["schema"] == FLEET_SCALE_SCHEMA and validate_record(rec) == []
        assert rec["replicas"] <= 3
    assert got["ups"] == stats["actions"]["scale_up"]
    assert sum(got["active"].values()) == 1
    assert got["hours"] == pytest.approx(got["events"][-1]["replica_hours"])
    assert got["hours"] <= got["replica_hours"] + 1e-9


def test_closed_loop_deterministic_replay(setup):
    """Mirrors test_closed_loop_deterministic_replay on the port."""
    a, b = _loop_result(PORT, setup), _loop_result(PORT, setup)
    assert a["events"] == b["events"] and a["ends"] == b["ends"]
    assert a["streams"] == b["streams"]


# ------------------------------------------------- scale-down terminal matrix
def test_scale_down_migrated_requests_terminal_matrix(setup):
    """Mirrors test_scale_down_migrated_requests_terminal_matrix; the terminal records
    equal JAX's."""
    def scenario(side):
        clock = ManualClock()
        tel = _tel(side)
        fleet = make_fleet(side, setup, n=2, clock=clock, telemetry=tel)
        greqs, streams = submit_with_streams(fleet, setup[2][:6], max_new=12)
        fleet.step()
        busy = len(fleet.replicas[1].running)
        fleet.decommission(1, deadline_s=2.0)
        clock.advance(5.0)
        fleet.run()
        recs = [r for r in tel.records if r.get("schema") == GATEWAY_REQUEST_SCHEMA]
        return {"busy": busy, "counters": dict(fleet.counters),
                "state": fleet.replicas[1].state, "streams": streams,
                "ends": [(g.uid, g.status, list(map(int, g.tokens))) for g in greqs],
                "records": recs}

    got = both(scenario)
    assert got["busy"] > 0 and got["counters"]["migrated"] >= 1
    assert got["state"] == "retired"
    assert all(s == "done" for _, s, _ in got["ends"])
    for i, (_, _, tokens) in enumerate(got["ends"]):
        assert got["streams"][i] == tokens
    per_uid = {}
    for r in got["records"]:
        per_uid[r["uid"]] = per_uid.get(r["uid"], 0) + 1
    assert per_uid == {u: 1 for u, _, _ in got["ends"]}
    assert len(got["records"]) == got["counters"]["done"] == len(got["ends"])


def test_decommission_charges_no_restart_budget(setup):
    """Mirrors test_decommission_charges_no_restart_budget; counters equal JAX's."""
    def scenario(side):
        fleet = make_fleet(side, setup, n=3)
        greqs = [fleet.submit(p, max_new_tokens=6) for p in setup[2][:6]]
        fleet.step()
        fleet.decommission(2)
        fleet.run()
        planned = (fleet.replicas[2].state, fleet.replicas[2].restarts,
                   fleet.supervisor.stats()["attempts"], fleet.counters["replica_restarts"],
                   [g.status for g in greqs])
        more = [fleet.submit(p, max_new_tokens=6) for p in setup[2][:2]]
        fleet.step()
        fleet.kill(1)
        fleet.run()
        return planned, fleet.supervisor.stats()["attempts"], [g.status for g in more]

    planned, attempts, more = both(scenario)
    assert planned[:4] == ("retired", 0, {}, 0) and set(planned[4]) == {"done"}
    assert len(attempts) == 1 and sum(attempts.values()) == 1 and set(more) == {"done"}


# ------------------------------------------------------------------- captures
def test_spawned_replica_adds_zero_compiles(setup):
    """Mirrors test_spawned_replica_adds_zero_compiles: on the CPU the port compiles
    nothing (no CUDA graph, no kernel build), before or after a spawn; the spawned
    engine offers ``warm_programs()`` the same surface as the fleet's first engine (on
    the card ``serve_bench``'s factories capture it before the replica takes
    traffic)."""
    mon = ttel.CompileMonitor()
    mon.start()
    try:
        fleet = make_fleet(PORT, setup, n=1)
        for p in setup[2][:4]:
            fleet.submit(p, max_new_tokens=4)
        fleet.run()
        seen = mon.count
        rep = fleet.spawn_replica()
        greqs = [fleet.submit(p, max_new_tokens=4) for p in setup[2][4:10]]
        fleet.run()
        assert all(g.status == "done" for g in greqs) and rep.breaker.state == "closed"
        assert mon.count - seen == 0 and seen == 0
        assert (rep.engine.warm_programs(max_new_tokens=4)
                == fleet.replicas[0].engine.warm_programs(max_new_tokens=4))
    finally:
        mon.stop()


# ------------------------------------------------------------------- workload
@pytest.mark.parametrize("kind", sorted(jwl.GENERATORS))
def test_generators_trace_hash_equals_jax(kind):
    """Every generator's trace, for a seed and its keywords, is byte-identical to
    JAX's: the same rows and the same ``trace_hash``."""
    kw = dict(mean_iat_s=1.25)
    if kind == "swing":
        kw.update(period_s=40.0, swing_ratio=4.0)
    for seed in (0, 7):
        want = jwl.generate_workload(kind, 32, seed=seed, **kw)
        got = twl.generate_workload(kind, 32, seed=seed, **kw)
        assert [r.to_json() for r in got] == [r.to_json() for r in want]
        assert twl.trace_hash(got) == jwl.trace_hash(want)


def test_swing_generator_is_ratio_parameterized_diurnal():
    """Mirrors test_swing_generator_is_ratio_parameterized_diurnal."""
    a = twl.swing(64, seed=7, mean_iat_s=2.0, period_s=80.0, swing_ratio=4.0)
    b = twl.diurnal_ramp(64, seed=7, mean_iat_s=2.0, period_s=80.0, depth=0.6)
    assert a == b
    assert twl.trace_hash(a) == twl.trace_hash(twl.swing(64, seed=7, mean_iat_s=2.0,
                                                         period_s=80.0, swing_ratio=4.0))
    assert all(r1.arrival_s <= r2.arrival_s for r1, r2 in zip(a, a[1:]))
    with pytest.raises(ValueError, match="swing_ratio"):
        twl.swing(8, swing_ratio=0.5)
    assert "swing" in tgw.GENERATORS


# ------------------------------------------------------------------ the bench
@pytest.fixture(scope="module")
def autoscale_artifacts(setup):
    from accelerate_tpu.commands.serve_bench import run_autoscale_bench as jax_bench
    from accelerate_tpu.compile_cache.warmup import build_model_config
    from accelerate_tpu_torch.commands.serve_bench import _model, run_autoscale_bench

    kw = dict(requests=24, max_slots=2, max_len=64, prompt_bucket=16, seed=0)
    cfg, _ = _model("smoke", 64, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jl.init_params(build_model_config("smoke", 64))),
                             cfg, device="cpu")
    return jax_bench(**kw), run_autoscale_bench(**kw, device="cpu", params=params)


def test_autoscale_bench_artifact(autoscale_artifacts):
    """Mirrors test_autoscale_bench_artifact on the port's artifact; every field but
    the provenance block (each framework stamps its own runtime) equals JAX's
    artifact for the same arguments: attainment, replica-hours, scale actions and
    records, streams, the steady/flood/chaos arms and ``workload_trace_hash``. The
    artifact holds no wall-clock field (every time is the virtual clock's)."""
    want, artifact = autoscale_artifacts
    assert {k: v for k, v in artifact.items() if k != "provenance"} == \
        {k: v for k, v in want.items() if k != "provenance"}
    assert artifact["schema"] == "accelerate_tpu.bench.autoscale/v1"
    assert artifact["attainment_within_band"] is True
    assert artifact["replica_hours_fewer"] is True
    assert artifact["replica_hours"]["autoscaled"] < artifact["replica_hours"]["static_peak"]
    assert artifact["zero_lost_all_arms"] is True
    assert artifact["streams_identical"] is True and artifact["streams_compared"] > 0
    assert artifact["autoscaled"]["scale_actions"]["scale_up"] >= 1
    assert artifact["steady_no_scale"] is True
    assert artifact["flood_scale_events"] <= artifact["flood_bound"]
    assert artifact["chaos_kill"] is not None and artifact["chaos_streams_identical"] is True
    for rec in artifact["autoscaled"]["scale_records"]:
        assert validate_record(rec) == []
    assert artifact["provenance"]["device"] == "cpu" and artifact["workload_trace_hash"]


def test_autoscale_cli_smoke(tmp_path):
    """Mirrors test_autoscale_cli_smoke: ``python -m
    accelerate_tpu_torch.commands.serve_bench --autoscale OUT --smoke --device cpu``
    exits 0 with its gates held, in a process that never imports jax."""
    out = tmp_path / "BENCH_AUTOSCALE.json"
    result = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy\n"
         "sys.argv = ['serve_bench'] + sys.argv[1:]\n"
         "try:\n"
         "    runpy.run_module('accelerate_tpu_torch.commands.serve_bench',"
         " run_name='__main__')\n"
         "finally:\n"
         "    assert 'jax' not in sys.modules, 'jax was imported'\n",
         "--autoscale", str(out), "--smoke", "--seed", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert result.returncode == 0, result.stdout + result.stderr
    artifact = json.loads(out.read_text())
    assert artifact["attainment_within_band"] is True
    assert artifact["replica_hours_fewer"] is True
    assert artifact["zero_lost_all_arms"] is True and artifact["steady_no_scale"] is True
    summary = json.loads(result.stdout.strip().splitlines()[-1])
    assert summary["schema"] == "accelerate_tpu.bench.autoscale/v1"
