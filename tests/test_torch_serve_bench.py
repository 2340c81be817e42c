"""The port's serve-bench modes (trace replay, the chaos proof, the fleet chaos proof)
and the workload traces against the JAX package's, on the CPU.

The benches replay seeded traces on a virtual clock, so their artifacts hold no
wall-clock field: each ``run_*`` runs through the JAX package and through the port
(``smoke`` preset at fp32, the port over the JAX weights through ``params_from_jax``,
on the CPU) with the same arguments, and every field of the artifact but ``provenance``
(each framework stamps its own runtime) must be equal: streams, fired counts by site,
alerts fired, capsules, latencies in virtual seconds, ``workload_trace_hash``. The
port's chaos artifact adds ``mismatched_requests`` (the rows behind
``streams_mismatched``), which JAX's does not carry. Each test mirrors the JAX test
named in its docstring (``tests/test_tracing.py``'s trace-replay tests,
``tests/test_resilience.py::test_chaos_bench_artifact``,
``tests/test_fleet.py::test_fleet_chaos_bench_artifact`` and their CLI smokes) and keeps
its assertions on the port's side.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.commands import serve_bench as jsb
from accelerate_tpu.compile_cache.warmup import build_model_config
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ContinuousBatcher as JaxBatcher
from accelerate_tpu.serving_gateway import ServingGateway as JaxGateway
from accelerate_tpu.serving_gateway import workload as jwl
from accelerate_tpu.utils.dataclasses import GatewayConfig as JaxGatewayConfig
from accelerate_tpu_torch.commands import serve_bench as tsb
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import ContinuousBatcher
from accelerate_tpu_torch.serving_gateway import ServingGateway
from accelerate_tpu_torch.serving_gateway.workload import (
    GENERATORS, VirtualClock, generate_workload, load_trace, replay_trace, save_trace,
    trace_hash)
from accelerate_tpu_torch.telemetry.provenance import (config_fingerprint, git_commit,
                                                       provenance_stamp)
from accelerate_tpu_torch.utils.dataclasses import GatewayConfig

JCFG = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    return jparams, tparams


@pytest.fixture(scope="module")
def smoke_params():
    """The port's ``smoke`` model over the JAX bench's weights (``init_params`` of
    ``build_model_config("smoke", 64)``)."""
    cfg, _ = tsb._model("smoke", 64, "cpu")
    jparams = jl.init_params(build_model_config("smoke", 64))
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _same_artifact(want: dict, got: dict, port_only=()):
    """Every field equal but the provenance block (and the port's own extras)."""
    assert {k: v for k, v in got.items() if k not in ("provenance", *port_only)} == \
        {k: v for k, v in want.items() if k != "provenance"}
    assert got["provenance"]["config_fingerprint"] and "git_commit" in got["provenance"]
    assert got["provenance"]["device"] == "cpu"


def _run_cli(args, tmp_path):
    """``python -m accelerate_tpu_torch.commands.serve_bench ARGS`` in a child process
    that must never import jax."""
    return subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy\n"
         "sys.argv = ['serve_bench'] + sys.argv[1:]\n"
         "try:\n"
         "    runpy.run_module('accelerate_tpu_torch.commands.serve_bench',"
         " run_name='__main__')\n"
         "finally:\n"
         "    assert 'jax' not in sys.modules, 'jax was imported'\n", *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT)


# ------------------------------------------------------------------- workloads
def test_generators_deterministic_and_distinct():
    """Mirrors tests/test_tracing.py::test_generators_deterministic_and_distinct."""
    for kind in GENERATORS:
        a = generate_workload(kind, 32, seed=7)
        b = generate_workload(kind, 32, seed=7)
        c = generate_workload(kind, 32, seed=8)
        assert [r.to_json() for r in a] == [r.to_json() for r in b]
        assert trace_hash(a) == trace_hash(b) != trace_hash(c)
        assert trace_hash(a) == jwl.trace_hash(jwl.generate_workload(kind, 32, seed=7))
        assert len(a) == 32
        arrivals = [r.arrival_s for r in a]
        assert arrivals == sorted(arrivals)
        assert all(r.prompt_len >= 1 and r.output_len >= 1 for r in a)
    with pytest.raises(ValueError, match="unknown workload generator"):
        generate_workload("nope", 4)


def test_tenant_flood_contains_flood_window():
    """Mirrors tests/test_tracing.py::test_tenant_flood_contains_flood_window."""
    trace = generate_workload("tenant_flood", 40, seed=1)
    flood = [r for r in trace if r.tenant == "flood"]
    assert len(flood) == 16
    assert max(r.arrival_s for r in flood) - min(r.arrival_s for r in flood) <= 2.0


def test_trace_save_load_roundtrip(tmp_path):
    """Mirrors tests/test_tracing.py::test_trace_save_load_roundtrip; the port's file
    is byte-identical to JAX's and each package loads the other's."""
    trace = generate_workload("heavy_tail", 16, seed=2)
    path, jpath = str(tmp_path / "trace.jsonl"), str(tmp_path / "jax.jsonl")
    save_trace(path, trace, generator="heavy_tail", seed=2)
    jwl.save_trace(jpath, jwl.generate_workload("heavy_tail", 16, seed=2),
                   generator="heavy_tail", seed=2)
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    back = load_trace(jpath)
    assert [r.to_json() for r in back] == [r.to_json() for r in trace]
    assert trace_hash(back) == trace_hash(trace) == jwl.trace_hash(jwl.load_trace(path))
    with open(path) as f:
        header = json.loads(f.readline())
    assert header["schema"] == "accelerate_tpu.serving.workload/v1"
    assert header["generator"] == "heavy_tail" and header["n"] == 16
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps({"schema": "something/else"}) + "\n")
    with pytest.raises(ValueError, match="unknown workload trace schema"):
        load_trace(bad)


def test_replay_offered_load_compresses_arrivals(setup):
    """Mirrors tests/test_tracing.py::test_replay_offered_load_compresses_arrivals over
    the port's engine; clock, endings and tokens equal the JAX engine's."""
    trace = generate_workload("poisson", 16, seed=5, mean_iat_s=4.0)

    def one(port, load):
        clock = VirtualClock()
        if port:
            eng = ContinuousBatcher(setup[1], TCFG, max_slots=2, max_len=64, prompt_bucket=16)
            gw = ServingGateway(eng, GatewayConfig(enabled=True, policy="fifo", max_queue=8,
                                                   overload="shed"), clock=clock)
            greqs = replay_trace(gw, trace, TCFG.vocab_size, clock, load=load, seed=5)
        else:
            eng = JaxBatcher(setup[0], JCFG, max_slots=2, max_len=64, prompt_bucket=16)
            gw = JaxGateway(eng, JaxGatewayConfig(enabled=True, policy="fifo", max_queue=8,
                                                  overload="shed"), clock=clock)
            greqs = jwl.replay_trace(gw, trace, JCFG.vocab_size, clock, load=load, seed=5)
        return clock.t, [(g.status, g.deadline_met, list(map(int, g.tokens))) for g in greqs]

    runs = {}
    for load in (0.5, 4.0):
        runs[load] = one(True, load)
        assert runs[load] == one(False, load)
    (t_low, low), (t_high, high) = runs[0.5], runs[4.0]
    assert t_high < t_low
    assert sum(bool(m) for _, m, _ in high) <= sum(bool(m) for _, m, _ in low)
    with pytest.raises(ValueError, match="load"):
        replay_trace(None, trace, TCFG.vocab_size, VirtualClock(), load=0)


def test_trace_replay_rows_stamp_hash_and_provenance(smoke_params):
    """Mirrors tests/test_tracing.py::test_trace_replay_rows_stamp_hash_and_provenance;
    every row equals JAX's row but for the provenance block (all four policies)."""
    trace = generate_workload("poisson", 10, seed=4, mean_iat_s=3.0)
    kw = dict(max_slots=2, max_len=64, prompt_bucket=16, generator="poisson")
    rows = tsb.run_trace_replay(trace, **kw, device="cpu", params=smoke_params)
    want = jsb.run_trace_replay(trace, **kw)
    assert len(rows) == 4
    for row, ref in zip(rows, want):
        _same_artifact(ref, row)
    row = rows[0]
    assert row["workload_trace_hash"] == trace_hash(trace)
    assert row["metric"] == "serve_trace/poisson/fifo" and row["attainment"] is not None


def test_provenance_stamp_contents():
    """Mirrors tests/test_tracing.py::test_provenance_stamp_contents: the port stamps
    torch, its CUDA version and the device where JAX stamps ``jax`` and ``backend``."""
    stamp = provenance_stamp(TCFG)
    assert stamp["torch"] == torch.__version__ and stamp["device"] == "cpu"
    assert "cuda" in stamp and len(stamp["config_fingerprint"]) == 20
    other = dataclasses.replace(TCFG, n_layers=TCFG.n_layers + 1)
    assert config_fingerprint(other) != stamp["config_fingerprint"]
    assert git_commit() == stamp["git_commit"]
    assert git_commit(root="/nonexistent") is None


def test_workload_trace_rides_bucket_ladder_warm_surface(setup):
    """Mirrors tests/test_tracing.py::test_workload_trace_rides_bucket_ladder_zero_new_compiles:
    every prefill a bucket-laddered engine routes the trace's prompts to is in the
    surface ``warm_programs()`` captures on the card (so a replay there captures no
    graph), and the replay used the ladder."""
    buckets = (8, 16, 32)
    trace = generate_workload("poisson", 12, seed=6, mean_iat_s=2.0, prompt_range=(3, 24),
                              output_range=(4, 8))
    eng = ContinuousBatcher(setup[1], TCFG, max_slots=2, max_len=64, prompt_bucket=16,
                            prompt_buckets=buckets)
    surface = set(eng._program_surface(max(r.output_len for r in trace)))
    for r in trace:
        mode, width = eng._plan_prefill(r.prompt_len, r.output_len)
        need = {("prefill", width)} if mode == "bucket" else \
            {("prefill", eng.prompt_bucket)} | ({("chunk", eng.prompt_bucket)}
                                                if width > eng.prompt_bucket else set())
        assert need <= surface, (r.prompt_len, mode, width)
    clock = VirtualClock()
    gw = ServingGateway(eng, GatewayConfig(enabled=True, policy="fifo", max_queue=12),
                        clock=clock)
    greqs = replay_trace(gw, trace, TCFG.vocab_size, clock, seed=6)
    assert sum(r.status == "done" for r in greqs) >= 10
    assert eng.bucket_hits + eng.bucket_misses > 0


# ------------------------------------------------------------------ chaos bench
def test_chaos_bench_artifact(smoke_params):
    """Mirrors tests/test_resilience.py::test_chaos_bench_artifact: the port's artifact
    equals JAX's for the same arguments."""
    kw = dict(requests=12, max_slots=2, max_len=64, prompt_bucket=16, seed=0,
              chaos_rate=0.15)
    artifact = tsb.run_chaos_bench(**kw, device="cpu", params=smoke_params)
    _same_artifact(jsb.run_chaos_bench(**kw), artifact, port_only=("mismatched_requests",))
    assert artifact["schema"] == "accelerate_tpu.bench.chaos/v1"
    assert artifact["chaos"]["silently_lost"] == 0
    assert artifact["chaos"]["terminal"] == artifact["chaos"]["submitted"]
    assert artifact["streams_identical"] is True and artifact["mismatched_requests"] == []
    assert artifact["streams_compared"] > 0
    assert artifact["chaos"]["engine"]["step_fault_rate"] >= 0.10
    assert artifact["chaos"]["engine"]["step_failures"] >= 1
    assert artifact["clean"]["engine"]["step_failures"] == 0
    assert "ttft" in artifact["chaos"] and "ttft" in artifact["clean"]
    assert artifact["workload_trace_hash"]


def test_chaos_bench_all_sites_paged_equals_jax(smoke_params):
    """The three fault sites (decode dispatches, prefill admissions, paged pool
    allocations, which opts the bench into pages): the port's artifact equals JAX's,
    every site fired and is covered by a capsule, nothing is lost."""
    kw = dict(requests=16, max_slots=2, max_len=64, prompt_bucket=16, seed=0,
              chaos_rate=0.15, chaos_sites=("decode", "prefill", "kv_admit"))
    artifact = tsb.run_chaos_bench(**kw, device="cpu", params=smoke_params)
    _same_artifact(jsb.run_chaos_bench(**kw), artifact, port_only=("mismatched_requests",))
    assert artifact["page_size"] == 8 and artifact["chaos"]["silently_lost"] == 0
    assert set(artifact["fault_plan"]["fired_by_site"]) == {
        "serving.decode", "serving.prefill", "serving.kv_admit"}
    assert artifact["capsules_chaos_expected"] and artifact["capsules_clean_zero"]
    assert artifact["alerts_clean_silent"] and artifact["alerts_chaos_expected"]


def test_chaos_bench_cli_smoke(tmp_path, capsys):
    """Mirrors tests/test_resilience.py::test_chaos_bench_cli_smoke: the port's CLI
    (``--device cpu``, never importing jax) exits 0 with its gates held, and its kept
    capsules rebuild the incident through the port's capsule-report."""
    from accelerate_tpu_torch.commands.capsule_report import main as capsule_main

    out, caps = tmp_path / "BENCH_CHAOS.json", tmp_path / "caps"
    result = _run_cli(["--chaos", str(out), "--smoke", "--seed", "0", "--capsule-dir",
                       str(caps), "--device", "cpu"], tmp_path)
    assert result.returncode == 0, result.stdout + result.stderr
    artifact = json.loads(out.read_text())
    assert artifact["chaos"]["silently_lost"] == 0 and artifact["streams_identical"] is True
    assert artifact["capsules_clean_zero"] is True
    assert artifact["capsules_chaos_expected"] is True
    assert artifact["capsules"]["count"] >= 1 and artifact["capsules"]["sites_covered"] is True
    summary = json.loads(result.stdout.strip().splitlines()[-1])
    assert summary["schema"] == "accelerate_tpu.bench.chaos/v1"
    assert capsule_main([str(caps / "chaos"), "--json"]) == 0
    reports = json.loads(capsys.readouterr().out)["capsules"]
    assert len(reports) == artifact["capsules"]["count"]
    assert sorted({s for r in reports for s in r["fault_sites"]}) == \
        artifact["capsules"]["fault_sites"]
    assert not (caps / "clean").exists() or not any((caps / "clean").iterdir())


# ------------------------------------------------------------------- fleet bench
def test_fleet_chaos_bench_artifact(smoke_params):
    """Mirrors tests/test_fleet.py::test_fleet_chaos_bench_artifact: the port's artifact
    (replica crash clauses, restarts through ``engine_factory``, replayed streams)
    equals JAX's for the same arguments."""
    kw = dict(n_replicas=3, requests=16, max_slots=2, max_len=64, prompt_bucket=16, seed=0,
              kill_rate=0.05, kills_per_replica=2)
    artifact = tsb.run_fleet_chaos_bench(**kw, device="cpu", params=smoke_params)
    _same_artifact(jsb.run_fleet_chaos_bench(**kw), artifact)
    assert artifact["schema"] == "accelerate_tpu.bench.fleet/v1"
    assert artifact["fleet_chaos"]["silently_lost"] == 0
    assert artifact["fleet_chaos"]["terminal"] == artifact["fleet_chaos"]["submitted"]
    assert artifact["streams_identical"] is True and artifact["streams_compared"] > 0
    assert artifact["fleet_chaos"]["replica_kills"] >= 1
    assert artifact["kill_plan"]["single_fired"] >= 1
    assert artifact["fleet_availability_above_single"] is True
    assert artifact["fleet_chaos"]["circuit_rejections"] == 0
    assert artifact["alerts_clean_silent"] and artifact["alerts_chaos_expected"]
