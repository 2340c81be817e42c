"""serve-bench's ``--trace-curves`` (attainment against offered load, on the virtual
clock) and ``--paged-compare`` (dense against paged at one KV byte budget) over the
port, against the JAX bench on the CPU at fp32 (``smoke`` preset, the port over the
JAX weights). Each test mirrors the JAX test named in its docstring.
"""

import json

from accelerate_tpu.commands import serve_bench as jsb
from accelerate_tpu_torch.commands import serve_bench as tsb
from accelerate_tpu.serving import ContinuousBatcher as JaxEngine
from accelerate_tpu_torch.serving import ContinuousBatcher as PortEngine
from test_torch_serve_bench_common import (pinned_jax_state, record_streams,  # noqa: F401
                                      run_port_cli, same_fields, same_greedy_streams,
                                      smoke_params)


def _without_provenance(artifact: dict) -> dict:
    return {**{k: v for k, v in artifact.items() if k not in ("provenance", "curves")},
            "curves": [{k: v for k, v in c.items() if k != "provenance"}
                       for c in artifact["curves"]]}


def test_attainment_curves_show_policy_separation():
    """Mirrors tests/test_tracing.py::test_attainment_curves_show_policy_separation: at
    overload, priority/EDF high-priority deadline attainment >= FIFO's on both
    generators; the artifact (virtual clock, no wall field) equals JAX's in every field
    but the provenance blocks."""
    kw = dict(generators=("poisson", "tenant_flood"), policies=("fifo", "priority", "edf"),
              loads=(4.0,), requests=32, max_slots=2, max_len=64, prompt_bucket=16)
    art = tsb.run_trace_curves(**kw, device="cpu", params=smoke_params(64))
    assert _without_provenance(art) == _without_provenance(jsb.run_trace_curves(**kw))
    assert art["schema"] == "accelerate_tpu.bench.trace/v1"
    by = {(c["generator"], c["policy"]): c for c in art["curves"]}
    for gen in ("poisson", "tenant_flood"):
        fifo = by[(gen, "fifo")]["points"][0]["attainment_high"]
        for pol in ("priority", "edf"):
            assert by[(gen, pol)]["points"][0]["attainment_high"] >= fifo, (gen, pol)
    for c in art["curves"]:
        assert c["workload_trace_hash"]
        assert "git_commit" in c["provenance"]
        assert "config_fingerprint" in c["provenance"]
        assert c["provenance"]["device"] == "cpu"
        for p in c["points"]:
            assert p["attainment"] is not None
            assert {"done", "rejected", "shed", "expired"} <= set(p)


def test_trace_curves_cli(tmp_path):
    """``python -m accelerate_tpu_torch serve-bench --trace-curves`` writes the artifact
    and prints one attainment line per curve (the JAX command's output)."""
    out = tmp_path / "BENCH_TRACE.json"
    result = run_port_cli(["serve-bench", "--trace-curves", str(out), "--device", "cpu",
                           "--requests", "12", "--max-slots", "2", "--max-len", "64",
                           "--loads", "1.0,4.0", "--policy", "edf"])
    assert result.returncode == 0, result.stdout + result.stderr
    artifact = json.loads(out.read_text())
    lines = [json.loads(line) for line in result.stdout.splitlines() if line]
    assert [(r["generator"], r["policy"]) for r in lines] == [
        ("poisson", "edf"), ("tenant_flood", "edf")]
    assert artifact["loads"] == [1.0, 4.0]
    assert [len(r["attainment"]) for r in lines] == [2, 2]


PAGED_FIELDS = ("layout", "kv_budget_bytes", "page_size", "kv_pages", "max_slots", "requests",
                "max_new", "max_concurrent_at_fixed_mem", "tokens_per_step",
                "kv_bytes_per_request", "kv_defer_count", "prefix_hit_memory_bytes",
                "prefix_entries", "prefix_hits", "kv_shared_pages")


def test_paged_compare_artifact_shape(monkeypatch):
    """Mirrors tests/test_serving_paged.py::test_paged_compare_artifact_shape: >= 2x
    concurrency at a fixed KV budget; the byte columns, concurrency, prefix counters and
    ratios equal JAX's (the tokens/s columns are wall-clock: present and positive); the
    four engines' streams (dense, dense with prefixes, paged, paged with prefixes) equal
    JAX's token for token (JAX's warm-up engines submit 2-token budgets and are not
    recorded)."""
    kw = dict(max_len=128, prompt_bucket=16, max_new=8, requests=12, budget_rows=1,
              page_size=16, max_slots=4, prefix_cache=2)
    bench = lambda kw_: kw_.get("max_new_tokens") == kw["max_new"]  # noqa: E731
    jax_streams = record_streams(monkeypatch, JaxEngine, bench)
    port_streams = record_streams(monkeypatch, PortEngine, bench)
    artifact = tsb.run_paged_compare(**kw, device="cpu", params=smoke_params(128))
    want = jsb.run_paged_compare(**kw)
    same_greedy_streams(jax_streams(), port_streams())
    assert len(port_streams()) == 4
    same_fields(want, artifact, ("schema", "preset", "kv_budget_bytes", "concurrency_ratio",
                                 "prefix_memory_ratio"))
    assert set(artifact) == set(want)
    for row, ref in zip(artifact["rows"], want["rows"]):
        assert set(row) == set(ref)
        same_fields(ref, row, PAGED_FIELDS)
        assert row["tokens_per_sec"] > 0 and row["decode_tokens_per_sec"] > 0
    assert artifact["schema"] == "accelerate_tpu.bench.paged/v1"
    dense_row, paged_row = artifact["rows"]
    assert dense_row["layout"] == "dense" and paged_row["layout"] == "paged"
    assert dense_row["kv_budget_bytes"] == paged_row["kv_budget_bytes"]
    assert artifact["concurrency_ratio"] >= 2.0, artifact
    assert paged_row["kv_bytes_per_request"] < dense_row["kv_bytes_per_request"]
    assert paged_row["prefix_hit_memory_bytes"] < dense_row["prefix_hit_memory_bytes"]


def test_paged_compare_cli(tmp_path):
    """``serve-bench --paged-compare`` through the port's CLI root."""
    out = tmp_path / "BENCH_PAGED.json"
    result = run_port_cli(["serve-bench", "--paged-compare", str(out), "--device", "cpu",
                           "--requests", "8", "--max-len", "128", "--max-slots", "6"])
    assert result.returncode == 0, result.stdout + result.stderr
    summary = json.loads(result.stdout.splitlines()[-1])
    assert summary == {k: json.loads(out.read_text())[k] for k in summary}
    assert summary["concurrency_ratio"] >= 2.0
