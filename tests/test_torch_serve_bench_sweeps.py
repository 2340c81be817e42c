"""serve-bench's ``--multistep`` (a ``decode_steps`` sweep) and ``--spec-bench``
(plain / n-gram / oracle overload rows, then host-loop speculation against the fused
speculative super-step) over the port, against the JAX bench on the CPU at fp32
(``smoke`` preset, the port over the JAX weights). JAX has no test of these two
artifacts; each test holds the port's gates and the fields the steps decide to JAX's.

A quarter of each sweep's lanes sample: the port draws from torch generators and JAX
from keys (``ROADMAP.md`` C), so sampled tokens match JAX's in distribution only. Their contract is held inside the port, bitwise: every multistep row's streams
equal the N = 1 row's, the fused arm's equal the host loop's and ``spec_k=0``'s. With
fixed budgets and no EOS the token counts and the plain dispatch counts do not depend on
the sampled values, so they equal JAX's; the speculative sweep's acceptance does (a
sampled lane's draft is accepted when it matches the draw), so only the greedy overload
rows' acceptance is held to JAX's. Every greedy lane's stream, in every row and arm,
equals JAX's token for token.
"""

import json

import pytest

from accelerate_tpu.commands import serve_bench as jsb
from accelerate_tpu_torch.commands import serve_bench as tsb
from test_torch_serve_bench_common import (gateway_streams, pinned_jax_state,  # noqa: F401
                                      run_port_cli, same_fields, same_greedy_streams,
                                      same_row, smoke_params)

MULTI_ROW = ("decode_steps", "requests", "max_slots", "max_new", "page_size",
             "tokens_generated", "decode_dispatches", "decode_only_steps", "identical_vs_n1")


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_multistep_bench_artifact(page_size, monkeypatch):
    """Every row's streams equal the N = 1 row's (greedy and sampled lanes), and the
    greedy lanes' equal JAX's; the rows' counts equal JAX's; the host shares come from
    the decode spans."""
    kw = dict(max_len=64, prompt_bucket=16, max_new=12, requests=10, max_slots=4,
              decode_steps=(1, 4), page_size=page_size, sampled_frac=0.5)
    jax_streams, port_streams = gateway_streams(monkeypatch)
    artifact = tsb.run_multistep_bench(**kw, device="cpu", params=smoke_params(64))
    want = jsb.run_multistep_bench(**kw)
    same_greedy_streams(jax_streams(), port_streams())
    assert set(artifact) == set(want)
    same_fields(want, artifact, ("schema", "preset", "max_slots", "requests", "page_size",
                                 "all_identical"))
    for row, ref in zip(artifact["rows"], want["rows"]):
        assert set(row) == set(ref)
        same_fields(ref, row, MULTI_ROW)
        assert 0.0 < row["host_share"] < 1.0 and row["decode_tokens_per_sec"] > 0
    assert artifact["all_identical"] is True
    assert [r["decode_steps"] for r in artifact["rows"]] == [1, 4]
    assert artifact["rows"][1]["decode_dispatches"] < artifact["rows"][0]["decode_dispatches"]
    with pytest.raises(ValueError, match="N=1 baseline"):
        tsb.run_multistep_bench(decode_steps=(2, 4), device="cpu", params=smoke_params(64))


SWEEP_ROW = ("decode_steps", "spec_k", "spec_draft", "requests", "max_slots", "max_new",
             "tokens_generated")


def test_spec_bench_artifact(monkeypatch):
    """The overload rows equal JAX's (the oracle at exactly 1.0); the fused sweep's
    tokens equal the host loop's and ``spec_k=0``'s bitwise; every greedy lane's stream
    in the rows and the sweep's arms equals JAX's; the gates and token counts equal
    JAX's."""
    kw = dict(requests=10, max_slots=2, max_len=64, prompt_bucket=16, max_new=8,
              spec_k=3, fused_steps=4, sweep_max_len=64, sweep_max_slots=4,
              sweep_max_new=12, sweep_requests=8)
    jax_streams, port_streams = gateway_streams(monkeypatch)
    artifact = tsb.run_spec_bench(**kw, device="cpu", params=smoke_params(64))
    want = jsb.run_spec_bench(**kw)
    same_greedy_streams(jax_streams(), port_streams())
    assert set(artifact) - {"mismatched_vs_plain"} == set(want)
    same_fields(want, artifact, ("schema", "note", "fused_identical_vs_host_loop",
                                 "fused_identical_vs_plain"))
    for row, ref in zip(artifact["rows"], want["rows"]):
        same_row(ref, row)
    assert artifact["rows"][2]["spec_accept_rate"] == 1.0
    for row, ref in zip(artifact["fused_sweep"]["rows"], want["fused_sweep"]["rows"]):
        assert set(row) == set(ref)
        same_fields(ref, row, SWEEP_ROW)
        assert 0.0 < row["host_share"] < 1.0 and row["tokens_per_step"] >= 1.0
    assert artifact["fused_sweep"]["fused_rounds"] == 4
    assert artifact["fused_identical_vs_host_loop"] is True
    assert artifact["fused_identical_vs_plain"] is True
    assert artifact["mismatched_vs_plain"] == []
    cmp, ref = artifact["comparison"], want["comparison"]
    assert set(cmp) == set(ref)
    same_fields(ref, cmp, ("ngram_tokens_per_step_ratio", "oracle_tokens_per_step_ratio",
                           "fused_rounds"))


def test_multistep_and_spec_bench_cli(tmp_path):
    """``serve-bench --multistep`` and ``--spec-bench`` through the port's CLI root: each
    writes its artifact, prints its summary and exits 0 with its gates held."""
    out = tmp_path / "BENCH_MULTISTEP.json"
    result = run_port_cli(["serve-bench", "--multistep", str(out), "--device", "cpu",
                           "--requests", "6", "--decode-steps", "1,2", "--max-len", "64",
                           "--max-new", "10"])
    assert result.returncode == 0, result.stdout + result.stderr
    summary = json.loads(result.stdout.splitlines()[-1])
    assert summary["all_identical"] is True
    assert [r["decode_steps"] for r in json.loads(out.read_text())["rows"]] == [1, 2]

    out = tmp_path / "BENCH_SPEC.json"
    result = run_port_cli(["serve-bench", "--spec-bench", str(out), "--device", "cpu",
                           "--requests", "6", "--max-slots", "2", "--max-len", "64",
                           "--max-new", "8", "--decode-steps", "2"])
    assert result.returncode == 0, result.stdout + result.stderr
    summary = json.loads(result.stdout.splitlines()[-1])
    assert summary["fused_identical_vs_host_loop"] and summary["fused_identical_vs_plain"]
    assert summary["fused_rounds"] == 2
    assert json.loads(out.read_text())["rows"][2]["spec_accept_rate"] == 1.0
