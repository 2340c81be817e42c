"""serve-bench's ``--disagg`` over the port (a mixed ``FleetRouter`` against a
``DisaggRouter``, and the disagg chaos arm) against the JAX bench on the CPU at fp32
(``smoke`` preset, the port over the JAX weights). Each test mirrors the JAX test named
in its docstring.

Handoff bytes: the port gathers a handoff's real pages, JAX a table-width block
(``ROADMAP.md`` C, disaggregated serving), so ``transfer_bytes`` is held below JAX's;
the transfer count equals it.
"""

import json

from accelerate_tpu.commands import serve_bench as jsb
from accelerate_tpu_torch.commands import serve_bench as tsb
from test_torch_serve_bench_common import (gateway_streams, pinned_jax_state,  # noqa: F401
                                      run_port_cli, same_fields, same_greedy_streams,
                                      smoke_params)

#: ``--disagg 1:1 --smoke``'s arguments.
SMOKE = dict(prefill_replicas=1, decode_replicas=1, requests=12, max_slots=2, max_len=64,
             prompt_bucket=16, max_new=8, load=2.0, page_size=8, kill_rate=0.08,
             kills_per_replica=1)
ARM_FIELDS = ("submitted", "terminal", "silently_lost", "done", "failed")
REPLICA_FIELDS = ("role", "decode_tokens")


def _same_disagg(want: dict, got: dict):
    assert set(got) == set(want)
    same_fields(want, got, (
        "schema", "preset", "prefill_replicas", "decode_replicas", "max_slots_per_replica",
        "total_lanes", "page_size", "requests", "max_new", "offered_load",
        "arrivals_per_step", "seed", "streams_compared_vs_mixed",
        "streams_identical_vs_mixed", "chaos_streams_compared", "chaos_streams_identical"))
    for arm in ("mixed", "disagg", "disagg_chaos"):
        assert set(got[arm]) == set(want[arm])
        same_fields(want[arm], got[arm], ARM_FIELDS)
        assert [{k: r[k] for k in REPLICA_FIELDS} for r in got[arm]["replicas"]] == \
            [{k: r[k] for k in REPLICA_FIELDS} for r in want[arm]["replicas"]]
        assert got[arm]["wall_s"] > 0 and 0.0 <= got[arm]["decode_stall_share"] <= 1.0
        assert got[arm]["ttft"]["count"] == want[arm]["ttft"]["count"]
    for arm in ("disagg", "disagg_chaos"):
        same_fields(want[arm], got[arm], ("handoffs", "readopted", "migrated"))
        got_t, want_t = got[arm]["handoff_transfer"], want[arm]["handoff_transfer"]
        assert got_t["transfers"] == want_t["transfers"]
        assert 0 < got_t["transfer_bytes"] <= want_t["transfer_bytes"]
    same_fields(want["disagg_chaos"], got["disagg_chaos"],
                ("replica_kills", "replica_restarts", "fault_fires"))
    assert got["disagg"]["trace"].keys() == want["disagg"]["trace"].keys()


def test_disagg_bench_artifact(monkeypatch):
    """The port's artifact equals JAX's in every field the steps decide (accounting,
    stream parity, handoffs, kills), over JAX's weights; every request's stream in each
    arm (mixed, disagg, disagg chaos) equals JAX's token for token. JAX's warm-up
    routers submit without a token callback and are not recorded."""
    jax_streams, port_streams = gateway_streams(monkeypatch, keep=lambda kw: "on_token" in kw)
    artifact = tsb.run_disagg_bench(**SMOKE, device="cpu", params=smoke_params(64))
    _same_disagg(jsb.run_disagg_bench(**SMOKE), artifact)
    same_greedy_streams(jax_streams(), port_streams())
    assert len(port_streams()) == 3
    assert artifact["disagg_chaos"]["replica_kills"] >= 1


def test_disagg_bench_cli_smoke(tmp_path):
    """Mirrors tests/test_disagg.py::test_disagg_bench_cli_smoke through the port's CLI
    root: zero silently-lost requests, disagg streams byte-identical to the mixed
    baseline (clean AND chaos arms), handoffs actually happened."""
    out = tmp_path / "BENCH_DISAGG.json"
    result = run_port_cli(["serve-bench", "--disagg", "1:1", "--smoke", "--disagg-out",
                           str(out), "--device", "cpu"])
    assert result.returncode == 0, result.stdout + result.stderr
    artifact = json.loads(out.read_text())
    assert artifact["schema"] == "accelerate_tpu.bench.disagg/v1"
    assert artifact["streams_identical_vs_mixed"]
    assert artifact["chaos_streams_identical"]
    assert artifact["disagg"]["silently_lost"] == 0
    assert artifact["disagg_chaos"]["silently_lost"] == 0
    assert artifact["disagg"]["handoffs"] > 0
    assert artifact["disagg"]["handoff_transfer"]["transfer_bytes"] > 0
    assert artifact["mixed"]["decode_stall_share"] is not None
    summary = json.loads(result.stdout.splitlines()[-1])
    assert summary["silently_lost_chaos"] == 0 and summary["handoffs"] > 0
