"""serve-bench's default mode over the port (the per-policy overload rows, with the
n-gram, ``half`` and oracle drafters and the paged KV columns) against the JAX bench,
on the CPU at fp32 (``smoke`` preset, the port over the JAX weights).

Each test mirrors the JAX test named in its docstring and keeps its assertions on the
port's side; the rows must equal JAX's in every field the steps decide (see
``tests/test_torch_serve_bench_common.py``), and every request's stream must equal
JAX's token for token (the CLI children run the port's own seeded weights, so only the
in-process runs over JAX's weights compare streams).
"""

import json

import pytest

from accelerate_tpu.commands import serve_bench as jsb
from accelerate_tpu_torch.commands import serve_bench as tsb
from test_torch_serve_bench_common import (accounted, gateway_streams,  # noqa: F401
                                      pinned_jax_state, run_port_cli, same_greedy_streams,
                                      same_row, smoke_params)

#: ``--smoke``'s geometry.
SMOKE = dict(max_slots=2, max_len=64, prompt_bucket=16, max_new=8)


def _cli_rows(args):
    result = run_port_cli(["serve-bench", "--smoke", "--device", "cpu", *args])
    assert result.returncode == 0, result.stdout + result.stderr
    return [json.loads(line) for line in result.stdout.splitlines() if line]


def test_serve_bench_smoke_cli():
    """Mirrors tests/test_serving_gateway.py::test_serve_bench_smoke_cli through the
    port's CLI root (``python -m accelerate_tpu_torch serve-bench --smoke``): one row
    per policy, equal to JAX's rows."""
    rows = _cli_rows(["--requests", "12"])
    assert [r["policy"] for r in rows] == ["fifo", "priority", "edf", "wfq"]
    for row, want in zip(rows, jsb.run_serve_bench(requests=12, **SMOKE)):
        same_row(want, row)
        assert row["metric"] == f"serve/{row['policy']}"
        assert accounted(row) == 12
        for block in ("ttft", "tpot", "queue_wait", "ttft_high"):
            assert "count" in row[block]
        if row["ttft"]["count"]:
            assert row["ttft"]["p95"] >= row["ttft"]["p50"] > 0
        assert row["spec_k"] == 0 and row["spec_draft"] is None
        assert row["spec_accept_rate"] is None
        assert row["tokens_per_step"] is not None


def test_serve_bench_spec_cli(monkeypatch):
    """Mirrors tests/test_serving_gateway.py::test_serve_bench_spec_cli through the
    port's CLI (its own seeded weights): the n-gram row on the repeat workload and the
    oracle ceiling row, which accepts exactly 1.0. Over JAX's weights, each row and its
    streams equal JAX's."""
    spec = ["--requests", "10", "--policy", "fifo", "--spec-k", "3"]
    (row,) = _cli_rows(spec + ["--workload", "repeat"])
    assert row["metric"] == "serve/fifo/spec3"
    assert row["spec_k"] == 3 and row["spec_draft"] == "ngram"
    assert row["workload"] == "repeat"
    assert row["spec_accept_rate"] is not None and 0.0 <= row["spec_accept_rate"] <= 1.0
    assert row["tokens_per_step"] >= 1.0
    assert row["done"] == 10  # speculation changes cost, never admission/output

    (row,) = _cli_rows(spec + ["--spec-draft", "oracle"])
    assert row["spec_accept_rate"] == 1.0
    assert row["tokens_per_step"] > row["max_slots"]

    params = smoke_params(64)
    jax_streams, port_streams = gateway_streams(monkeypatch)
    for kw in (dict(workload="repeat"), dict(spec_draft="oracle")):
        kw = dict(policies=("fifo",), requests=10, spec_k=3, **SMOKE, **kw)
        (row,) = tsb.run_serve_bench(**kw, device="cpu", params=params)
        same_row(jsb.run_serve_bench(**kw)[0], row)
    same_greedy_streams(jax_streams(), port_streams())


@pytest.mark.parametrize("layout", [{}, {"page_size": 8}], ids=["dense", "paged"])
def test_oracle_row_accepts_everything(layout, monkeypatch):
    """The oracle's references come from a drain of an engine with the row's layout and
    ``spec_k`` (its verify): on both layouts every proposal is accepted, and the row and
    its streams equal JAX's (whose references come from ``llama.generate``)."""
    kw = dict(policies=("fifo",), requests=8, spec_k=3, spec_draft="oracle", **SMOKE,
              **layout)
    jax_streams, port_streams = gateway_streams(monkeypatch)
    (row,) = tsb.run_serve_bench(**kw, device="cpu", params=smoke_params(64))
    same_row(jsb.run_serve_bench(**kw)[0], row)
    same_greedy_streams(jax_streams(), port_streams())
    assert row["spec_accept_rate"] == 1.0 and accounted(row) == 8


def test_serve_bench_half_drafter_rows(monkeypatch):
    """The ``half`` drafter (a half-depth ModelDrafter) over JAX's draft weights
    (``draft_params``): the row, its acceptance included, and its streams equal JAX's."""
    kw = dict(policies=("fifo", "edf"), requests=8, spec_k=2, spec_draft="half", **SMOKE)
    jax_streams, port_streams = gateway_streams(monkeypatch)
    rows = tsb.run_serve_bench(**kw, device="cpu", params=smoke_params(64),
                               draft_params=smoke_params(64, n_layers=1))
    for row, want in zip(rows, jsb.run_serve_bench(**kw)):
        same_row(want, row)
        assert row["spec_draft"] == "half" and row["spec_accept_rate"] is not None
    same_greedy_streams(jax_streams(), port_streams())


def test_serve_bench_paged_row_columns(monkeypatch):
    """Mirrors tests/test_serving_paged.py::test_serve_bench_paged_row_columns: paged
    rows stamp the page geometry and measured bytes, dense rows the dense equivalents;
    every KV byte column equals JAX's to the byte (fp32), and the streams JAX's."""
    kw = dict(policies=("fifo",), requests=6, max_slots=2, max_len=64, prompt_bucket=16,
              max_new=4)
    jax_streams, port_streams = gateway_streams(monkeypatch)
    params = smoke_params(64)
    (row,) = tsb.run_serve_bench(**kw, page_size=8, device="cpu", params=params)
    same_row(jsb.run_serve_bench(**kw, page_size=8)[0], row)
    assert row["page_size"] == 8 and row["kv_pages"] == 16
    assert row["max_concurrent_at_fixed_mem"] >= 1
    assert row["kv_bytes_per_request"] > 0
    (dense,) = tsb.run_serve_bench(**kw, device="cpu", params=params)
    same_row(jsb.run_serve_bench(**kw)[0], dense)
    assert dense["page_size"] == 0 and dense["kv_pages"] is None
    assert dense["kv_bytes_per_request"] > row["kv_bytes_per_request"]
    same_greedy_streams(jax_streams(), port_streams())


def test_serve_bench_multistep_rows(monkeypatch):
    """Policy rows at ``--decode-steps 4`` (engine and gateway at N = 4, paged) and
    their streams equal JAX's."""
    kw = dict(policies=("fifo", "priority"), requests=10, decode_steps=4, page_size=8,
              **SMOKE)
    jax_streams, port_streams = gateway_streams(monkeypatch)
    rows = tsb.run_serve_bench(**kw, device="cpu", params=smoke_params(64))
    for row, want in zip(rows, jsb.run_serve_bench(**kw)):
        same_row(want, row)
        assert row["decode_steps"] == 4 and accounted(row) == 10
    same_greedy_streams(jax_streams(), port_streams())

