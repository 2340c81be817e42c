"""Shared pieces of the ``tests/test_torch_serve_bench_*.py`` files (the JAX reference's
pinned state, the ``smoke`` weights of both packages, the comparisons of a port
artifact with JAX's), and the test of the port's CLI root.

The benches of this slice time with the host clock, so their latencies, tokens/s and
meters differ between the frameworks and between runs. What the engine steps decide is
compared exactly: greedy streams (``record_streams``), accounting, greedy acceptance,
tokens per step, KV byte columns, handoff counts, the gates; a wall field is held only
to its presence and sign.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from accelerate_tpu.compile_cache.warmup import build_model_config
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving_gateway import ServingGateway as JaxGateway
from accelerate_tpu_torch.commands import serve_bench as tsb
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving_gateway import ServingGateway as PortGateway

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The latency blocks of a row; their ``count`` is decided by the steps.
LATENCY_BLOCKS = ("ttft", "ttft_high", "tpot", "queue_wait")

#: Fields of a policy row timed with the host clock.
ROW_WALL = ("wall_s", "tokens_per_sec")


@pytest.fixture(scope="module", autouse=True)
def pinned_jax_state():
    """The JAX reference's state for the module, whatever ran before it in the process:
    no persistent compilation cache (an executable loaded from ``tests/.jax_cache`` can
    have been compiled for another host's CPU; setting the directory alone does nothing
    once an earlier module used the cache, so it is switched off and reset) and
    synchronous CPU dispatch (with asynchronous dispatch the JAX speculative engine is
    not deterministic from run to run on a CPU; the flag is read when the client is
    made, so the client is made again, and again after the module)."""
    import jax.extend
    from jax._src import compilation_cache

    prev = (jax.config.jax_compilation_cache_dir, jax.config.jax_enable_compilation_cache,
            jax.config.values["jax_cpu_enable_async_dispatch"])
    jax.config.update("jax_compilation_cache_dir", None)
    jax.config.update("jax_enable_compilation_cache", False)
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    compilation_cache.reset_cache()
    jax.extend.backend.clear_backends()
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", prev[0])
        jax.config.update("jax_enable_compilation_cache", prev[1])
        jax.config.update("jax_cpu_enable_async_dispatch", prev[2])
        compilation_cache.reset_cache()
        jax.extend.backend.clear_backends()


def smoke_params(max_len: int, n_layers=None):
    """The port's ``smoke`` params over the JAX bench's weights (``init_params`` of
    ``build_model_config("smoke", max_len)``; with ``n_layers``, of that depth, as the
    ``half`` drafter's config)."""
    cfg = tsb._model("smoke", max_len, "cpu")[0]
    jcfg = build_model_config("smoke", max_len)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    return params_from_jax(jax.tree.map(np.asarray, jl.init_params(jcfg)), cfg, device="cpu")


def same_fields(want: dict, got: dict, fields):
    """``got`` equals ``want`` on ``fields``."""
    wrong = {k: (got[k], want[k]) for k in fields if got[k] != want[k]}
    assert not wrong, wrong


def same_row(want: dict, got: dict):
    """A port bench row against JAX's: the same keys; every field equal but the
    provenance block, the wall fields (present and positive) and the latency blocks
    (the same keys and sample counts)."""
    assert set(got) == set(want)
    skip = {"provenance", *ROW_WALL, *LATENCY_BLOCKS}
    same_fields(want, got, [k for k in want if k not in skip])
    for k in ROW_WALL:
        if k in want:
            assert (got[k] is None) == (want[k] is None) and (got[k] is None or got[k] > 0)
    for k in LATENCY_BLOCKS:
        if k in want:
            assert set(got[k]) == set(want[k]) and got[k]["count"] == want[k]["count"]
    assert got["provenance"]["device"] == "cpu" and got["provenance"]["config_fingerprint"]


def record_streams(monkeypatch, cls, keep=lambda kw: True):
    """Record every request submitted through ``cls.submit`` (a gateway class, whose
    fleet and disagg routers inherit it, or an engine class) for the rest of the test,
    when ``keep(submit keywords)``. Returns ``streams()``: for each receiver, in the order
    of its first recorded submission, each request's tokens, ``None`` for a sampled
    request (a sampled stream matches JAX's in distribution only)."""
    receivers, calls = [], {}
    submit = cls.submit

    def recording(self, *args, **kw):
        req = submit(self, *args, **kw)
        if keep(kw):
            if id(self) not in calls:
                receivers.append(self)  # kept alive, so no later receiver reuses its id
                calls[id(self)] = []
            gen = kw.get("gen")
            calls[id(self)].append((gen is None or gen.temperature == 0.0, req))
        return req

    monkeypatch.setattr(cls, "submit", recording)
    return lambda: [[[int(t) for t in req.tokens] if greedy else None
                     for greedy, req in calls[id(r)]] for r in receivers]


def gateway_streams(monkeypatch, keep=lambda kw: True):
    """``(jax, port)``: ``record_streams`` on each package's ``ServingGateway``."""
    return (record_streams(monkeypatch, JaxGateway, keep),
            record_streams(monkeypatch, PortGateway, keep))


def same_greedy_streams(want: list, got: list):
    """The port's recorded streams equal JAX's token for token on every greedy request
    (``record_streams``), and the comparison saw tokens."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert [s is None for s in g] == [s is None for s in w], i
        wrong = {j: (a, b) for j, (a, b) in enumerate(zip(g, w)) if a != b}
        assert not wrong, (i, wrong)
    assert any(s for receiver in got for s in receiver)


def accounted(row: dict) -> int:
    return row["done"] + row["rejected"] + row["shed"] + row["expired"]


def run_port_cli(args):
    """``python -m accelerate_tpu_torch ARGS`` (the CLI root) in a child process that
    must never import jax."""
    return subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy\n"
         "sys.argv = ['accelerate_tpu_torch'] + sys.argv[1:]\n"
         "try:\n"
         "    runpy.run_module('accelerate_tpu_torch', run_name='__main__', alter_sys=True)\n"
         "finally:\n"
         "    assert 'jax' not in sys.modules, 'jax was imported'\n", *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT)


def test_cli_root_registers_the_ported_commands(capsys):
    """Mirrors the JAX CLI root (``accelerate_tpu/commands/accelerate_cli.py``) for the
    ported commands: ``python -m accelerate_tpu_torch`` dispatches capsule-report,
    config, env, launch, merge-weights, metrics-dump, serve-bench and trace-report; no
    command prints the help and fails."""
    from accelerate_tpu_torch.commands.accelerate_cli import get_parser, main

    sub = next(a for a in get_parser()._actions if a.dest == "command")
    assert set(sub.choices) == {"capsule-report", "config", "env", "launch", "merge-weights",
                                "metrics-dump", "serve-bench", "trace-report"}
    assert main([]) == 1 and "serve-bench" in capsys.readouterr().out
    result = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch", "--help"],
                            capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert result.returncode == 0 and "trace-report" in result.stdout, result.stderr
