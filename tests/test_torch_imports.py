"""Boundaries of the PyTorch port (``accelerate_tpu_torch``).

- No module of the port, and no line of ``chip_smoke.py``, imports ``jax`` or the JAX
  package ``accelerate_tpu`` (AST scan); importing the serving engine loads none of
  them, and every module imports with them blocked (fresh interpreters). The serving
  gateway stack's and control plane's modules (``serving_gateway``, ``telemetry``,
  ``resilience``, ``elastic``, ``ops.collectives``, ``commands``), jax-free copies of
  host-only JAX-package modules, are each held to that by name.
- Entry points (the Accelerator included) default to CUDA and raise without it; the
  kernel wrappers (paged attention, fused cross-entropy with its vocab-sharded partial
  forward, the int8 matmul) never run the kernel path on CPU tensors (they take the
  plain versions) and refuse tensors on other devices.
- Ranks spawned by the port's ``notebook_launcher`` load no jax; a rank that raises
  fails the launch with its traceback; a multi-process state never lands on the CPU
  unasked.
"""

import ast
import functools
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "accelerate_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "accelerate_tpu")


def _absolute_imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _absolute_imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_serving_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import accelerate_tpu_torch.serving, accelerate_tpu_torch.models.convert;"
        "import accelerate_tpu_torch.ops.quantization, accelerate_tpu_torch.utils.cuda_graph;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r);"
        "print(bad); sys.exit(1 if bad else 0)" % (FORBIDDEN,)
    )
    res = subprocess.run([sys.executable, "-I", "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_module_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, imports in a fresh interpreter where
    importing jax or the JAX package raises, and none of them gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "FORBIDDEN = %r\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in FORBIDDEN:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import accelerate_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(accelerate_tpu_torch.__path__,\n"
        "                                              'accelerate_tpu_torch.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 15 else 0)\n" % (FORBIDDEN,)
    )
    res = subprocess.run([sys.executable, "-I", "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


#: The gateway stack's and telemetry pipeline's modules: the JAX package's versions of
#: most import no jax either, so the port's copies must not reach for the JAX package's
#: instead of their own.
GATEWAY_MODULES = (
    "accelerate_tpu_torch.serving_gateway", "accelerate_tpu_torch.serving_gateway.policies",
    "accelerate_tpu_torch.serving_gateway.gateway", "accelerate_tpu_torch.serving_gateway.fleet",
    "accelerate_tpu_torch.serving_gateway.disagg", "accelerate_tpu_torch.telemetry",
    "accelerate_tpu_torch.telemetry.clocks", "accelerate_tpu_torch.telemetry.slo",
    "accelerate_tpu_torch.telemetry.schemas", "accelerate_tpu_torch.resilience",
    "accelerate_tpu_torch.resilience.faults", "accelerate_tpu_torch.elastic",
    "accelerate_tpu_torch.ops.collectives", "accelerate_tpu_torch.telemetry.core",
    "accelerate_tpu_torch.telemetry.tracing", "accelerate_tpu_torch.telemetry.timing",
    "accelerate_tpu_torch.telemetry.memory", "accelerate_tpu_torch.telemetry.derived",
    "accelerate_tpu_torch.telemetry.compile_monitor", "accelerate_tpu_torch.telemetry.steady",
    "accelerate_tpu_torch.commands.trace_report",
    "accelerate_tpu_torch.telemetry.metrics", "accelerate_tpu_torch.telemetry.alerts",
    "accelerate_tpu_torch.telemetry.exporter", "accelerate_tpu_torch.telemetry.provenance",
    "accelerate_tpu_torch.telemetry.recorder", "accelerate_tpu_torch.serving_gateway.workload",
    "accelerate_tpu_torch.serving_gateway.autoscaler",
    "accelerate_tpu_torch.commands.metrics_dump", "accelerate_tpu_torch.commands.capsule_report",
    "accelerate_tpu_torch.commands.serve_bench",
    "accelerate_tpu_torch.commands.accelerate_cli", "accelerate_tpu_torch.__main__",
)


@functools.lru_cache(maxsize=None)
def _gateway_imports() -> dict:
    """{module: modules of ``FORBIDDEN`` loaded once it is imported} for each of
    :data:`GATEWAY_MODULES`, imported in turn in one fresh interpreter where importing
    jax or the JAX package raises."""
    code = (
        "import importlib, json, sys\n"
        "FORBIDDEN = %r\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in FORBIDDEN:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "out = {}\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "    out[m] = sorted(k for k in sys.modules if k.split('.')[0] in FORBIDDEN)\n"
        "print(json.dumps(out))\n" % (FORBIDDEN, GATEWAY_MODULES)
    )
    res = subprocess.run([sys.executable, "-I", "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", GATEWAY_MODULES)
def test_gateway_stack_module_imports_with_jax_blocked(module):
    assert _gateway_imports()[module] == []
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    bad = [m for m in _absolute_imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{module} imports {bad}"


def test_serve_bench_and_smoke_entry_points_default_to_cuda(monkeypatch):
    """``serve_bench``'s ``run_*``, ``metrics_dump --smoke`` and the CLI root's
    ``serve-bench`` run on the card unless the caller asks for the CPU: without CUDA
    they raise, never fall back."""
    from accelerate_tpu_torch.commands import serve_bench
    from accelerate_tpu_torch.commands.accelerate_cli import main
    from accelerate_tpu_torch.commands.metrics_dump import run_metrics_smoke
    from accelerate_tpu_torch.serving_gateway.workload import generate_workload

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: serve_bench.run_chaos_bench(requests=2),
                 lambda: serve_bench.run_fleet_chaos_bench(requests=2),
                 lambda: serve_bench.run_autoscale_bench(requests=2),
                 lambda: serve_bench.run_trace_replay(generate_workload("poisson", 2)),
                 lambda: serve_bench.run_serve_bench(requests=2),
                 lambda: serve_bench.run_trace_curves(requests=2),
                 lambda: serve_bench.run_disagg_bench(requests=2),
                 lambda: serve_bench.run_paged_compare(requests=2),
                 lambda: serve_bench.run_multistep_bench(requests=2),
                 lambda: serve_bench.run_spec_bench(requests=2),
                 lambda: main(["serve-bench", "--smoke", "--requests", "2"]),
                 lambda: main(["serve-bench", "--disagg", "1:1", "--smoke"]),
                 lambda: run_metrics_smoke(verbose=False)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_entry_points_default_to_cuda(monkeypatch):
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax
    from accelerate_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.CONFIGS["tiny"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"embed": None, "layers": [], "ln_f": None}, cfg)
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator(mixed_precision="bf16")
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    assert Accelerator(device="cpu").device == torch.device("cpu")
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    assert resolve_device("cpu") == torch.device("cpu")
    params = llama.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"


@pytest.mark.parametrize("knob", [{"moe_experts": 4}])
def test_unsupported_knobs_raise(knob):
    import dataclasses

    from accelerate_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.CONFIGS["tiny"], **knob)
    with pytest.raises(NotImplementedError):
        llama.init_params(cfg, device="cpu")


def _small_paged_inputs(device):
    from accelerate_tpu_torch.models.common import paged_kv_planes

    pool = paged_kv_planes(4, 4, 1, 64, torch.float32, False, device)
    q = torch.ones((1, 1, 2, 64), device=device)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=device)
    positions = torch.zeros((1,), dtype=torch.int32, device=device)
    valid = torch.ones((1, 8), dtype=torch.bool, device=device)
    return q, pool, tables, positions, valid


def _small_xent_inputs(device):
    x = torch.linspace(-1, 1, 3 * 16, device=device).reshape(3, 16)
    w = torch.linspace(-1, 1, 16 * 24, device=device).reshape(16, 24)
    t = torch.tensor([0, 23, -1], device=device)
    g = torch.ones(3, device=device)
    return x, w, t, g


def _paged_calls(device):
    """(wrapper call, plain call, launch counter owner, CUDA launcher call) of the
    paged-attention kernel."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    args = _small_paged_inputs(device)
    kw = dict(page_size=4, sm_scale=0.125)
    return [(lambda: pa.paged_attention(*args, **kw),
             lambda: pa.paged_attention_reference(*args, **kw), pa.paged_attention,
             lambda: pa.paged_attention_cuda(*args, **kw))]


def _xent_calls(device):
    """The same for the fused cross-entropy's forward and backward."""
    from accelerate_tpu_torch.ops import fused_xent as fx

    x, w, t, g = _small_xent_inputs(device)
    lse = torch.zeros(3, device=device)
    return [(lambda: fx._fwd(x, w, t, 5.0), lambda: fx.fused_xent_reference(x, w, t, 5.0),
             fx._fwd, lambda: fx._fwd_cuda(x, w, t, 5.0)),
            (lambda: fx._bwd(x, w, t, lse, g, 5.0),
             lambda: (fx.fused_xent_dx_reference(x, w, t, lse, g, 5.0),
                      fx.fused_xent_dw_reference(x, w, t, lse, g, 5.0)), fx._bwd,
             lambda: fx._bwd_cuda(x, w, t, lse, g, 5.0)),
            (lambda: fx._fwd_partial(x, w, t - 8, 5.0),
             lambda: fx.fused_xent_partial_reference(x, w, t - 8, 5.0), fx._fwd_partial,
             lambda: fx._fwd_partial_cuda(x, w, t - 8, 5.0))]


def _int8_calls(device):
    """The same for the int8 weight-only matmul (fp32 and bf16 x)."""
    from accelerate_tpu_torch.ops import quantization as qz

    qw = qz.quantize_weight(torch.linspace(-1, 1, 16 * 24).reshape(16, 24)).to(device)
    calls = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.linspace(-1, 1, 3 * 16).reshape(3, 16).to(device=device, dtype=dtype)
        calls.append((lambda x=x: qz.int8_matmul(x, qw.data, qw.scales, dtype),
                      lambda x=x: qz.int8_matmul_reference(x, qw.data, qw.scales, dtype),
                      qz.int8_matmul,
                      lambda x=x: qz.int8_matmul_cuda(x, qw.data, qw.scales, dtype)))
    return calls


KERNEL_CALLS = {"paged_attention": _paged_calls, "fused_xent": _xent_calls,
                "int8_matmul": _int8_calls}


def _tensors(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("kernel", list(KERNEL_CALLS))
def test_kernel_wrapper_cpu_takes_plain_version(monkeypatch, kernel):
    """On CPU tensors the wrapper runs the plain version: it neither builds nor
    launches the kernel, and the launch count does not move."""
    from accelerate_tpu_torch.ops import _build

    def no_build(*_a, **_k):
        raise AssertionError("the CUDA kernel was built or loaded for CPU tensors")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    for call, plain, owner, _ in KERNEL_CALLS[kernel]("cpu"):
        before = owner.launches
        for got, want in zip(_tensors(call()), _tensors(plain()), strict=True):
            assert torch.equal(got, want)
        assert owner.launches == before


@pytest.mark.parametrize("kernel", list(KERNEL_CALLS))
def test_kernel_launcher_raises_on_cpu_tensors(kernel):
    """The CUDA launcher refuses CPU tensors (it never computes them), and the
    wrapper refuses tensors that are neither CPU nor CUDA."""
    for _, _, _, cuda_call in KERNEL_CALLS[kernel]("cpu"):
        with pytest.raises(ValueError, match="must be on CUDA"):
            cuda_call()
    for call, _, _, _ in KERNEL_CALLS[kernel]("meta"):
        with pytest.raises(ValueError, match="must be on CUDA"):
            call()


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """The CUDA build raises when no ``nvcc`` is found — nothing falls back."""
    from accelerate_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["paged_attention"])


def test_spawned_ranks_load_no_jax():
    import torch_tp_ranks
    from accelerate_tpu_torch.launchers import notebook_launcher

    loaded = notebook_launcher(torch_tp_ranks.loaded_modules, (FORBIDDEN,), 2, device="cpu",
                               backend="gloo", timeout_s=60)
    assert loaded == [[], []]


def test_failed_rank_fails_the_launch():
    import torch_tp_ranks
    from accelerate_tpu_torch.launchers import notebook_launcher

    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\\n)*told to fail"):
        notebook_launcher(torch_tp_ranks.raise_on_rank, (1,), 2, device="cpu", backend="gloo",
                          timeout_s=60)
    assert notebook_launcher(torch_tp_ranks.raise_on_rank, (5,), 1) == [0]  # in-process


def test_multi_process_state_defaults_to_cuda(monkeypatch):
    """A rank of a multi-process run asks for CUDA unless the CPU is named: without
    CUDA it raises before joining any group."""
    from accelerate_tpu_torch.state import PartialState

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    PartialState._reset_state()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PartialState()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PartialState(backend="gloo")
    finally:
        PartialState._reset_state()
