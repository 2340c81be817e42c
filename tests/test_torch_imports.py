"""Boundaries of the PyTorch port (``accelerate_tpu_torch``).

- No module of the port, and no line of ``chip_smoke.py``, imports ``jax`` or the JAX
  package ``accelerate_tpu`` (AST scan); importing the serving engine loads none of
  them, and every module imports with them blocked (fresh interpreters).
- Entry points (the Accelerator included) default to CUDA and raise without it; the
  kernel wrappers (paged attention, fused cross-entropy) never run the kernel path on
  CPU tensors (they take the plain versions) and refuse tensors on other devices.
"""

import ast
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


@pytest.mark.parametrize("knob", [{"moe_experts": 4}, {"lora_rank": 4}, {"use_fp8": True}])
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
             lambda: fx._bwd_cuda(x, w, t, lse, g, 5.0))]


KERNEL_CALLS = {"paged_attention": _paged_calls, "fused_xent": _xent_calls}


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
