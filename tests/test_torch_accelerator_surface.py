"""The Accelerator's process-control and gradient surface against the JAX package's, on
the CPU at fp32 (one process; the multi-rank cases are in
``test_torch_process_control.py``).

Mirrors ``tests/test_accelerator.py`` (``backward`` raising with guidance, gradient
accumulation inside and outside ``accumulate()``, the sync at a data loader's end, the
``accumulate``/``no_sync`` flags, ``clip_grad_norm_``/``clip_grad_value_`` in the step,
``value_and_grad``) and ``tests/test_state.py`` (``main_process_first``, the ``on_*``
decorators, ``split_between_processes`` with padding of an empty share). The same
regression data and weights, made from numpy seeds, go through both packages.

Tolerances: params after training and the accumulation buffer rtol 1e-6 / atol 1e-7
(fp32 sums of 8-16 rows in another order); ``value_and_grad`` rtol 1e-6 / atol 1e-7
in fp32, and under a bf16 policy rtol 2e-2 / atol 1e-3 (XLA and torch's CPU kernels
round bf16 in other places).

Also the port's own rules: ``sync_each_batch``, a step built before ``clip_grad_value_``
keeps no clamp, an apply inside ``accumulate()`` before the window is full divides by
``gradient_accumulation_steps``, and the two recorded deviations (``local_process_index``
is ``LOCAL_RANK``; a tensor's share stays a tensor).
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import accelerator as jacc_mod
from accelerate_tpu import state as jstate_mod
from accelerate_tpu.accelerator import Accelerator as JAccelerator
from accelerate_tpu.data_loader import DataLoader as JDataLoader
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.utils import GradientAccumulationPlugin as JPlugin
from accelerate_tpu.utils import TensorParallelPlugin as JTensorParallelPlugin
from accelerate_tpu_torch import Accelerator, TensorParallelPlugin, optim
from accelerate_tpu_torch.data_loader import DataLoader
from accelerate_tpu_torch.parallel import MeshConfig
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils import GradientAccumulationPlugin

TIGHT = {"rtol": 1e-6, "atol": 1e-7}


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


class RegressionDataset:
    """y = x·w + 1 + noise, from a numpy seed (the JAX tests' dataset)."""

    def __init__(self, n=32, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, 4)).astype(np.float32)
        w = np.array([[2.0], [-1.0], [0.5], [3.0]], dtype=np.float32)
        self.y = (self.x @ w + 1.0 + 0.01 * rng.normal(size=(n, 1))).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=(4, 8))).astype(np.float32),
            "b": np.zeros(8, np.float32),
            "head": (0.1 * rng.normal(size=(8, 1))).astype(np.float32)}


def jax_loss(params, batch):
    x, y = (batch[k].astype(params["w"].dtype) for k in ("x", "y"))
    h = jnp.tanh(x @ params["w"] + params["b"])
    return jnp.mean((h @ params["head"] - y) ** 2)


def torch_loss(params, batch):
    x, y = (batch[k].to(params["w"].dtype) for k in ("x", "y"))
    h = torch.tanh(x @ params["w"] + params["b"])
    return ((h @ params["head"] - y) ** 2).mean()


def torch_params(seed=0):
    return {k: torch.tensor(v) for k, v in np_params(seed).items()}


def jax_params(seed=0):
    return {k: jnp.asarray(v) for k, v in np_params(seed).items()}


def assert_trees_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **tol)


def as_numpy(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def run_both(n, batch_size, lr, in_accumulate, acc_kw=None, clip=None, ctx="accumulate"):
    """The same loop over a prepared data loader in both packages: per batch a step, in
    ``acc.accumulate()`` (or ``acc.no_sync()``) when asked, the sync flag after it.
    ``clip``: ``clip_grad_*_`` calls made before the step is built. Returns
    ``(port, jax)``, each ``(flags, state)``."""
    ds = RegressionDataset(n)
    out = []
    for pkg in ("torch", "jax"):
        acc = (Accelerator(device="cpu", **(acc_kw or {})) if pkg == "torch"
               else JAccelerator(**(acc_kw or {})))
        dl = acc.prepare((DataLoader if pkg == "torch" else JDataLoader)(ds, batch_size=batch_size))
        sgd = optim.sgd(lr) if pkg == "torch" else optax.sgd(lr)
        state = acc.create_train_state(torch_params() if pkg == "torch" else jax_params(), sgd)
        for name, value in (clip or {}).items():
            getattr(acc, name)(value)
        step = acc.build_train_step(torch_loss if pkg == "torch" else jax_loss)
        flags = []
        for batch in dl:
            if in_accumulate:
                with getattr(acc, ctx)():
                    state, _ = step(state, batch)
            else:
                state, _ = step(state, batch)
            flags.append(acc.sync_gradients)
        out.append((flags, state))
        if pkg == "jax":
            jstate_mod.AcceleratorState._reset_state()
            jstate_mod.GradientState._reset_state()
    return out


def test_backward_raises_with_guidance():
    for acc, loss in ((Accelerator(device="cpu"), torch.ones(())), (JAccelerator(), jnp.ones(()))):
        with pytest.raises(RuntimeError, match="build_train_step") as err:
            acc.backward(loss)
        assert "value_and_grad" in str(err.value)


@pytest.mark.parametrize("in_accumulate", [False, True], ids=["plain", "accumulate"])
@pytest.mark.parametrize("n,accum,want_flags,want_steps", [
    (32, 4, [False, False, False, True], 1),      # test_gradient_accumulation_parity
    (24, 2, [False, True, True], 2),              # ..._syncs_at_dataloader_end
], ids=["parity", "syncs_at_dataloader_end"])
def test_gradient_accumulation_matches_jax(in_accumulate, n, accum, want_flags, want_steps):
    (tflags, tstate), (jflags, jstate) = run_both(
        n, 8, 0.1, in_accumulate, {"gradient_accumulation_steps": accum})
    assert tflags == jflags == want_flags
    assert tstate.step == int(jstate.step) == want_steps
    assert_trees_close(as_numpy(tstate.params), jstate.params, **TIGHT)


@pytest.mark.parametrize("sync_each_batch", [False, True])
def test_accumulate_context_manager_flags(sync_each_batch):
    flags = {}
    for pkg in ("torch", "jax"):
        plugin = (GradientAccumulationPlugin if pkg == "torch" else JPlugin)(
            num_steps=2, sync_each_batch=sync_each_batch)
        acc = (Accelerator(device="cpu", gradient_accumulation_plugin=plugin) if pkg == "torch"
               else JAccelerator(gradient_accumulation_plugin=plugin))
        flags[pkg] = []
        for _ in range(4):
            with acc.accumulate():
                flags[pkg].append(acc.sync_gradients)
    want = [True] * 4 if sync_each_batch else [False, True, False, True]
    assert flags["torch"] == flags["jax"] == want


def test_no_sync_context_flags():
    for acc in (Accelerator(device="cpu"), JAccelerator()):
        assert acc.sync_gradients
        with acc.no_sync():
            assert not acc.sync_gradients
        assert acc.sync_gradients


@pytest.mark.parametrize("accum", [1, 2])
def test_no_sync_accumulates_and_never_applies(accum):
    """Two batches inside ``no_sync()`` leave the params as they were and the
    accumulation buffer holding the sum of both gradients, as JAX's do."""
    (tflags, tstate), (jflags, jstate) = run_both(
        16, 8, 0.1, True, {"gradient_accumulation_steps": accum}, ctx="no_sync")
    assert tflags == jflags == [True, True]  # restored on exit
    assert tstate.step == int(jstate.step) == 0
    assert_trees_close(as_numpy(tstate.params), np_params(), rtol=0, atol=0)
    assert_trees_close(as_numpy(tstate.grad_accum), jstate.grad_accum, **TIGHT)
    ds = RegressionDataset(16)
    want = {k: np.zeros_like(v) for k, v in np_params().items()}
    for i in (0, 8):
        grads = jax.grad(jax_loss)(jax_params(), {"x": ds.x[i:i + 8], "y": ds.y[i:i + 8]})
        want = {k: want[k] + np.asarray(grads[k]) for k in want}
    assert_trees_close(as_numpy(tstate.grad_accum), want, **TIGHT)


@pytest.mark.parametrize("clip", [
    {"clip_grad_norm_": 1e-4},                            # test_clip_grad_norm_in_step
    {"clip_grad_value_": 1e-3},                           # test_clip_grad_value_in_step
    {"clip_grad_value_": 1e-2, "clip_grad_norm_": 3e-2},  # clamp, then the norm of it
], ids=["norm", "value", "value_then_norm"])
def test_clip_grad_in_step_matches_jax(clip):
    (_, tstate), (_, jstate) = run_both(16, 16, 1.0, False, clip=clip)
    assert_trees_close(as_numpy(tstate.params), jstate.params, **TIGHT)
    moved = np.abs(as_numpy(tstate.params)["w"] - np_params()["w"]).max()
    assert moved <= min(2 * clip.get("clip_grad_norm_", np.inf),  # lr 1: |step| <= norm
                        clip.get("clip_grad_value_", np.inf) + 1e-7)


def test_clip_grad_value_reaches_only_steps_built_after():
    ds = RegressionDataset(16)
    batch = {"x": torch.tensor(ds.x), "y": torch.tensor(ds.y)}
    acc = Accelerator(device="cpu")
    before = acc.build_train_step(torch_loss, optim.sgd(1.0))
    acc.clip_grad_value_(1e-3)
    after = acc.build_train_step(torch_loss, optim.sgd(1.0))
    moved = {}
    for name, step in (("before", before), ("after", after)):
        state = acc.create_train_state(torch_params(), optim.sgd(1.0))
        state, _ = step(state, batch)
        moved[name] = np.abs(as_numpy(state.params)["w"] - np_params()["w"]).max()
    assert moved["after"] <= 1e-3 + 1e-7 < moved["before"]


def test_apply_before_the_window_is_full_averages():
    """``sync_each_batch`` applies at every ``accumulate()`` entry: each apply divides
    the one batch's gradient by ``gradient_accumulation_steps``, as JAX's does."""
    plugins = {"torch": GradientAccumulationPlugin(num_steps=4, sync_each_batch=True),
               "jax": JPlugin(num_steps=4, sync_each_batch=True)}
    ds = RegressionDataset(8)
    out = {}
    for pkg, plugin in plugins.items():
        if pkg == "torch":
            acc = Accelerator(device="cpu", gradient_accumulation_plugin=plugin)
            state = acc.create_train_state(torch_params(), optim.sgd(0.5))
            step = acc.build_train_step(torch_loss)
            batch = {"x": torch.tensor(ds.x), "y": torch.tensor(ds.y)}
        else:
            acc = JAccelerator(gradient_accumulation_plugin=plugin)
            state = acc.create_train_state(jax_params(), optax.sgd(0.5))
            step = acc.build_train_step(jax_loss)
            batch = {"x": jnp.asarray(ds.x), "y": jnp.asarray(ds.y)}
        with acc.accumulate():
            state, _ = step(state, batch)
        out[pkg] = state
    assert out["torch"].step == int(out["jax"].step) == 1
    assert_trees_close(as_numpy(out["torch"].params), out["jax"].params, **TIGHT)
    grads = jax.grad(jax_loss)(jax_params(), {"x": ds.x, "y": ds.y})
    want = {k: np_params()[k] - 0.5 * np.asarray(grads[k]) / 4 for k in grads}
    assert_trees_close(as_numpy(out["torch"].params), want, **TIGHT)


@pytest.mark.parametrize("precision", ["no", "bf16"])
@pytest.mark.parametrize("has_aux", [False, True])
def test_value_and_grad_matches_jax(precision, has_aux):
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(4, 4)).astype(np.float32), rng.normal(size=(4, 1)).astype(np.float32)
    tol = TIGHT if precision == "no" else {"rtol": 2e-2, "atol": 1e-3}

    def with_aux(loss):
        return (lambda p, b: (loss(p, b), {"scale": 2 * loss(p, b)})) if has_aux else loss

    tparams = torch_params()
    copies = {k: v.clone() for k, v in tparams.items()}
    tvg = Accelerator(device="cpu", mixed_precision=precision).value_and_grad(
        with_aux(torch_loss), has_aux=has_aux)
    tout, tgrads = tvg(tparams, {"x": torch.tensor(x), "y": torch.tensor(y)})
    jvg = JAccelerator(mixed_precision=precision).value_and_grad(
        with_aux(jax_loss), has_aux=has_aux)
    jout, jgrads = jvg(jax_params(), {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tloss, taux = tout if has_aux else (tout, None)
    jloss, jaux = jout if has_aux else (jout, None)
    np.testing.assert_allclose(float(tloss), float(jloss), **tol)
    if has_aux:
        np.testing.assert_allclose(float(taux["scale"]), float(jaux["scale"]), **tol)
    assert all(g.dtype == torch.float32 and not g.requires_grad for g in tgrads.values())
    assert_trees_close(as_numpy(tgrads), jgrads, **tol)
    assert all(torch.equal(tparams[k], copies[k]) and not tparams[k].requires_grad
               for k in tparams)  # the caller's tensors are left as they were


def test_trigger_single_process():
    for acc in (Accelerator(device="cpu"), JAccelerator()):
        assert acc.check_trigger() is False
        acc.set_trigger()
        assert acc.check_trigger() is True
        assert acc.check_trigger() is False


def _jax_names(obj, lo, hi) -> set:
    """The methods and properties a JAX class defines between source lines lo and hi."""
    lines, start = inspect.getsourcelines(obj)
    names = set()
    for offset, line in enumerate(lines):
        m = re.match(r"    def (\w+)\(", line)
        if m and lo <= start + offset <= hi and not m.group(1).startswith("_"):
            names.add(m.group(1))
    return names


def test_the_port_has_the_jax_surface():
    """Every public method and property of JAX's ``PartialState`` (``state.py:170-300``)
    and ``Accelerator`` (``accelerator.py:606-728``, ``:1452-1658``; ``profile`` stays
    unported with the tracking and profiler items) exists on the port's classes."""
    state = _jax_names(jstate_mod.PartialState, 170, 300)
    acc = (_jax_names(jacc_mod.Accelerator, 606, 728)
           | _jax_names(jacc_mod.Accelerator, 1452, 1658)) - {"profile"}
    assert {"split_between_processes", "on_process", "print", "use_distributed"} <= state
    assert {"accumulate", "no_sync", "value_and_grad", "check_trigger", "is_last_process"} <= acc
    assert sorted(n for n in state if not hasattr(PartialState, n)) == []
    assert sorted(n for n in acc if not hasattr(Accelerator, n)) == []


def test_process_control_single_process_matches_jax():
    """``test_state.py``: ``main_process_first`` runs its body; the decorators run on
    the only process, as JAX's do."""
    for state in (PartialState(cpu=True), JPartialState()):
        body = []
        with state.main_process_first():
            body.append(1)
        with state.local_main_process_first():
            body.append(2)
        assert body == [1, 2]
        assert state.is_main_process and state.is_local_main_process and state.is_last_process
        calls = [state.on_main_process(lambda: "main")(),
                 state.on_local_main_process(lambda: "local")(),
                 state.on_process(process_index=0)(lambda: "zero")(),
                 state.on_process(lambda: "one", process_index=1)(),
                 state.on_last_process(lambda: "last")()]
        assert calls == ["main", "local", "zero", None, "last"]
    # use_distributed: more than one device in the job (JAX counts its virtual CPU
    # devices, the port its processes, one device each).
    assert PartialState(cpu=True).use_distributed is False
    assert JPartialState().use_distributed is (jax.device_count() > 1)


def test_accelerator_print_on_main(capsys):
    acc = Accelerator(device="cpu")
    acc.print("only", "main", sep="-")
    assert capsys.readouterr().out == "only-main\n"


INPUTS = {
    "list": lambda: [1, 2],
    "tuple": lambda: (1, 2, 3),
    "numpy": lambda: np.arange(2),
    "numpy_2d": lambda: np.arange(10).reshape(5, 2),
    "tensor": lambda: torch.arange(2, dtype=torch.int16),
    "tensor_2d": lambda: torch.arange(10.0).reshape(5, 2),
    "dict": lambda: {"a": [1, 2, 3], "b": np.arange(3)},
}


def _faked(state, n, index):
    state.__dict__["num_processes"], state.__dict__["process_index"] = n, index


@pytest.mark.parametrize("padding", [False, True])
@pytest.mark.parametrize("kind", list(INPUTS))
def test_split_between_processes_matches_jax(kind, padding):
    """``test_state.py:131``: every share of 4 faked processes, padded (an empty share
    takes the global last element) or not, against JAX's. A tensor's share stays a
    tensor of its dtype (the deviation): its values are JAX's numpy share's."""
    port, ref = PartialState(cpu=True), JPartialState()
    try:
        for index in range(4):
            _faked(port, 4, index)
            _faked(ref, 4, index)
            inputs = INPUTS[kind]()
            with port.split_between_processes(inputs, apply_padding=padding) as got:
                pass
            with ref.split_between_processes(inputs, apply_padding=padding) as want:
                pass
            pairs = ([(got[k], want[k]) for k in want] if kind == "dict" else [(got, want)])
            for g, w in pairs:
                if torch.is_tensor(inputs):  # JAX: the slice, or numpy once padded
                    assert torch.is_tensor(g) and g.dtype == inputs.dtype
                    g, w = g.numpy(), np.asarray(w)
                assert type(g) is type(w)
                if isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
                else:
                    assert g == w
    finally:
        _faked(port, 1, 0)
        _faked(ref, 1, 0)


def test_local_process_index_is_local_rank(monkeypatch):
    """The deviation: one process per card, so the local index is ``LOCAL_RANK`` (JAX
    runs one process per host: always 0) and a non-zero local rank is not the local
    main process."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    state = PartialState(cpu=True)
    assert state.local_process_index == 1 and not state.is_local_main_process
    assert state.on_local_main_process(lambda: "ran")() is None
    assert state.is_main_process  # RANK 0 of a world of 1
    assert JPartialState().local_process_index == 0


def test_join_uneven_inputs_and_autocast():
    acc = Accelerator(device="cpu")
    even = acc.dataloader_config.even_batches
    with acc.join_uneven_inputs([], even_batches=not even):
        assert acc.dataloader_config.even_batches is (not even)
    assert acc.dataloader_config.even_batches is even
    with acc.autocast():
        pass


def test_tp_plugin_fields_and_one_process_layout():
    """``TensorParallelPlugin`` has JAX's fields and defaults; ``tp_plugin=`` is a
    constructor argument (``tp_size=1`` on one process: no mesh, as with no plugin); a
    mesh config that disagrees with the plugin raises."""
    assert TensorParallelPlugin().to_dict() == JTensorParallelPlugin().to_dict()
    acc = Accelerator(device="cpu", tp_plugin=TensorParallelPlugin(tp_size=1))
    assert acc.state.tp_plugin == TensorParallelPlugin(tp_size=1) and acc.mesh is None
    AcceleratorState._reset_state()
    with pytest.raises(ValueError, match="disagrees with tp_plugin"):
        Accelerator(device="cpu", tp_plugin=TensorParallelPlugin(tp_size=2),
                    mesh_config=MeshConfig(tp=1))
    assert not AcceleratorState._shared_state  # a failed construction stores nothing
    with pytest.raises(ValueError, match="does not divide"):
        Accelerator(device="cpu", tp_plugin=TensorParallelPlugin(tp_size=2))
