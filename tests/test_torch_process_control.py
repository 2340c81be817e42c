"""The Accelerator's process control and ``tp_plugin=`` on two gloo ranks on the CPU
(one spawn of the port's ``notebook_launcher``; the rank functions are in
``tests/torch_tp_ranks.py``), against the JAX package where it has a counterpart.

- ``main_process_first`` and ``local_main_process_first``: the first process writes to
  a file before the other (it sleeps first, so an unordered body would show).
- ``split_between_processes`` on each rank, with and without padding, over lists,
  numpy arrays, tensors, a dict and an input shorter than the world (an empty share
  padded with the global last element): each share equals the JAX ``PartialState``'s for
  that process; a tensor's share stays a tensor of its dtype (the recorded deviation).
- ``on_main_process``, ``on_local_main_process``, ``on_process``, ``on_last_process``
  run on their rank only; ``check_trigger`` after one rank's ``set_trigger`` is True on
  both ranks, then False.
- ``Accelerator(tp_plugin=TensorParallelPlugin(tp_size=2))`` lays the ranks out as
  ``mesh_config=MeshConfig(tp=2)`` does and trains 2 steps to the same losses and grad
  norms (bitwise: the same program); both within rtol 1e-5 of the JAX
  ``Accelerator(tp_plugin=...)`` on dp4×tp2 virtual devices (the loss is a global mean;
  only the order of sums differs). A ``mesh_config`` that disagrees with the plugin
  raises and leaves the state uninitialized.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from accelerate_tpu import accelerator as jacc
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fused_optim as jfo
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.utils import TensorParallelPlugin as JTensorParallelPlugin
from accelerate_tpu_torch.launchers import notebook_launcher

SPLIT_CASES = {
    "list": [1, 2, 3],
    "one": [7],
    "numpy": np.arange(6).reshape(3, 2),
    "tensor": [1.5, 2.5, 3.5],
    "tensor_one": [4],
    "dict": {"a": [1, 2, 3], "b": np.arange(3)},
}
CFG = {"loss_impl": "fused_tp", "attn_impl": "xla"}
LR, CLIP, STEPS = 1e-3, 0.05, 2


def _np_params():
    cfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, **CFG)
    return jax.tree.map(np.array, jl.init_params(cfg, jax.random.PRNGKey(3)))


def _batches():
    rng = np.random.default_rng(11)
    return [{"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32),
             "mask": np.ones((4, 17), np.float32)} for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _ranks(order_file):
    jobs = [("process_control", (order_file, SPLIT_CASES)),
            ("tp_plugin_steps", (_np_params(), _batches(), CFG, LR, CLIP))]
    return notebook_launcher(torch_tp_ranks.run_all, (jobs,), 2, device="cpu",
                             backend="gloo", timeout_s=300)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    order = str(tmp_path_factory.mktemp("order") / "writes")
    return order, _ranks(order)


def test_main_process_first_orders_the_writes(ranks):
    order, results = ranks
    for name in ("main_process_first", "local_main_process_first"):
        with open(f"{order}.{name}") as f:
            assert f.read().split() == ["0", "1"], name
    assert [r[0]["local_process_index"] for r in results] == [0, 1]  # LOCAL_RANK
    assert [r[0]["is_last_process"] for r in results] == [False, True]
    assert all(r[0]["use_distributed"] for r in results)


def _jax_share(kind, padding, index):
    state = JPartialState()
    state.__dict__["num_processes"], state.__dict__["process_index"] = 2, index
    try:
        inputs = SPLIT_CASES[kind]
        if kind.startswith("tensor"):
            inputs = torch.tensor(inputs)
        with state.split_between_processes(inputs, apply_padding=padding) as share:
            return share
    finally:
        state.__dict__["num_processes"], state.__dict__["process_index"] = 1, 0


def _same_share(got, want, kind):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_share(got[k], want[k], kind)
    elif kind.startswith("tensor"):
        # The deviation: a tensor's share is a tensor of its dtype; JAX gives the slice
        # (a tensor) or, once padded, numpy. The values agree.
        tag, dtype, values = got
        assert tag == "tensor" and dtype == str(torch.tensor(SPLIT_CASES[kind]).dtype)
        np.testing.assert_array_equal(values, np.asarray(want))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("padding", [False, True])
@pytest.mark.parametrize("kind", list(SPLIT_CASES))
def test_split_between_processes_on_each_rank(ranks, kind, padding):
    _, results = ranks
    for index, r in enumerate(results):
        got = r[0]["split"][kind, padding]
        _same_share(got, _jax_share(kind, padding, index), kind)
        if padding and kind in ("one", "tensor_one"):  # the empty share, padded
            values = got[2] if kind == "tensor_one" else got
            assert list(np.asarray(values)) == list(np.asarray(SPLIT_CASES[kind]))


def test_on_process_decorators_and_trigger(ranks):
    _, results = ranks
    assert [r[0]["on"] for r in results] == [
        {"main": 0, "local_main": 0, "process_1": None, "last": None},
        {"main": None, "local_main": None, "process_1": 1, "last": 1}]
    assert [r[0]["trigger"] for r in results] == [[True, False], [True, False]]


def _jax_tp_plugin_losses():
    cfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, **CFG)
    acc = jacc.Accelerator(tp_plugin=JTensorParallelPlugin(tp_size=2))
    state = acc.create_train_state(jax.tree.map(jnp.asarray, _np_params()), jfo.fused_adamw(LR),
                                   partition_specs=jl.partition_specs(cfg))
    step = acc.build_train_step(lambda p, b: jl.loss_fn(p, b, cfg), max_grad_norm=CLIP)
    losses, norms = [], []
    for batch in _batches():
        state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    mesh = dict(zip(acc.mesh.axis_names, acc.mesh.devices.shape))
    JAcceleratorState._reset_state()
    return losses, norms, mesh


def test_tp_plugin_trains_as_the_mesh_config(ranks):
    _, results = ranks
    want_losses, want_norms, jax_mesh = _jax_tp_plugin_losses()
    assert jax_mesh["tp"] == 2  # the JAX plugin's tp axis (dp takes its other devices)
    for r in results:
        got = r[1]
        plugin, mesh = got["tp_plugin"], got["mesh_config"]
        assert plugin["mesh"] == mesh["mesh"] and plugin["mesh"]["tp"] == 2
        assert plugin["mesh"]["dp"] == 1
        assert plugin["distributed_type"] == mesh["distributed_type"] == "TP"
        assert plugin["losses"] == mesh["losses"]
        assert plugin["grad_norms"] == mesh["grad_norms"]
        np.testing.assert_allclose(plugin["losses"], want_losses, rtol=1e-5)
        np.testing.assert_allclose(plugin["grad_norms"], want_norms, rtol=1e-5)
        assert got["disagreeing"] is not None and "disagrees with tp_plugin" in got["disagreeing"]
        assert got["left_uninitialized"]
    assert results[0][1]["tp_plugin"]["losses"] == results[1][1]["tp_plugin"]["losses"]

