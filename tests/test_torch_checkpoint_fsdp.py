"""The port's ZeRO/FSDP checkpoints on the CPU: FULL_STATE_DICT, the format switch and
the reshard on load, with 2 spawned gloo ranks (one spawn) and this process as the one
rank, on JAX's ``tests/test_zero.py`` problem (``fused_adamw(1e-2)``,
``min_weight_size=1``).

- FULL round trip (``test_zero.py:157``): a ZeRO-3 state on dp1×fsdp2 saved as
  ``model_full.pkl`` (no ``sharded_state/``), trained on, loaded back in place: every
  leaf of the state bitwise, the steps after it repeat their losses bitwise; the same
  file loads into one process bitwise; the losses after the load equal the JAX
  ``Accelerator``'s uninterrupted run on ``MeshConfig(dp=1, fsdp=8)`` (rtol 2e-5).
- Format switch without a stale shadow (``test_zero.py:184``): a SHARDED save into the
  FULL checkpoint's directory deletes ``model_full.pkl`` and loads back bitwise; a FULL
  save into a SHARDED one deletes ``sharded_state/``.
- Reshard: a SHARDED ZeRO-3 checkpoint of 2 ranks loads into one process, and a
  one-process checkpoint into 2 ranks at ZeRO-3 and at ZeRO-1 (other splits): every
  leaf bitwise equal to the saved whole state; a leaf whose whole shape differs raises.
- ``merge-weights`` of the 2-rank SHARDED checkpoint: the whole params bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.parallel import MeshConfig as JMeshConfig
from accelerate_tpu.state import AcceleratorState as JAS
from accelerate_tpu.state import GradientState as JGS
from accelerate_tpu.state import PartialState as JPS
from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JPlugin
from accelerate_tpu.utils import send_to_device
from accelerate_tpu.ops import fused_optim as jfo
from accelerate_tpu_torch import checkpointing as ck
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.commands.merge import merge_weights, read_sharded_state
from accelerate_tpu_torch.launchers import notebook_launcher
from accelerate_tpu_torch.ops.fused_optim import fused_adamw
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin
from accelerate_tpu_torch.utils.serialization import read_safetensors


def _reset():
    for cls in (AcceleratorState, GradientState, PartialState, JAS, JGS, JPS):
        cls._reset_state()


@pytest.fixture(autouse=True)
def _fresh_state():
    _reset()
    yield
    _reset()


def _make_problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w1": (rng.normal(size=(64, 32)) * 0.1).astype(np.float32),
              "b1": np.zeros((32,), np.float32),
              "w2": (rng.normal(size=(32, 8)) * 0.1).astype(np.float32)}
    x = rng.normal(size=(16, 64)).astype(np.float32)
    y = rng.normal(size=(16, 8)).astype(np.float32)
    return params, {"x": x, "y": y}


def _loss_fn(p, b):
    h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] - b["y"]) ** 2)


def _one_process(sdt="SHARDED_STATE_DICT", steps=1, stage=0):
    """A one-rank state of the problem after ``steps`` steps."""
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    params, batch = _make_problem()
    acc = Accelerator(device="cpu", fsdp_plugin=FullyShardedDataParallelPlugin(
        zero_stage=stage, min_weight_size=1, state_dict_type=sdt))
    state = acc.create_train_state({k: torch.tensor(v) for k, v in params.items()},
                                   fused_adamw(1e-2))
    step = acc.build_train_step(_loss_fn)
    for _ in range(steps):
        state, _ = step(state, batch)
    return acc, state, step, batch


def _whole(acc, state):
    return torch_tp_ranks.whole_state(acc, state)


def _same_state(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One spawn of the 2 ranks for the module: ``(directory, ranks' results, the
    one-process checkpoint's whole state)``."""
    directory = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    _reset()
    acc, state, _, _ = _one_process(steps=2)
    acc.save_state(os.path.join(directory, "one"), train_state=state)
    one = _whole(acc, state)
    params, batch = _make_problem()
    ranks = notebook_launcher(torch_tp_ranks.fsdp_checkpoint_round_trip,
                              (params, batch, directory, os.path.join(directory, "one")),
                              2, device="cpu", backend="gloo", timeout_s=300)
    _reset()
    return directory, ranks, one


def _jax_losses(steps):
    for cls in (JAS, JGS, JPS):
        cls._reset_state()
    params, batch = _make_problem()
    acc = JAccelerator(mesh_config=JMeshConfig(dp=1, fsdp=8),
                       fsdp_plugin=JPlugin(zero_stage=3, min_weight_size=1))
    state = acc.create_train_state(jax.tree.map(jnp.asarray, params), jfo.fused_adamw(1e-2))
    step = acc.build_train_step(lambda p, b: jnp.mean(
        (jnp.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"] - b["y"]) ** 2))
    dbatch = send_to_device(batch, acc.mesh)
    losses = []
    for _ in range(steps):
        state, m = step(state, dbatch)
        losses.append(float(m["loss"]))
    return losses


def test_full_state_dict_round_trip(run):
    directory, ranks, _ = run
    for r in ranks:
        full = r["full"]
        assert "model_full.pkl" in full["files_full"]
        assert "sharded_state" not in full["files_full"]
        _same_state(full["restored"], full["saved"])
        assert full["again"] == full["first"]
    _same_state(ranks[0]["full"]["saved"], ranks[1]["full"]["saved"])
    np.testing.assert_allclose(ranks[0]["full"]["first"], _jax_losses(3)[1:], rtol=2e-5)


def test_full_state_dict_loads_into_one_process(run):
    directory, ranks, _ = run
    acc, state, step, batch = _one_process("FULL_STATE_DICT", steps=0)
    state = acc.load_state(os.path.join(directory, "full"), train_state=state)
    assert acc.checkpoint_stats["load"]["format"] == "FULL_STATE_DICT"
    _same_state(_whole(acc, state), ranks[0]["full"]["saved"])
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ranks[0]["full"]["first"], rtol=2e-5)


def test_format_switch_leaves_no_stale_shadow(run):
    directory, ranks, _ = run
    for r in ranks:
        full = r["full"]
        assert "model_full.pkl" not in full["files_switched"]
        assert "sharded_state" in full["files_switched"]
        _same_state(full["reloaded"], full["switched"])
    # and the other way: a FULL save into a SHARDED checkpoint drops sharded_state/
    acc, state, _, _ = _one_process(steps=1)
    path = acc.save_state(os.path.join(directory, "switch_one"), train_state=state)
    acc.fsdp_plugin.state_dict_type = "FULL_STATE_DICT"
    acc.save_state(path, train_state=state)
    assert "sharded_state" not in os.listdir(path) and "model_full.pkl" in os.listdir(path)
    acc.fsdp_plugin.state_dict_type = "SHARDED_STATE_DICT"
    with pytest.raises(FileNotFoundError):  # the plugin picks the format, not the files
        acc.load_state(path, train_state=state)


def test_sharded_reshard_two_ranks_to_one(run):
    directory, ranks, _ = run
    acc, state, step, batch = _one_process(steps=0)
    state = acc.load_state(os.path.join(directory, "sharded"), train_state=state)
    assert acc.checkpoint_stats["load"]["resharded_from"]["world"] == 2
    _same_state(_whole(acc, state), ranks[0]["sharded"]["saved"])
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ranks[0]["sharded"]["losses"], rtol=2e-5)


@pytest.mark.parametrize("stage", [3, 1])
def test_sharded_reshard_one_rank_to_two(run, stage):
    directory, ranks, one = run
    for r in ranks:
        got = r["from_one"][stage]
        assert got["stats"]["resharded_from"]["world"] == 1
        _same_state(got["loaded"], one)
    assert ranks[0]["from_one"][stage]["loss"] == ranks[1]["from_one"][stage]["loss"]


def test_reshard_refuses_another_whole_shape(tmp_path):
    directory = str(tmp_path)
    acc, state, _, _ = _one_process(steps=1)
    path = acc.save_state(os.path.join(directory, "c"), train_state=state)
    other = acc.create_train_state({"w1": torch.zeros(64, 16), "b1": torch.zeros(32),
                                    "w2": torch.zeros(32, 8)}, fused_adamw(1e-2))
    with pytest.raises(ValueError, match="w1: saved float32 \\[64, 32\\], the state holds "
                                         "float32 \\[64, 16\\]"):
        acc.load_state(path, train_state=other)


def test_merge_weights_over_fsdp_splits(run):
    directory, ranks, _ = run
    saved = ranks[0]["sharded"]["saved"]
    out = os.path.join(directory, "merged")
    merge_weights(os.path.join(directory, "sharded"), out)
    merged = dict(read_safetensors(os.path.join(out, "model.safetensors")))
    assert sorted(merged) == ["b1", "w1", "w2"]
    for k, v in merged.items():
        assert np.array_equal(v.numpy() if torch.is_tensor(v) else v, saved[f"params/{k}"])
    whole = read_sharded_state(os.path.join(directory, "sharded"))
    for k, v in whole.items():
        if torch.is_tensor(v):
            assert np.array_equal(v.numpy(), saved[k]), k
    index = ck.saved_indexes(ck.Path(directory) / "sharded" / "sharded_state")[0]
    assert {leaf["path"]: leaf["fsdp_split"] for leaf in index["leaves"]
            if "value" not in leaf}["params/w1"] == 0
