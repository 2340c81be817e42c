"""The port's own safetensors I/O (``utils/serialization.py``, ``utils/modeling.py``), the
checkpoint export (``save_state(safe_serialization=True)``) and ``merge-weights``
(``commands/merge.py``) against the ``safetensors`` package (installed on this host)
and the JAX package's export: the same keys, dtypes and bytes, bf16 included; the same
shard split as the JAX ``save_sharded_checkpoint``; a tp = 2 gloo checkpoint merged into
whole tensors.

This module imports no jax at its top level: the gloo ranks import it to find
``tp_export_rank``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.utils.serialization import (load_flat_safetensors, read_header,
                                                      save_pytree_safetensors,
                                                      write_safetensors)

ROOT = Path(__file__).resolve().parents[1]

NUMPY_DTYPES = [np.float64, np.float32, np.float16, np.int64, np.int32, np.int16, np.int8,
                np.uint8, np.bool_]


@pytest.fixture(autouse=True)
def fresh_state():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.integers(0, 2, shape).astype(bool)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(max(info.min, -1000), min(info.max, 1000), shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


@pytest.mark.parametrize("dtype", NUMPY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_writer_against_safetensors_numpy(tmp_path, dtype):
    from safetensors.numpy import load_file

    flat = {"a/b": _array(dtype, (3, 5)), "c": _array(dtype, (7,), 1), "scalar": _array(dtype, ()),
            "empty": _array(dtype, (0, 4))}
    write_safetensors({k: torch.from_numpy(v) for k, v in flat.items()}, tmp_path / "x.st")
    loaded = load_file(str(tmp_path / "x.st"))
    assert sorted(loaded) == sorted(flat)
    for k, v in flat.items():
        assert loaded[k].dtype == v.dtype and loaded[k].shape == v.shape
        np.testing.assert_array_equal(loaded[k], v)


def test_bf16_kept_against_safetensors_torch(tmp_path):
    from safetensors.torch import load_file

    t = {"w": torch.randn(6, 10, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16),
         "f": torch.arange(5, dtype=torch.float32), "h": torch.ones(3, dtype=torch.float16)}
    write_safetensors(t, tmp_path / "x.st")
    header, _ = read_header(tmp_path / "x.st")
    assert header["w"]["dtype"] == "BF16"
    loaded = load_file(str(tmp_path / "x.st"))
    for k, v in t.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v)


def test_reader_reads_safetensors_files_and_metadata(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    t = {"w": torch.randn(4, 3).to(torch.bfloat16), "i": torch.arange(7, dtype=torch.int64),
         "b": torch.tensor([True, False]), "h": torch.randn(3).to(torch.float16)}
    save_file(t, str(tmp_path / "theirs.st"), metadata={"format": "pt"})
    ours = load_flat_safetensors(tmp_path / "theirs.st")
    assert sorted(ours) == sorted(t)
    assert all(ours[k].dtype == v.dtype and torch.equal(ours[k], v) for k, v in t.items())
    write_safetensors(t, tmp_path / "ours.st", metadata={"format": "pt", "step": 3})
    with safe_open(str(tmp_path / "ours.st"), "pt") as f:
        assert f.metadata() == {"format": "pt", "step": "3"}
    raw = (tmp_path / "ours.st").read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert n % 8 == 0  # the data starts on an 8-byte boundary


def _tiny_jax_params(dtype=None):
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jax_llama

    cfg = jax_llama.CONFIGS["tiny"]
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0))
    if dtype is not None:
        params = jax.tree_util.tree_map(lambda x: x.astype(dtype), params)
    return cfg, params


def _jax_read(path):
    from accelerate_tpu.utils.modeling import iter_safetensors

    return {k: (v.dtype.name, v.shape, v.tobytes()) for k, v in iter_safetensors(path)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_equals_jax_export(tmp_path, dtype):
    """The port's writer over the port's params and the JAX package's over the JAX params
    tree: the same keys, dtypes and bytes (read back through the JAX reader)."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.utils.serialization import save_pytree_safetensors as jax_save
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax

    jdt = getattr(jnp, dtype)
    _, jparams = _tiny_jax_params(jdt)
    jax_save(jparams, tmp_path / "jax.safetensors")
    # Through fp32 (exact for bf16 values): the port takes numpy leaves of numpy's types.
    np_params = jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), jparams)
    params = params_from_jax(np_params, llama.CONFIGS["tiny"], device="cpu",
                             master_dtype=torch.float32)
    params = {k: ([{n: t.to(getattr(torch, dtype)) for n, t in layer.items()} for layer in v]
                  if k == "layers" else v.to(getattr(torch, dtype))) for k, v in params.items()}
    save_pytree_safetensors(params, tmp_path / "port.safetensors")
    want, got = _jax_read(tmp_path / "jax.safetensors"), _jax_read(tmp_path / "port.safetensors")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k][:2] == want[k][:2], k
        assert got[k][2] == want[k][2], k


def test_save_state_export_equals_jax_export(tmp_path):
    """``save_state(safe_serialization=True)`` writes ``model.safetensors`` equal to the
    JAX export of the same params."""
    import jax

    from accelerate_tpu.utils.serialization import save_pytree_safetensors as jax_save
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw

    _, jparams = _tiny_jax_params()
    jax_save(jparams, tmp_path / "jax.safetensors")
    acc = Accelerator(device="cpu")
    state = acc.create_train_state(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), llama.CONFIGS["tiny"],
                        device="cpu", master_dtype=torch.float32), fused_adamw(1e-3))
    path = Path(acc.save_state(str(tmp_path / "ckpt"), train_state=state,
                               safe_serialization=True))
    assert _jax_read(path / "model.safetensors") == _jax_read(tmp_path / "jax.safetensors")
    manifest = json.loads((path / "manifest.sha256.json").read_text())
    assert "model.safetensors" in manifest
    assert acc.checkpoint_stats["save"]["export_s"] >= 0


def test_save_state_export_needs_no_safetensors_package(tmp_path):
    """In a process where importing ``safetensors`` raises, the export is still written;
    the ``safetensors`` package reads it here."""
    from safetensors.numpy import load_file

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'safetensors':\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import torch\n"
        "from accelerate_tpu_torch.accelerator import Accelerator\n"
        "from accelerate_tpu_torch import optim\n"
        "acc = Accelerator(device='cpu')\n"
        "st = acc.create_train_state({'w': torch.arange(12.0).reshape(3, 4),\n"
        "                             'n': {'b': torch.ones(2)}}, optim.sgd(0.1))\n"
        "acc.save_state(sys.argv[2], train_state=st, safe_serialization=True)\n"
        "assert not [m for m in sys.modules if m.startswith('safetensors')]\n")
    res = subprocess.run([sys.executable, "-c", code, str(ROOT), str(tmp_path / "ck")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = load_file(str(tmp_path / "ck" / "model.safetensors"))
    np.testing.assert_array_equal(loaded["w"], np.arange(12.0, dtype=np.float32).reshape(3, 4))
    np.testing.assert_array_equal(loaded["n/b"], np.ones(2, np.float32))


@pytest.mark.parametrize("max_shard_size", ["100KB", "300KB", "1MB", "5GB"])
def test_merge_split_equals_jax_save_sharded_checkpoint(tmp_path, max_shard_size):
    """``merge-weights`` over the port's checkpoint of the tiny llama splits its shards
    as the JAX ``save_sharded_checkpoint`` splits the same params: the same index and
    the same tensors in each shard file."""
    import jax

    from accelerate_tpu.utils.modeling import save_sharded_checkpoint as jax_sharded
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.commands.merge import merge_weights
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw

    _, jparams = _tiny_jax_params()
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    want = jax_sharded(np_params, tmp_path / "jax", max_shard_size=max_shard_size)
    acc = Accelerator(device="cpu")
    state = acc.create_train_state(
        params_from_jax(np_params, llama.CONFIGS["tiny"], device="cpu",
                        master_dtype=torch.float32), fused_adamw(1e-3))
    acc.save_state(str(tmp_path / "ckpt"), train_state=state)
    got = merge_weights(str(tmp_path / "ckpt"), str(tmp_path / "port"),
                        max_shard_size=max_shard_size)
    assert got == want
    for fname in sorted(set(want["weight_map"].values())):
        assert _jax_read(tmp_path / "port" / fname) == _jax_read(tmp_path / "jax" / fname)
    if len(set(want["weight_map"].values())) > 1:
        assert (json.loads((tmp_path / "port" / "model.safetensors.index.json").read_text())
                == json.loads((tmp_path / "jax" / "model.safetensors.index.json").read_text()))


def test_verify_checkpoint_accepts_either_sides_exported_checkpoint(tmp_path):
    """Each package's ``verify_checkpoint`` accepts the other's checkpoint, the export
    included in the manifest."""
    from accelerate_tpu.checkpointing import verify_checkpoint as jax_verify
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.checkpointing import verify_checkpoint

    acc = Accelerator(device="cpu")
    state = acc.create_train_state({"w": torch.ones(3, 3)}, optim.sgd(0.1))
    path = acc.save_state(str(tmp_path / "ckpt"), train_state=state, safe_serialization=True)
    assert verify_checkpoint(path) == [] and jax_verify(path) == []


# ---------------------------------------------------------------------- tp = 2 over gloo
def tp_export_rank(np_params, tokens, directory: str) -> dict:
    """One rank of a dp1×tp2 tiny llama (fp32, ``fused_adamw``): one step, then
    ``save_state(safe_serialization=True)``; returns the gathered whole params and this
    rank's moments' local shards."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
    from accelerate_tpu_torch.ops.fused_optim import fused_adamw
    from accelerate_tpu_torch.parallel import MeshConfig
    from accelerate_tpu_torch.utils.tree import named_parameters

    import dataclasses

    cfg = dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32, loss_impl="fused_tp")
    acc = Accelerator(device="cpu", mesh_config=MeshConfig(dp=1, tp=2))
    specs = llama.partition_specs(cfg)
    state = acc.create_train_state(
        params_from_jax(np_params, cfg, device="cpu", master_dtype=torch.float32),
        fused_adamw(1e-3), partition_specs=specs)
    step = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)
    state, _ = step(state, {"tokens": tokens})
    acc.save_state(os.path.join(directory, "ckpt"), train_state=state, safe_serialization=True)
    whole = params_to_numpy(state.params, mesh=acc.mesh, specs=specs)
    return {"params": named_parameters(whole),
            "moments": {k: v.numpy().copy() for k, v in
                        named_parameters(state.opt_state).items() if torch.is_tensor(v)},
            "tp_dims": state.tp_dims}


def test_tp2_checkpoint_merged_into_whole_params(tmp_path):
    """Two gloo ranks each save their tp halves; ``merge-weights`` puts every split leaf
    back together along the dim its index records: equal to the gathered params, and
    so is the export written at the save. With ``--full-state`` the moments too."""
    import jax

    from accelerate_tpu_torch.commands.merge import merge_weights
    from accelerate_tpu_torch.launchers import notebook_launcher

    _, jparams = _tiny_jax_params()
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 17))
    ranks = notebook_launcher(tp_export_rank, (np_params, tokens, str(tmp_path)), 2,
                              device="cpu", backend="gloo", timeout_s=120)
    assert any(d is not None for d in ranks[0]["tp_dims"])
    whole = ranks[0]["params"]
    index = json.loads((tmp_path / "ckpt" / "sharded_state" / "rank1.json").read_text())
    assert index["tp"] == {"size": 2, "index": 1}
    assert {leaf["path"]: leaf.get("split") for leaf in index["leaves"]
            if leaf["path"] == "params/layers/0/wq"} == {"params/layers/0/wq": 1}

    merge_weights(str(tmp_path / "ckpt"), str(tmp_path / "merged"))
    for name in ("merged/model.safetensors", "ckpt/model.safetensors"):
        got = load_flat_safetensors(tmp_path / name)
        assert sorted(got) == sorted(whole)
        for k, v in whole.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{name}: {k}")

    merge_weights(str(tmp_path / "ckpt"), str(tmp_path / "full"), params_only=False)
    full = load_flat_safetensors(tmp_path / "full" / "model.safetensors")
    split = {leaf["path"]: leaf["split"] for leaf in index["leaves"]
             if "split" in leaf and leaf["split"] is not None}
    moments = [p for p in split if p.startswith("opt_state/")]
    assert moments
    for path in moments:
        rel = path.removeprefix("opt_state/")
        halves = [r["moments"][rel] for r in ranks]
        np.testing.assert_array_equal(full[path].numpy(),
                                      np.concatenate(halves, axis=split[path]), err_msg=path)
    for k, v in whole.items():
        np.testing.assert_array_equal(full["params/" + k].numpy(), v, err_msg=k)
