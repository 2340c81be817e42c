"""The port's checkpoint and resume (``accelerate_tpu_torch/checkpointing.py``,
``Accelerator.save_state``/``load_state``) against the JAX package's, on the CPU.

Mirrors ``tests/test_checkpointing.py`` and the verified-checkpoint tests of
``tests/test_resilience.py`` (manifest and marker; fallback past a corrupt newest
checkpoint):

- the directory layout and file names, and the manifest format: JAX's
  ``verify_checkpoint`` accepts the port's checkpoints and the port's accepts JAX's;
- rotation survivors equal JAX's for the same sequence of saves, crashed (uncommitted)
  saves among them;
- quarantine of an uncommitted and a corrupt checkpoint, the fallback to the previous
  valid one, and ``CheckpointCorruptError`` for an explicit corrupt path;
- round trips of a custom object, the host rng states, a scheduler, an async save
  (the train step writes in place while the files are written) and a multi-file state;
- the tp train state on 2 gloo ranks (each rank its own shards), and a load onto another
  mesh shape, which raises;
- an fp32 ``debug`` run through the stateful data loader over a ``TokenDataset``: the
  resumed losses and every state leaf are bitwise the unbroken run's, and the losses
  are within rtol 1e-5 (``test_torch_train.py``'s loss tolerance) of JAX's run over
  the same batches;
- an rng loss: one generator per (step, micro-step), which a resumed run repeats.
"""

import dataclasses
import functools
import json
import random

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_tp_ranks
from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import checkpointing as jck
from accelerate_tpu import lm_dataset as jlm
from accelerate_tpu.data_loader import DataLoader as JDataLoader
from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils import ProjectConfiguration as JProjectConfiguration
from accelerate_tpu_torch import checkpointing as ck
from accelerate_tpu_torch import optim
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import DataLoader
from accelerate_tpu_torch.launchers import notebook_launcher
from accelerate_tpu_torch.lm_dataset import TokenDataset, write_token_file
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import params_from_jax, params_to_numpy
from accelerate_tpu_torch.ops.fused_optim import fused_adamw
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration, ProjectConfiguration
from accelerate_tpu_torch.utils.tree import tree_leaves


def _reset():
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    _reset()
    yield
    ck.wait_for_async_save()
    _reset()


def _quadratic_state(acc, opt=None):
    params = {"w": torch.linspace(-1.0, 1.0, 6).reshape(2, 3), "b": torch.zeros(3)}
    return acc.create_train_state(params, opt or optim.adamw(0.05))


def _quadratic_loss(p, b):
    return (((b["x"] @ p["w"]) + p["b"]) ** 2).mean()


def _batch(i):
    return {"x": torch.full((4, 2), 0.1 * (i + 1))}


def _leaves(state):
    return [t.clone() for t in tree_leaves([state.params, state.opt_state]) if torch.is_tensor(t)]


def _project(tmp_path, **kw):
    return ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                                **kw)


# ------------------------------------------------------------------------ layout, manifest
def test_layout_and_manifest_match_jax(tmp_path):
    """The same top-level files as a JAX checkpoint with a train state, a custom object
    and a data loader; each side's ``verify_checkpoint`` accepts the other's."""

    class Counter:
        def __init__(self):
            self.count = 3

        def state_dict(self):
            return {"count": self.count}

        def load_state_dict(self, sd):
            self.count = sd["count"]

    ja = JAccelerator(project_config=JProjectConfiguration(
        project_dir=str(tmp_path / "jax"), automatic_checkpoint_naming=True))
    ja.prepare(JDataLoader(list(range(8)), batch_size=4))
    ja.register_for_checkpointing(Counter())
    jstate = ja.create_train_state({"w": jnp.ones((2, 3))}, optax.sgd(0.1))
    jpath = ja.save_state(train_state=jstate)

    acc = Accelerator(device="cpu", project_config=_project(tmp_path / "torch"))
    acc.prepare(DataLoader(list(range(8)), batch_size=4))
    acc.register_for_checkpointing(Counter())
    path = acc.save_state(train_state=_quadratic_state(acc))

    def top(p):
        return sorted(x.name for x in __import__("pathlib").Path(p).iterdir())

    assert top(path) == top(jpath)
    assert path.endswith("checkpoints/checkpoint_0") and jpath.endswith("checkpoints/checkpoint_0")
    assert (ck.MANIFEST_NAME, ck.COMMIT_MARKER, ck.QUARANTINE_DIR) == (
        jck.MANIFEST_NAME, jck.COMMIT_MARKER, jck.QUARANTINE_DIR)
    manifest = json.loads((tmp_path / "torch/checkpoints/checkpoint_0" / ck.MANIFEST_NAME)
                          .read_text())
    assert set(manifest) == set(ck._manifest_files(__import__("pathlib").Path(path)))
    assert ck.verify_checkpoint(path) == [] == jck.verify_checkpoint(path)
    assert ck.verify_checkpoint(jpath) == []
    meta = json.loads((tmp_path / "torch/checkpoints/checkpoint_0/scheduler.json").read_text())
    jmeta = json.loads((tmp_path / "jax/checkpoints/checkpoint_0/scheduler.json").read_text())
    assert sorted(meta) == sorted(jmeta) and meta["dataloaders"] == jmeta["dataloaders"]


# -------------------------------------------------------------------------------- rotation
ROTATION_CASES = {  # total_limit, saves, indices of saves that crash before committing
    "limit2": (2, 6, ()),
    "limit1": (1, 4, ()),
    "limit3_crash_newest": (3, 5, (4,)),
    "limit2_crash_middle": (2, 6, (2, 3)),
    "limit2_crash_first": (2, 4, (0,)),
}


def _rotation_survivors(acc, base, saves, crashed, verify):
    for i in range(saves):
        acc.save_state()
        if i in crashed:  # a crash between the files and the marker
            (base / f"checkpoint_{i}" / "COMMITTED").unlink()
    return sorted(p.name for p in base.glob("checkpoint_*"))


@pytest.mark.parametrize("case", list(ROTATION_CASES))
def test_rotation_survivors_match_jax(tmp_path, case):
    limit, saves, crashed = ROTATION_CASES[case]
    ja = JAccelerator(project_config=JProjectConfiguration(
        project_dir=str(tmp_path / "jax"), automatic_checkpoint_naming=True, total_limit=limit))
    want = _rotation_survivors(ja, tmp_path / "jax" / "checkpoints", saves, crashed,
                               jck.verify_checkpoint)
    acc = Accelerator(device="cpu", project_config=_project(tmp_path / "torch", total_limit=limit))
    got = _rotation_survivors(acc, tmp_path / "torch" / "checkpoints", saves, crashed,
                              ck.verify_checkpoint)
    assert got == want
    newest_valid = max(i for i in range(saves) if i not in crashed)
    assert f"checkpoint_{newest_valid}" in got


# ---------------------------------------------------------------------- quarantine, fallback
def _train_and_save(tmp_path, n_saves, **project):
    acc = Accelerator(device="cpu", project_config=_project(tmp_path, **project))
    state = _quadratic_state(acc)
    step = acc.build_train_step(_quadratic_loss)
    for i in range(n_saves):
        state, _ = step(state, _batch(i))
        acc.save_state(train_state=state)
    return acc, state


def test_checkpoint_manifest_and_marker(tmp_path):
    acc, _ = _train_and_save(tmp_path, 2)
    ckpts = sorted((tmp_path / "checkpoints").glob("checkpoint_*"))
    assert len(ckpts) == 2
    for c in ckpts:
        assert (c / ck.COMMIT_MARKER).exists()
        assert json.loads((c / ck.MANIFEST_NAME).read_text())
        assert ck.verify_checkpoint(c) == []


def test_corrupt_and_uncommitted_checkpoints_fall_back(tmp_path):
    """Newest uncommitted, second newest corrupt (one byte of a state file flipped):
    both quarantined, the third newest loaded."""
    acc, state = _train_and_save(tmp_path, 4)
    ckpts = sorted((tmp_path / "checkpoints").glob("checkpoint_*"))
    (ckpts[-1] / ck.COMMIT_MARKER).unlink()
    victim = sorted((ckpts[-2] / "sharded_state").glob("*.bin"))[0]
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    assert ck.verify_checkpoint(ckpts[-2]) == [f"sha256 mismatch: sharded_state/{victim.name}"]
    restored = acc.load_state(train_state=state)
    assert restored.step == 2 and acc.step == 2
    assert acc.checkpoints_quarantined == 2
    quarantined = tmp_path / "checkpoints" / "quarantined"
    assert sorted(p.name for p in quarantined.iterdir()) == [ckpts[-2].name, ckpts[-1].name]
    assert not ckpts[-1].exists() and not ckpts[-2].exists()


def test_explicit_corrupt_checkpoint_raises(tmp_path):
    acc, state = _train_and_save(tmp_path, 1)
    path = tmp_path / "checkpoints" / "checkpoint_0"
    victim = path / "scheduler.json"
    victim.write_text(victim.read_text() + " ")
    with pytest.raises(ck.CheckpointCorruptError, match="sha256 mismatch: scheduler.json"):
        acc.load_state(str(path), train_state=state)


def test_load_checks_paths_dtypes_and_shapes(tmp_path):
    acc = Accelerator(device="cpu")
    path = acc.save_state(str(tmp_path / "c"), train_state=_quadratic_state(acc))
    other = acc.create_train_state({"w": torch.zeros(3, 2), "b": torch.zeros(3)},
                                   optim.adamw(0.05))
    with pytest.raises(ValueError,
                       match="/w: saved float32 \\[2, 3\\], the state holds float32 \\[3, 2\\]"):
        acc.load_state(path, train_state=other)
    other = acc.create_train_state({"w": torch.zeros(2, 3), "b": torch.zeros(3)},
                                   optim.adamw(0.05, mu_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="saved float32 \\[3\\], the state holds bfloat16"):
        acc.load_state(path, train_state=other)
    with pytest.raises(ValueError, match="differ"):
        acc.load_state(path, train_state=acc.create_train_state({"w": torch.zeros(2, 3)},
                                                                optim.adamw(0.05)))


# ----------------------------------------------------------------------------- round trips
def test_save_load_roundtrip_in_place_multi_file(tmp_path, monkeypatch):
    """Files of 16 bytes (a state of many files, leaves cut across them): the load
    writes into the live state's own tensors and restores its counts."""
    monkeypatch.setattr(ck, "FILE_BYTES", 16)
    acc = Accelerator(device="cpu")
    state = _quadratic_state(acc)
    step = acc.build_train_step(_quadratic_loss)
    for i in range(2):
        state, _ = step(state, _batch(i))
    path = acc.save_state(str(tmp_path / "c"), train_state=state)
    stats = acc.checkpoint_stats["save"]
    assert stats["files"] == -(-stats["bytes"] // 16) > ck.STAGING_BUFFERS
    assert stats["staging_bytes"] == 16 * ck.STAGING_BUFFERS
    saved, saved_step = _leaves(state), state.step
    ptrs = [t.data_ptr() for t in tree_leaves(state.params)]
    for i in range(2, 4):
        state, _ = step(state, _batch(i))
    assert not all(torch.equal(a, b) for a, b in zip(saved, _leaves(state)))
    state = acc.load_state(path, train_state=state)
    assert [t.data_ptr() for t in tree_leaves(state.params)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(saved, _leaves(state)))
    assert state.step == saved_step == state.opt_state.count == 2


def test_custom_object_and_scheduler_roundtrip(tmp_path):
    class Counter:
        def __init__(self):
            self.count = 0

        def step(self):
            self.count += 1

        def state_dict(self):
            return {"count": self.count}

        def load_state_dict(self, sd):
            self.count = sd["count"]

    acc = Accelerator(device="cpu")
    c, sched = Counter(), acc.prepare(Counter())
    c.count, sched.scheduler.count = 7, 4
    acc.register_for_checkpointing(c)
    with pytest.raises(ValueError, match="cannot be registered"):
        acc.register_for_checkpointing(object())
    acc.save_state(str(tmp_path / "ckpt"))
    assert (tmp_path / "ckpt" / "custom_checkpoint_0.pkl").exists()
    c.count, sched.scheduler.count = 99, 99
    acc.load_state(str(tmp_path / "ckpt"))
    assert (c.count, sched.scheduler.count) == (7, 4)


def test_rng_state_roundtrip(tmp_path):
    acc = Accelerator(device="cpu")
    random.seed(1234)
    np.random.seed(1234)
    torch.manual_seed(1234)
    acc.save_state(str(tmp_path / "ckpt"))
    want = (random.random(), np.random.rand(), torch.rand(1).item())
    random.seed(999)
    np.random.seed(999)
    torch.manual_seed(999)
    acc.load_state(str(tmp_path / "ckpt"))
    assert (random.random(), np.random.rand(), torch.rand(1).item()) == want


def test_hooks_run_on_save_and_load(tmp_path):
    acc = Accelerator(device="cpu")
    calls = []
    handle = acc.register_save_state_pre_hook(lambda models, st, d: calls.append(("save", d)))
    acc.register_load_state_pre_hook(lambda models, st, d: calls.append(("load", d)))
    path = acc.save_state(str(tmp_path / "c"))
    acc.load_state(path)
    handle.remove()
    acc.save_state(str(tmp_path / "c"))
    assert calls == [("save", path), ("load", path)]


def test_async_save_roundtrip(tmp_path):
    """The step writes the state in place while the async save's files are written: the
    checkpoint holds the state at the save, committed only when joined."""
    acc = Accelerator(device="cpu")
    state = _quadratic_state(acc, fused_adamw(0.05))
    step = acc.build_train_step(_quadratic_loss)
    state, _ = step(state, _batch(0))
    want, want_step = _leaves(state), state.step
    path = acc.save_state(str(tmp_path / "ck"), train_state=state, async_save=True)
    assert "blocking_s" in acc.checkpoint_stats["save"]
    for i in range(1, 4):
        state, _ = step(state, _batch(i))
    stats = acc.wait_for_checkpoint()
    assert stats is not None and stats["commit_after_s"] >= 0
    assert ck.verify_checkpoint(path) == []
    state = acc.load_state(path, train_state=state)
    assert all(torch.equal(a, b) for a, b in zip(want, _leaves(state)))
    assert state.step == want_step == 1


def test_unported_arguments_now_accepted(tmp_path):
    acc = Accelerator(device="cpu", project_dir=str(tmp_path), rng_types=["torch"],
                      dataloader_config=DataLoaderConfiguration(prefetch_depth=2),
                      step_scheduler_with_optimizer=False)
    assert acc.project_dir == str(tmp_path) == acc.project_configuration.logging_dir
    assert acc.rng_types == ["torch"] and acc.dataloader_config.prefetch_depth == 2
    assert acc.prepare(DataLoader(list(range(4)), batch_size=2)).prefetch_depth == 2
    assert not acc.step_scheduler_with_optimizer


# ------------------------------------------------------------------------- tp, 2 gloo ranks
TP_CFG = {"loss_impl": "fused_tp", "attn_impl": "xla"}


def _tp_inputs():
    jcfg = dataclasses.replace(jl.CONFIGS["tiny"], dtype=jnp.float32, attn_impl="xla")
    np_params = jax.tree.map(np.array, jl.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, 256, (2, 17)).astype(np.int32)} for _ in range(3)]
    return np_params, batches


@functools.lru_cache(maxsize=None)
def _tp_round_trip(directory):
    np_params, batches = _tp_inputs()
    return notebook_launcher(torch_tp_ranks.tp_checkpoint_round_trip,
                             (np_params, batches, TP_CFG, {"dp": 1, "tp": 2}, 1e-3, directory),
                             2, device="cpu", backend="gloo", timeout_s=300)


def test_tp_round_trip_two_ranks(tmp_path_factory):
    """Each rank writes its own shards (its index and files), reloads them in place, and
    retrains bitwise; the same checkpoint loads into one process by resharding (the
    whole params bitwise, the step count restored)."""
    directory = str(tmp_path_factory.mktemp("tp"))
    r0, r1 = _tp_round_trip(directory)
    for r in (r0, r1):
        assert r["restored"] and r["again"] == r["first"] and r["step"] == 3
        assert r["files"] == r0["files"]
    assert "rank0.json" in r0["files"] and "rank1.json" in r0["files"]
    assert any(f.startswith("rank1_") for f in r0["files"])
    assert r0["shards"] == r1["shards"]  # halves of the same shapes
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], dtype=torch.float32, **TP_CFG)
    acc = Accelerator(device="cpu")
    state = acc.create_train_state(params_from_jax(_tp_inputs()[0], tcfg, device="cpu",
                                                   master_dtype=torch.float32),
                                   fused_adamw(1e-3))
    state = acc.load_state(f"{directory}/ckpt", train_state=state)
    assert state.step == 1 and acc.checkpoint_stats["load"]["resharded_from"]["world"] == 2
    got = params_to_numpy(state.params)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(r0["saved_whole"])):
        assert np.array_equal(a, b)


# ------------------------------------------------------- debug fp32 run through the loader
B, S, STEPS_BEFORE, STEPS_AFTER = 4, 32, 2, 3


def _debug_configs():
    base = {"dtype": jnp.float32, "attn_impl": "xla"}
    jcfg = dataclasses.replace(jl.CONFIGS["debug"], **base)
    tcfg = dataclasses.replace(tl.CONFIGS["debug"], **{**base, "dtype": torch.float32})
    return jcfg, tcfg


def test_debug_resume_bitwise_and_losses_match_jax(tmp_path):
    jcfg, tcfg = _debug_configs()
    corpus = tmp_path / "corpus.bin"
    write_token_file(np.random.default_rng(0).integers(0, jcfg.vocab_size, 40 * S + 1), corpus)
    np_params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))

    acc = Accelerator(device="cpu", project_config=_project(tmp_path / "project"),
                      dataloader_config=DataLoaderConfiguration(use_stateful_dataloader=True))
    dl = acc.prepare(DataLoader(TokenDataset(str(corpus), seq_len=S, seed=0), batch_size=B,
                                drop_last=True))
    state = acc.create_train_state(params_from_jax(np_params, tcfg, device="cpu",
                                                   master_dtype=torch.float32),
                                   fused_adamw(1e-3))
    step = acc.build_train_step(lambda p, b: tl.loss_fn(p, b, tcfg), max_grad_norm=1.0)
    it = iter(dl)
    losses, batches = [], []
    for _ in range(STEPS_BEFORE):
        batch = next(it)
        batches.append(batch["tokens"].numpy().copy())
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    acc.save_state(train_state=state)
    for _ in range(STEPS_AFTER):
        batch = next(it)
        batches.append(batch["tokens"].numpy().copy())
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    unbroken = _leaves(state)
    unbroken_step = state.step

    state = acc.load_state(train_state=state)
    assert state.step == STEPS_BEFORE and acc.step == STEPS_BEFORE
    resumed, resumed_batches = [], []
    for batch in dl:  # the loader resumes at its saved position
        resumed_batches.append(batch["tokens"].numpy().copy())
        state, m = step(state, batch)
        resumed.append(float(m["loss"]))
        if len(resumed) == STEPS_AFTER:
            break
    assert resumed == losses[STEPS_BEFORE:]  # bitwise
    for got, want in zip(resumed_batches, batches[STEPS_BEFORE:], strict=True):
        np.testing.assert_array_equal(got, want)
    again = _leaves(state)
    assert state.step == unbroken_step
    assert all(torch.equal(a, b) for a, b in zip(unbroken, again, strict=True))

    # JAX over the same corpus, loader and weights.
    ja = JAccelerator()
    jdl_ = ja.prepare(JDataLoader(jlm.TokenDataset(str(corpus), seq_len=S, seed=0),
                                  batch_size=B, drop_last=True))
    jstate = ja.create_train_state(jax.tree.map(jnp.asarray, np_params),
                                   __import__("accelerate_tpu.ops.fused_optim",
                                              fromlist=["x"]).fused_adamw(1e-3))
    jstep = ja.build_train_step(lambda p, b: jl.loss_fn(p, b, jcfg), max_grad_norm=1.0)
    jlosses = []
    for batch, want in zip(jdl_, batches):
        np.testing.assert_array_equal(np.asarray(batch["tokens"]), want)
        jstate, m = jstep(jstate, batch)
        jlosses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


# ------------------------------------------------------------------------------- rng losses
def test_rng_loss_generator_per_micro_step_and_resume(tmp_path):
    """``loss_fn(params, batch, rng)``: each micro-step draws from its own generator
    (seeded from the state's rng, step * accumulation + micro), and a resumed run draws
    the same numbers and losses; without a seed the loss gets None."""
    acc = Accelerator(device="cpu", gradient_accumulation_steps=2)
    state = acc.create_train_state({"w": torch.linspace(-1, 1, 6).reshape(2, 3),
                                    "b": torch.zeros(3)}, optim.adamw(0.05), rng=11)
    draws = []

    def loss_fn(p, b, rng):
        noise = torch.rand(3, generator=rng)
        draws.append(noise)
        return (((b["x"] @ p["w"]) + p["b"] + noise) ** 2).mean()

    step = acc.build_train_step(loss_fn)
    for i in range(2):
        state, _ = step(state, _batch(i))
    path = acc.save_state(str(tmp_path / "c"), train_state=state)
    losses = []
    for i in range(2, 6):
        state, m = step(state, _batch(i))
        losses.append(float(m["loss"]))
    first = draws[:]
    assert len({tuple(d.tolist()) for d in first}) == len(first) == 6
    from accelerate_tpu_torch.accelerator import micro_generator

    for k, d in enumerate(first):  # micro-step k: step k // 2, micro k % 2
        assert torch.equal(d, torch.rand(3, generator=micro_generator(11, k, "cpu")))
    state = acc.load_state(path, train_state=state)
    assert state.rng == 11 and (state.step, state.micro) == (1, 0)
    draws.clear()
    again = []
    for i in range(2, 6):
        state, m = step(state, _batch(i))
        again.append(float(m["loss"]))
    assert again == losses
    assert all(torch.equal(a, b) for a, b in zip(draws, first[2:], strict=True))

    _reset()
    acc = Accelerator(device="cpu")
    seen = []
    state = _quadratic_state(acc)
    step = acc.build_train_step(lambda p, b, rng: seen.append(rng) or _quadratic_loss(p, b))
    step(state, _batch(0))
    assert seen == [None]
    with pytest.raises(TypeError, match="int seed"):
        acc.create_train_state({"w": torch.ones(1)}, optim.sgd(0.1), rng=torch.ones(2))
