"""The ``ckpt.save`` fault draws of the port's checkpointing against
``tests/test_resilience.py:787-921``: a crash before the marker, corruption after it,
the quarantine fallback, rotation after a mid-save crash, and the async commit at the
join (with a corruption riding it). The same seeded plans through the JAX package and
the port leave the same checkpoints and restore the same step; under two gloo ranks
every rank takes the same draw, so none waits in a barrier.
"""

import json

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import checkpointing as ck
from accelerate_tpu_torch.resilience.faults import FaultPlan, FaultSpec, InjectedFault

CRASH_AT_2 = [("ckpt.save", "crash", 2)]
CORRUPT_AT_1 = [("ckpt.save", "corrupt", 1)]


@pytest.fixture(autouse=True)
def fresh_state():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    ck.wait_for_async_save()
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


def _plan(specs, faults_mod=None):
    if faults_mod is None:
        return FaultPlan([FaultSpec(site, kind, prob=1.0, start=start, max_fires=1)
                          for site, kind, start in specs])
    return faults_mod.FaultPlan([faults_mod.FaultSpec(site, kind, prob=1.0, start=start,
                                                      max_fires=1)
                                 for site, kind, start in specs])


class _Regression:
    """y = 2x + 1 + noise, the JAX test's dataset, as dicts of numpy scalars."""

    def __init__(self, length=32, seed=42):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(length,)).astype(np.float32)
        self.y = (2.0 * self.x + 1.0 + 0.05 * rng.normal(size=(length,))).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def _loss(params, batch):
    return torch.mean((params["a"] * batch["x"] + params["b"] - batch["y"]) ** 2)


def _accelerator(tmp_path, total_limit=None, **kw):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration

    return Accelerator(device="cpu", project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=total_limit),
        **kw)


def _state(acc):
    from accelerate_tpu_torch import optim

    return acc.create_train_state({"a": torch.zeros(()), "b": torch.zeros(())}, optim.sgd(0.1))


def _train_and_save(tmp_path, n_saves, total_limit=None, fault_plan=None):
    """The JAX test's helper on the port: a step and an automatic save per batch, an
    injected mid-save crash swallowed."""
    from accelerate_tpu_torch.data_loader import DataLoader

    acc = _accelerator(tmp_path, total_limit)
    if fault_plan is not None:
        acc.fault_plan = fault_plan
    dl = acc.prepare(DataLoader(_Regression(), batch_size=4))
    state = _state(acc)
    step = acc.build_train_step(_loss)
    saved = 0
    for batch in dl:
        if saved >= n_saves:
            break
        state, _ = step(state, batch)
        try:
            acc.save_state(train_state=state)
        except InjectedFault:
            pass
        saved += 1
    return acc, state


def test_checkpoint_manifest_and_marker(tmp_path):
    acc, state = _train_and_save(tmp_path, n_saves=2)
    ckpts = sorted((tmp_path / "checkpoints").glob("checkpoint_*"))
    assert len(ckpts) == 2
    for c in ckpts:
        assert (c / ck.COMMIT_MARKER).exists()
        assert json.loads((c / ck.MANIFEST_NAME).read_text())
        assert ck.verify_checkpoint(c) == []


def test_corrupt_checkpoint_falls_back_to_previous_valid(tmp_path):
    acc, state = _train_and_save(tmp_path, n_saves=3)
    newest = sorted((tmp_path / "checkpoints").glob("checkpoint_*"))[-1]
    victim = next(p for p in sorted(newest.rglob("*"))
                  if p.is_file() and p.name not in (ck.COMMIT_MARKER, ck.MANIFEST_NAME))
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    restored = acc.load_state(train_state=state)
    assert restored.step == 2
    assert acc.checkpoints_quarantined == 1
    assert (tmp_path / "checkpoints" / "quarantined" / newest.name).exists()
    assert not newest.exists()


def test_uncommitted_checkpoint_skipped_on_load(tmp_path):
    acc, state = _train_and_save(tmp_path, n_saves=2)
    ckpts = sorted((tmp_path / "checkpoints").glob("checkpoint_*"))
    (ckpts[-1] / ck.COMMIT_MARKER).unlink()
    restored = acc.load_state(train_state=state)
    assert restored.step == 1
    assert acc.checkpoints_quarantined == 1


def test_explicit_corrupt_checkpoint_raises(tmp_path):
    from accelerate_tpu_torch.accelerator import Accelerator

    acc = Accelerator(device="cpu")
    state = _state(acc)
    path = tmp_path / "ckpt"
    acc.save_state(str(path), train_state=state)
    victim = next(p for p in sorted(path.rglob("*"))
                  if p.is_file() and p.name not in (ck.COMMIT_MARKER, ck.MANIFEST_NAME))
    victim.write_bytes(victim.read_bytes() + b"garbage")
    with pytest.raises(ck.CheckpointCorruptError):
        acc.load_state(str(path), train_state=state)


def test_rotation_never_deletes_newest_valid_after_midsave_crash(tmp_path):
    """total_limit=1: save 2 commits, save 3 crashes before its marker; rotation must keep
    checkpoint_1, the newest valid state, which the loader then restores."""
    acc, state = _train_and_save(tmp_path, n_saves=3, total_limit=1,
                                 fault_plan=_plan(CRASH_AT_2))
    base = tmp_path / "checkpoints"
    names = sorted(p.name for p in base.glob("checkpoint_*"))
    assert "checkpoint_2" in names and "checkpoint_1" in names, names
    assert not (base / "checkpoint_2" / ck.COMMIT_MARKER).exists()
    assert (base / "checkpoint_1" / ck.COMMIT_MARKER).exists()
    restored = acc.load_state(train_state=state)
    assert restored.step == 2
    assert acc.checkpoints_quarantined == 1


def test_crash_fault_lands_the_data_files_but_no_marker(tmp_path):
    """``crash`` raises after every data file has landed and before the commit: the
    directory holds the train state and no manifest or marker."""
    acc = _accelerator(tmp_path, fault_config=None)
    acc.fault_plan = _plan([("ckpt.save", "crash", 0)])
    state = _state(acc)
    with pytest.raises(InjectedFault, match="ckpt.save"):
        acc.save_state(train_state=state)
    path = tmp_path / "checkpoints" / "checkpoint_0"
    assert (path / "sharded_state" / "rank0.json").exists()
    assert (path / "random_states_0.pkl").exists()
    assert not (path / ck.COMMIT_MARKER).exists() and not (path / ck.MANIFEST_NAME).exists()
    assert ck.verify_checkpoint(path) == ["uncommitted (no COMMITTED marker — crash mid-save?)"]
    assert acc.fault_plan.fired == [{"site": "ckpt.save", "kind": "crash", "invocation": 0,
                                     "uid": None}]


def test_corrupt_fault_injection_is_caught_at_load(tmp_path):
    """kind=corrupt flips a byte after the marker lands: the manifest's hashes, not the
    marker, catch it."""
    acc, state = _train_and_save(tmp_path, n_saves=2, fault_plan=_plan(CORRUPT_AT_1))
    ckpts = sorted((tmp_path / "checkpoints").glob("checkpoint_*"))
    assert (ckpts[-1] / ck.COMMIT_MARKER).exists()
    problems = ck.verify_checkpoint(ckpts[-1])
    assert any("sha256 mismatch" in p for p in problems), problems
    restored = acc.load_state(train_state=state)
    assert restored.step == 1
    assert acc.checkpoints_quarantined == 1


def test_async_save_commit_marker_lands_at_join(tmp_path):
    from accelerate_tpu_torch.accelerator import Accelerator

    acc = Accelerator(device="cpu")
    state = _state(acc)
    path = tmp_path / "async_ckpt"
    acc.save_state(str(path), train_state=state, async_save=True)
    ck.wait_for_async_save()
    assert (path / ck.COMMIT_MARKER).exists()
    assert ck.verify_checkpoint(path) == []
    assert acc.load_state(str(path), train_state=state) is not None


def test_async_corrupt_fault_rides_the_deferred_commit(tmp_path):
    """On an async save the corruption waits for the join: flipped before the manifest is
    hashed it would be described as valid. After the join the marker is there and the
    hashes catch the flip."""
    acc = _accelerator(tmp_path)
    acc.fault_plan = _plan([("ckpt.save", "corrupt", 0)])
    state = _state(acc)
    path = acc.save_state(train_state=state, async_save=True)
    pending = ck._PENDING
    assert pending is not None and pending.corrupt
    ck.wait_for_async_save()
    problems = ck.verify_checkpoint(path)
    assert problems and all("sha256 mismatch" in p for p in problems), problems
    with pytest.raises(ck.CheckpointCorruptError):
        acc.load_state(path, train_state=state)


# ---------------------------------------------------------------- against the JAX package
SCENARIOS = {
    "clean": ([], 3, None),
    "crash_before_marker": (CRASH_AT_2, 3, None),
    "corrupt_after_marker": (CORRUPT_AT_1, 2, None),
    "rotation_after_crash": (CRASH_AT_2, 3, 1),
    "corrupt_then_crash": ([("ckpt.save", "corrupt", 1), ("ckpt.save", "crash", 2)], 3, None),
}


def _jax_train_and_save(tmp_path, n_saves, total_limit, fault_plan):
    import optax

    from accelerate_tpu import Accelerator
    from accelerate_tpu.data_loader import DataLoader
    from accelerate_tpu.resilience.faults import InjectedFault as JaxInjectedFault
    from accelerate_tpu.state import AcceleratorState, GradientState, PartialState
    from accelerate_tpu.test_utils.training import (RegressionDataset, linear_regression_loss,
                                                    make_regression_state)
    from accelerate_tpu.utils import ProjectConfiguration

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    acc = Accelerator(project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=total_limit))
    acc.fault_plan = fault_plan
    dl = acc.prepare(DataLoader(RegressionDataset(length=32), batch_size=4))
    state = acc.create_train_state(make_regression_state(), optax.sgd(0.1))
    step = acc.build_train_step(linear_regression_loss)
    saved = 0
    for batch in dl:
        if saved >= n_saves:
            break
        state, _ = step(state, batch)
        try:
            acc.save_state(train_state=state)
        except JaxInjectedFault:
            pass
        saved += 1
    return acc, state


def _outcome(acc, state, base, step_of):
    from accelerate_tpu_torch.checkpointing import COMMIT_MARKER

    names = {p.name: (p / COMMIT_MARKER).exists() for p in sorted(base.glob("checkpoint_*"))}
    restored = acc.load_state(train_state=state)
    return {"checkpoints": names, "restored_step": step_of(restored),
            "quarantined": getattr(acc, "checkpoints_quarantined", 0),
            "quarantine_dir": sorted(p.name for p in (base / "quarantined").glob("*"))
            if (base / "quarantined").exists() else []}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_fault_plans_same_checkpoints_as_jax(tmp_path, name):
    from accelerate_tpu.resilience import faults as jax_faults

    specs, n_saves, limit = SCENARIOS[name]
    jax_acc, jax_state = _jax_train_and_save(tmp_path / "jax", n_saves, limit,
                                             _plan(specs, jax_faults) if specs else None)
    want = _outcome(jax_acc, jax_state, tmp_path / "jax" / "checkpoints",
                    lambda s: int(np.asarray(s.step)))
    acc, state = _train_and_save(tmp_path / "port", n_saves, limit,
                                 _plan(specs) if specs else None)
    got = _outcome(acc, state, tmp_path / "port" / "checkpoints", lambda s: s.step)
    assert got == want
    if specs:
        assert [f["kind"] for f in acc.fault_plan.fired] == [s[1] for s in specs]


# ------------------------------------------------------------------------- two gloo ranks
def crash_then_commit_rank(project_dir: str) -> dict:
    """One gloo rank: a save under a plan that crashes the first ``ckpt.save`` (every
    rank raises; none waits in a barrier), then a clean save that commits."""
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration

    acc = Accelerator(device="cpu", project_config=ProjectConfiguration(
        project_dir=project_dir, automatic_checkpoint_naming=True))
    acc.fault_plan = FaultPlan([FaultSpec("ckpt.save", "crash", prob=1.0, start=0,
                                          max_fires=1)])
    state = acc.create_train_state({"a": torch.zeros(()), "b": torch.zeros(())},
                                   optim.sgd(0.1))
    try:
        acc.save_state(train_state=state)
        crashed = False
    except InjectedFault:
        crashed = True
    path = acc.save_state(train_state=state)
    return {"crashed": crashed, "path": path, "problems": ck.verify_checkpoint(path)}


def test_crash_draw_is_collective_under_two_ranks(tmp_path):
    from accelerate_tpu_torch.launchers import notebook_launcher

    ranks = notebook_launcher(crash_then_commit_rank, (str(tmp_path),), 2, device="cpu",
                              backend="gloo", timeout_s=60)
    assert [r["crashed"] for r in ranks] == [True, True]
    assert ranks[0]["path"] == ranks[1]["path"]
    # The crashed save did not advance the iteration: the clean save commits its directory.
    assert ranks[0]["path"].endswith("checkpoint_0")
    assert ranks[0]["problems"] == [] and ranks[1]["problems"] == []
