"""The port's elastic supervision (``accelerate_tpu_torch/elastic.py``) against
``tests/test_elastic.py``: the same 14 cases, the CLI restart among them, and the
preemption-resume story on a tiny llama (bitwise against an uninterrupted run). The
same plans run through the JAX package's ``ElasticSupervisor`` and the port's must give
the same restart records, attempts and ``WorkerFailure`` messages.

Worker processes are plain ``python -c`` scripts that import no torch, except the
resume test's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from accelerate_tpu_torch.elastic import ElasticSupervisor, FleetSupervisor, WorkerFailure

ROOT = Path(__file__).resolve().parents[1]

CRASH_ONCE = """
import os, sys, time
flag = sys.argv[1]
rank = sys.argv[2]
if rank == "0" and not os.path.exists(flag):
    open(flag, "w").write("crashed")
    sys.exit(17)  # simulated preemption/crash on the first attempt
time.sleep(0.2)
sys.exit(0)
"""

HANG = """
import time
time.sleep(60)
"""


def _worker_cmd(body: str, *argv: str) -> list:
    return [sys.executable, "-c", body, *argv]


def _telemetry():
    from accelerate_tpu_torch.telemetry import Telemetry
    from accelerate_tpu_torch.utils.dataclasses import TelemetryConfig

    return Telemetry(TelemetryConfig(enabled=True, compile_events=False, memory_stats=False))


def _restart_records(tel):
    from accelerate_tpu_torch.telemetry import ELASTIC_RESTART_SCHEMA

    return [r for r in tel.records if r.get("schema") == ELASTIC_RESTART_SCHEMA]


def test_supervisor_restarts_after_worker_death(tmp_path):
    """Worker 0 dies on attempt 1; the gang restarts on a fresh rendezvous and succeeds."""
    flag = str(tmp_path / "crashed_once")
    coordinators = []

    def make_plan(coordinator):
        coordinators.append(coordinator)
        return [(_worker_cmd(CRASH_ONCE, flag, str(rank)), None) for rank in range(2)]

    restarts = []
    sup = ElasticSupervisor(make_plan, max_restarts=2, monitor_interval=0.05,
                            on_restart=lambda attempt, codes: restarts.append((attempt, codes)))
    assert sup.run() == 0
    assert sup.attempts_used == 2
    assert os.path.exists(flag)
    assert len(coordinators) == 2 and coordinators[0] != coordinators[1]
    assert restarts and 17 in restarts[0][1], restarts


def test_supervisor_kills_survivors_on_failure(tmp_path):
    """When one worker dies, a hung survivor is torn down, not waited on forever."""
    flag = str(tmp_path / "crashed_once")

    def make_plan(coordinator):
        return [(_worker_cmd(CRASH_ONCE, flag, "0"), None), (_worker_cmd(HANG), None)]

    sup = ElasticSupervisor(make_plan, max_restarts=0, monitor_interval=0.05, grace_period=1.0)
    with pytest.raises(WorkerFailure) as exc:
        sup.run()
    assert 17 in exc.value.exit_codes
    assert any(c is not None and c < 0 for c in exc.value.exit_codes), exc.value.exit_codes


def test_supervisor_exhausts_restart_budget(tmp_path):
    def make_plan(coordinator):
        return [(_worker_cmd("import sys; sys.exit(3)"), None)]

    sup = ElasticSupervisor(make_plan, max_restarts=1, monitor_interval=0.05)
    with pytest.raises(WorkerFailure, match="after 2 attempts"):
        sup.run()
    assert sup.attempts_used == 2


def test_multi_process_launcher_restarts_through_cli(tmp_path):
    """``python -m accelerate_tpu_torch launch --multi-process --max-restarts`` restarts a
    script whose rank 0 crashes on its first run, and the gang then succeeds; every rank
    sees torchrun's rendezvous."""
    script = tmp_path / "train.py"
    flag = tmp_path / "first_attempt_crashed"
    script.write_text(
        "import os, sys\n"
        f"flag = {str(flag)!r}\n"
        "rank = os.environ['RANK']\n"
        "assert os.environ['WORLD_SIZE'] == '2' and os.environ['MASTER_PORT']\n"
        "if rank == '0' and not os.path.exists(flag):\n"
        "    open(flag, 'w').write('x')\n"
        "    sys.exit(9)\n"
        f"open(os.path.join({str(tmp_path)!r}, 'done' + rank), 'w').write(os.environ['MASTER_PORT'])\n")
    result = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch", "launch", "--multi-process",
         "--num-processes", "2", "--max-restarts", "1", "--cpu", str(script)],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert result.returncode == 0, f"{result.stdout}\n{result.stderr}"
    assert flag.exists()
    assert (tmp_path / "done0").read_text() == (tmp_path / "done1").read_text()
    assert "worker group failed with exit codes [9" in result.stderr


TRAIN_RESUME = '''
import os, sys
import numpy as np
import torch

from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import DataLoader
from accelerate_tpu_torch.lm_dataset import TokenDataset
from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.models.convert import params_to_numpy
from accelerate_tpu_torch.ops.fused_optim import fused_adamw
import dataclasses

ckpt_dir, corpus, out_path, crash_flag = sys.argv[1:5]
cfg = dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32)
acc = Accelerator(device="cpu")
dl = acc.prepare(DataLoader(TokenDataset(corpus, seq_len=16, seed=0), batch_size=2,
                            drop_last=True))  # 8 deterministic batches = 8 steps
state = acc.create_train_state(
    llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
    fused_adamw(1e-2))
step_fn = acc.build_train_step(lambda p, b: llama.loss_fn(p, b, cfg), max_grad_norm=1.0)

start = 0
if os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
    state = acc.load_state(ckpt_dir, train_state=state)
    start = state.step
    print(f"resumed from step {start}", flush=True)

for i, batch in enumerate(acc.skip_first_batches(dl, start), start=start):
    state, metrics = step_fn(state, batch)
    acc.save_state(ckpt_dir, train_state=state)
    if crash_flag != "none" and i == 3 and not os.path.exists(crash_flag):
        open(crash_flag, "w").write("preempted")
        os._exit(23)  # preempted mid-epoch, after the step-4 checkpoint

flat = params_to_numpy(state.params)
np.savez(out_path, step=state.step, embed=flat["embed"],
         **{f"l{i}_{k}": v for i, layer in enumerate(flat["layers"]) for k, v in layer.items()})
'''


def test_preemption_resume_loss_parity(tmp_path):
    """Train → checkpoint each step → the worker killed mid-epoch → ElasticSupervisor
    restarts it → load_state + skip_first_batches → the final params bitwise equal to an
    uninterrupted run's (tiny llama, fp32, fused AdamW, on the CPU)."""
    from accelerate_tpu_torch.lm_dataset import write_token_file

    corpus = tmp_path / "corpus.bin"
    write_token_file(np.random.default_rng(0).integers(0, 256, 8 * 2 * 17 + 1), str(corpus))
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}

    base_out = tmp_path / "baseline.npz"
    subprocess.run(_worker_cmd(TRAIN_RESUME, str(tmp_path / "ckpt_base"), str(corpus),
                               str(base_out), "none"), check=True, env=env, timeout=300)

    crash_flag = tmp_path / "preempted"
    resumed_out = tmp_path / "resumed.npz"

    def make_plan(coordinator):
        return [(_worker_cmd(TRAIN_RESUME, str(tmp_path / "ckpt_elastic"), str(corpus),
                             str(resumed_out), str(crash_flag)), env)]

    sup = ElasticSupervisor(make_plan, max_restarts=2, monitor_interval=0.1)
    assert sup.run() == 0
    assert sup.attempts_used == 2, "the simulated preemption must have triggered a restart"
    assert crash_flag.exists()

    base, resumed = np.load(base_out), np.load(resumed_out)
    assert int(resumed["step"]) == int(base["step"]) == 8
    assert sorted(base.files) == sorted(resumed.files)
    for k in base.files:
        np.testing.assert_array_equal(resumed[k], base[k], err_msg=k)


def test_restart_emits_telemetry_record(tmp_path):
    """Each restart emits an elastic.restart/v1 record: the attempt index, the exit codes
    that triggered the teardown, the budget and the gang."""
    from accelerate_tpu_torch.telemetry.schemas import validate_record

    flag = str(tmp_path / "crashed_once")
    tel = _telemetry()

    def make_plan(coordinator):
        return [(_worker_cmd(CRASH_ONCE, flag, str(rank)), None) for rank in range(2)]

    sup = ElasticSupervisor(make_plan, max_restarts=2, monitor_interval=0.05, telemetry=tel)
    assert sup.run() == 0
    records = _restart_records(tel)
    assert len(records) == 1, records
    assert records[0]["attempt"] == 0
    assert 17 in records[0]["exit_codes"]
    assert records[0]["max_restarts"] == 2
    assert records[0]["gang_id"] == "gang0"
    assert validate_record(records[0]) == []


def test_terminal_attempt_emits_final_record(tmp_path):
    """The attempt that exhausts the budget emits its record too, flagged ``final``, and
    ``on_restart`` fires for it."""
    tel = _telemetry()
    hooks = []

    def make_plan(coordinator):
        return [(_worker_cmd("import sys; sys.exit(3)"), None)]

    sup = ElasticSupervisor(make_plan, max_restarts=1, monitor_interval=0.05, telemetry=tel,
                            on_restart=lambda attempt, codes: hooks.append((attempt, codes)))
    with pytest.raises(WorkerFailure):
        sup.run()
    records = _restart_records(tel)
    assert len(records) == 2, records
    assert [r["final"] for r in records] == [False, True]
    assert all(3 in r["exit_codes"] for r in records)
    assert [h[0] for h in hooks] == [0, 1]


def test_restart_backoff_spacing(monkeypatch):
    """restart_backoff sleeps backoff × 2^attempt between restarts, never after the last
    attempt; the default restarts at once."""
    import accelerate_tpu_torch.elastic as elastic_mod

    sleeps = []
    orig_sleep = elastic_mod.time.sleep

    def record_sleep(s):
        if s >= 0.5:
            sleeps.append(s)
        else:
            orig_sleep(s)

    monkeypatch.setattr(elastic_mod.time, "sleep", record_sleep)

    def make_plan(coordinator):
        return [(_worker_cmd("import sys; sys.exit(3)"), None)]

    sup = ElasticSupervisor(make_plan, max_restarts=2, monitor_interval=0.05,
                            restart_backoff=0.5)
    with pytest.raises(WorkerFailure):
        sup.run()
    assert sleeps == [0.5, 1.0], sleeps

    sleeps.clear()
    sup = ElasticSupervisor(make_plan, max_restarts=1, monitor_interval=0.05)
    with pytest.raises(WorkerFailure):
        sup.run()
    assert sleeps == []


def test_backoff_jitter_bounds():
    sup = ElasticSupervisor(lambda c: [], restart_backoff=1.0, backoff_jitter=0.5)
    for attempt in range(3):
        for _ in range(20):
            d = sup._backoff_delay(attempt)
            base = 1.0 * 2 ** attempt
            assert 0.5 * base <= d <= 1.5 * base
    with pytest.raises(ValueError, match="backoff_jitter"):
        ElasticSupervisor(lambda c: [], backoff_jitter=2.0)
    with pytest.raises(ValueError, match="restart_backoff"):
        ElasticSupervisor(lambda c: [], restart_backoff=-1.0)
    with pytest.raises(ValueError, match="attempt_timeout"):
        ElasticSupervisor(lambda c: [], attempt_timeout=0)


def test_attempt_timeout_tears_down_hung_gang():
    """A gang where one worker exits 0 and another hangs is torn down at the attempt's
    horizon and counted as failed."""
    tel = _telemetry()

    def make_plan(coordinator):
        return [(_worker_cmd("import sys; sys.exit(0)"), None), (_worker_cmd(HANG), None)]

    sup = ElasticSupervisor(make_plan, max_restarts=0, monitor_interval=0.05, grace_period=1.0,
                            attempt_timeout=1.0, telemetry=tel)
    with pytest.raises(WorkerFailure, match="timed out"):
        sup.run()
    assert sup.attempt_timeouts == 1
    records = _restart_records(tel)
    assert len(records) == 1 and records[0]["timeout"] is True
    assert records[0]["final"] is True


def test_no_restart_no_telemetry_record():
    tel = _telemetry()

    def make_plan(coordinator):
        return [(_worker_cmd("import sys; sys.exit(0)"), None)]

    sup = ElasticSupervisor(make_plan, max_restarts=1, monitor_interval=0.05, telemetry=tel)
    assert sup.run() == 0
    assert not _restart_records(tel)


def test_fleet_supervisor_independent_per_gang_budgets():
    """Each gang owns its restart budget and backoff schedule, and every failure (the
    budget-exhausting one included) emits a record naming the gang."""
    from accelerate_tpu_torch.telemetry.schemas import validate_record

    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    clock = Clock()
    tel = _telemetry()
    sup = FleetSupervisor(max_restarts=1, restart_backoff=2.0, telemetry=tel, clock=clock)
    assert sup.may_restart("replica0") and sup.may_restart("replica1")
    assert sup.record_failure("replica0", reason="crash") is True
    assert not sup.may_restart("replica0")
    assert sup.restart_at("replica0") == 102.0
    clock.t = 102.5
    assert sup.may_restart("replica0")
    assert sup.attempts_used("replica1") == 0 and sup.may_restart("replica1")
    assert sup.record_failure("replica0", reason="crash") is False
    assert not sup.budget_left("replica0")
    assert not sup.may_restart("replica0")
    assert sup.budget_left("replica1")
    assert sup.stats()["exhausted"] == ["replica0"]
    records = _restart_records(tel)
    assert [r["gang_id"] for r in records] == ["replica0", "replica0"]
    assert [r["attempt"] for r in records] == [0, 1]
    assert [r["final"] for r in records] == [False, True]
    assert all(validate_record(r) == [] for r in records)


def test_fleet_supervisor_validation():
    with pytest.raises(ValueError, match="max_restarts"):
        FleetSupervisor(max_restarts=-1)
    with pytest.raises(ValueError, match="restart_backoff"):
        FleetSupervisor(restart_backoff=-0.1)
    with pytest.raises(ValueError, match="backoff_jitter"):
        FleetSupervisor(backoff_jitter=1.5)


def test_supervisor_gang_id_param(tmp_path):
    flag = str(tmp_path / "crashed_once")
    tel = _telemetry()

    def make_plan(coordinator):
        return [(_worker_cmd(CRASH_ONCE, flag, "0"), None)]

    sup = ElasticSupervisor(make_plan, max_restarts=1, monitor_interval=0.05, telemetry=tel,
                            gang_id="train-gang-3")
    assert sup.run() == 0
    (record,) = _restart_records(tel)
    assert record["gang_id"] == "train-gang-3"


# ------------------------------------------------- the same plans through both supervisors
PLANS = {
    # name: (worker bodies per rank, with a flag path argument; max_restarts; kwargs)
    "crash_once": ([CRASH_ONCE, CRASH_ONCE], 2, {}),
    "always_fails": (["import sys; sys.exit(3)"], 1, {}),
    "hung_survivor": ([CRASH_ONCE, HANG], 0, {"grace_period": 1.0}),
    "attempt_timeout": (["import sys; sys.exit(0)", HANG], 0,
                        {"grace_period": 1.0, "attempt_timeout": 1.0}),
    "clean": (["import sys; sys.exit(0)"], 1, {}),
}


def _run_supervisor(cls, tel, tmp_path, name):
    bodies, max_restarts, kw = PLANS[name]
    flag = str(tmp_path / f"{cls.__module__}.flag")

    def make_plan(coordinator):
        return [(_worker_cmd(body, flag, str(rank)), None) for rank, body in enumerate(bodies)]

    sup = cls(make_plan, max_restarts=max_restarts, monitor_interval=0.05, telemetry=tel, **kw)
    try:
        outcome = ("ok", sup.run())
    except Exception as e:  # the two packages' WorkerFailure classes
        outcome = (type(e).__name__, str(e), e.exit_codes)
    keys = ("schema", "gang_id", "attempt", "attempts_used", "max_restarts", "exit_codes",
            "final", "timeout")
    records = [{k: r.get(k) for k in keys} for r in tel.records
               if str(r.get("schema", "")).endswith("elastic.restart/v1")]
    return outcome, sup.attempts_used, sup.attempt_timeouts, records


@pytest.mark.parametrize("name", sorted(PLANS))
def test_same_plans_same_outcome_as_jax(tmp_path, name):
    from accelerate_tpu.elastic import ElasticSupervisor as JaxSupervisor
    from accelerate_tpu.telemetry import Telemetry as JaxTelemetry
    from accelerate_tpu.utils.dataclasses import TelemetryConfig as JaxTelemetryConfig

    jax_tel = JaxTelemetry(JaxTelemetryConfig(enabled=True, compile_events=False,
                                              memory_stats=False))
    want = _run_supervisor(JaxSupervisor, jax_tel, tmp_path, name)
    got = _run_supervisor(ElasticSupervisor, _telemetry(), tmp_path, name)
    assert got == want
