"""The port's launch surface against ``tests/test_cli.py`` (config, launch, env and
merge-weights) and ``tests/test_launchers.py``: ``commands/{config,launch,env,merge}.py``,
``utils/{launch,environment,other}.py`` and ``launchers.py``.

For the same flags the port's ``ACCELERATE_*`` environment equals the JAX package's key
for key; the JAX coordinator triple is replaced by torchrun's rendezvous. The library
reads that environment back (``state``, ``accelerator``), and a flag of a feature the port
has not ported fails loudly in the worker.
"""

import contextlib
import dataclasses
import glob
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.commands.accelerate_cli import get_parser
from accelerate_tpu_torch.commands.config import (ClusterConfig, load_config_from_file,
                                                  save_config)
from accelerate_tpu_torch.commands.launch import (_apply_config_defaults, _forwarded_flags,
                                                  launch_command, launch_command_parser)
from accelerate_tpu_torch.utils.launch import (RENDEZVOUS_KEYS, mesh_env_from_args,
                                               prepare_multi_process_env,
                                               prepare_simple_launcher_cmd_env)

ROOT = Path(__file__).resolve().parents[1]
JAX_RENDEZVOUS = ("ACCELERATE_COORDINATOR_ADDRESS", "ACCELERATE_NUM_PROCESSES",
                  "ACCELERATE_PROCESS_ID")


@pytest.fixture(autouse=True)
def fresh_state():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    yield
    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()


# ------------------------------------------------------------------------------ config
def test_cluster_config_yaml_roundtrip(tmp_path):
    cfg = ClusterConfig(num_processes=4, mixed_precision="bf16", tp=2, fsdp_zero_stage=3)
    loaded = load_config_from_file(save_config(cfg, str(tmp_path / "cfg.yaml")))
    assert (loaded.num_processes, loaded.mixed_precision, loaded.tp,
            loaded.fsdp_zero_stage) == (4, "bf16", 2, 3)


def test_cluster_config_json_roundtrip(tmp_path):
    cfg = ClusterConfig(num_machines=2, main_process_ip="10.0.0.1", main_process_port=1234)
    loaded = load_config_from_file(save_config(cfg, str(tmp_path / "cfg.json")))
    assert loaded.num_machines == 2
    assert loaded.main_process_ip == "10.0.0.1"


def test_yaml_without_pyyaml_raises_clearly(tmp_path, monkeypatch):
    """Where ``yaml`` does not import, a .yaml path raises and says to use .json; JSON
    still works and becomes the default file."""
    import accelerate_tpu_torch.commands.config as config_mod

    monkeypatch.setattr(config_mod, "_have_yaml", lambda: False)
    with pytest.raises(RuntimeError, match="PyYAML.*json"):
        save_config(ClusterConfig(), str(tmp_path / "c.yaml"))
    (tmp_path / "old.yaml").write_text("num_processes: 2\n")
    with pytest.raises(RuntimeError, match="PyYAML"):
        load_config_from_file(str(tmp_path / "old.yaml"))
    assert not (tmp_path / "c.yaml").exists()
    assert config_mod.default_config_file().endswith(".json")
    assert load_config_from_file(save_config(ClusterConfig(tp=2),
                                             str(tmp_path / "c.json"))).tp == 2


def test_config_default_subcommand(tmp_path):
    args = get_parser().parse_args(["config", "default", "--config_file",
                                    str(tmp_path / "d.json")])
    args.func(args)
    assert load_config_from_file(str(tmp_path / "d.json")).mixed_precision == "bf16"


def test_config_update_subcommand(tmp_path):
    (tmp_path / "old.json").write_text(json.dumps({"num_processes": 3, "gone_field": 1}))
    args = get_parser().parse_args(["config", "update", "--config_file",
                                    str(tmp_path / "old.json")])
    args.func(args)
    data = json.loads((tmp_path / "old.json").read_text())
    assert data["num_processes"] == 3 and "gone_field" not in data and "tp" in data


def test_config_unknown_keys_ignored(tmp_path):
    (tmp_path / "old.yaml").write_text("num_processes: 2\nsome_future_field: 7\n")
    assert load_config_from_file(str(tmp_path / "old.yaml")).num_processes == 2


def test_config_zoo_templates_load():
    """Every config template shipped with the JAX package parses into the port's
    ``ClusterConfig`` with no unknown field."""
    import yaml

    paths = sorted(glob.glob(str(ROOT / "examples" / "config_yaml_templates" / "*.yaml"))
                   + glob.glob(str(ROOT / "examples" / "slurm" / "*.yaml")))
    assert len(paths) >= 8
    known = {f.name for f in dataclasses.fields(ClusterConfig)}
    for path in paths:
        raw = yaml.safe_load(Path(path).read_text())
        assert not set(raw) - known, path
        assert load_config_from_file(path).num_processes >= 1


def test_config_same_fields_as_jax():
    from accelerate_tpu.commands.config import ClusterConfig as JaxClusterConfig

    assert dataclasses.asdict(ClusterConfig()) == dataclasses.asdict(JaxClusterConfig())


def test_interactive_config_over_scripted_answers(tmp_path, monkeypatch):
    """The questionnaire on a pipe: the numbered menu and free-form answers."""
    answers = iter(["2", "1", "10.0.0.5", "29501", "4", "no", "0", "2", "4", "no", "no", "yes"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    args = get_parser().parse_args(["config", "--config_file", str(tmp_path / "q.json")])
    with contextlib.redirect_stdout(io.StringIO()):
        args.func(args)
    cfg = load_config_from_file(str(tmp_path / "q.json"))
    assert (cfg.num_machines, cfg.machine_rank, cfg.main_process_ip, cfg.main_process_port,
            cfg.num_processes, cfg.mixed_precision, cfg.tp, cfg.gradient_accumulation_steps,
            cfg.debug, cfg.distributed_type) == (2, 1, "10.0.0.5", 29501, 4, "bf16", 2, 4,
                                                 True, "MULTI_HOST")


def test_write_basic_config(tmp_path):
    from accelerate_tpu_torch.commands.config import write_basic_config

    path = write_basic_config("bf16", str(tmp_path / "basic.json"))
    cfg = load_config_from_file(path)
    assert cfg.mixed_precision == "bf16" and cfg.use_cpu and cfg.num_processes == 1
    assert write_basic_config("bf16", str(tmp_path / "basic.json")) is False
    with pytest.raises(ValueError, match="mixed_precision"):
        write_basic_config("int3", str(tmp_path / "other.json"))


# ----------------------------------------------------------------------- env serialization
def _launch_args(extra=()):
    return launch_command_parser().parse_args([*extra, "script.py"])


def _jax_launch_args(extra=()):
    from accelerate_tpu.commands.launch import launch_command_parser as jax_parser

    return jax_parser().parse_args([*extra, "script.py"])


def _accelerate(env: dict) -> dict:
    return {k: v for k, v in env.items() if k.startswith("ACCELERATE_")}


FLAG_SETS = {
    "precision_debug_accum": ["--mixed-precision", "bf16", "--debug",
                              "--gradient-accumulation-steps", "4"],
    "mesh": ["--tp", "2", "--fsdp", "4", "--sp", "1", "--dcn-dp", "2"],
    "fsdp": ["--use-fsdp", "--fsdp-zero-stage", "3", "--fsdp-cpu-offload",
             "--fsdp-state-dict-type", "FULL_STATE_DICT", "--fsdp-min-weight-size", "64"],
    "fp8": ["--mixed-precision", "fp8", "--fp8-format", "E4M3", "--fp8-margin", "0",
            "--fp8-amax-history-len", "8", "--fp8-use-delayed-scaling", "--fp8-opt-level", "O2"],
    "pipeline_sp": ["--pp", "2", "--pp-num-microbatches", "8", "--pp-schedule", "1f1b",
                    "--pp-virtual-stages", "2", "--sp-mode", "ulysses"],
    "data_project": ["--dispatch-batches", "--no-even-batches", "--no-seedable-sampler",
                     "--project-dir", "/tmp/p", "--checkpoint-total-limit", "3",
                     "--log-with", "tensorboard", "--cpu"],
    "none": [],
}


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_simple_launch_env_equals_jax(name):
    from accelerate_tpu.utils.launch import (
        prepare_simple_launcher_cmd_env as jax_prepare)

    flags = FLAG_SETS[name]
    cmd, env = prepare_simple_launcher_cmd_env(_launch_args(flags))
    jax_cmd, jax_env = jax_prepare(_jax_launch_args(flags))
    assert _accelerate(env) == _accelerate(jax_env)
    assert cmd == jax_cmd
    assert str(ROOT) in env["PYTHONPATH"].split(os.pathsep)


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_multi_process_env_equals_jax_with_torchrun_rendezvous(name):
    from accelerate_tpu.utils.launch import prepare_multi_process_env as jax_prepare

    flags = FLAG_SETS[name] + ["--num-processes", "4", "--main-process-port", "12355"]
    env = prepare_multi_process_env(_launch_args(flags), process_id=2)
    jax_env = jax_prepare(_jax_launch_args(flags), process_id=2)
    assert _accelerate(env) == {k: v for k, v in _accelerate(jax_env).items()
                                if k not in JAX_RENDEZVOUS}
    assert jax_env["ACCELERATE_COORDINATOR_ADDRESS"] == "127.0.0.1:12355"
    assert {k: env[k] for k in RENDEZVOUS_KEYS} == {
        "RANK": jax_env["ACCELERATE_PROCESS_ID"], "LOCAL_RANK": "2",
        "WORLD_SIZE": jax_env["ACCELERATE_NUM_PROCESSES"], "LOCAL_WORLD_SIZE": "4",
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "12355"}


def test_mesh_env_serialization():
    env = mesh_env_from_args(_launch_args(["--tp", "2", "--fsdp", "4", "--sp", "1"]))
    assert env == {"ACCELERATE_MESH_TP": "2", "ACCELERATE_MESH_FSDP": "4",
                   "ACCELERATE_MESH_SP": "1"}


def test_simple_launcher_env():
    args = _launch_args(["--mixed-precision", "bf16", "--debug",
                         "--gradient-accumulation-steps", "4"])
    cmd, env = prepare_simple_launcher_cmd_env(args)
    assert cmd[-1] == "script.py"
    assert env["ACCELERATE_MIXED_PRECISION"] == "bf16"
    assert env["ACCELERATE_DEBUG_MODE"] == "true"
    assert env["ACCELERATE_GRADIENT_ACCUMULATION_STEPS"] == "4"


def test_fp8_opt_level_env_serialization():
    _, env = prepare_simple_launcher_cmd_env(
        _launch_args(["--mixed-precision", "fp8", "--fp8-opt-level", "O2"]))
    assert env["ACCELERATE_FP8_OPT_LEVEL"] == "O2"
    _, env = prepare_simple_launcher_cmd_env(
        _launch_args(["--mixed-precision", "fp8", "--fp8-opt-level", "O1"]))
    assert "ACCELERATE_FP8_OPT_LEVEL" not in env


def test_virtual_devices_have_no_gpu_counterpart():
    with pytest.raises(ValueError, match="no counterpart on a GPU host"):
        prepare_simple_launcher_cmd_env(_launch_args(["--num-virtual-devices", "8"]))


def test_multi_machine_ranks():
    """Global rank = machine rank × processes per machine + local rank."""
    args = _launch_args(["--num-processes", "8", "--num-machines", "2", "--machine-rank", "1",
                         "--main-process-ip", "10.0.0.2", "--main-process-port", "7000"])
    envs = [prepare_multi_process_env(args, process_id=i) for i in range(4)]
    assert [e["RANK"] for e in envs] == ["4", "5", "6", "7"]
    assert {(e["WORLD_SIZE"], e["LOCAL_WORLD_SIZE"], e["MASTER_ADDR"], e["MASTER_PORT"])
            for e in envs} == {("8", "4", "10.0.0.2", "7000")}
    with pytest.raises(ValueError, match="evenly"):
        prepare_multi_process_env(_launch_args(["--num-processes", "3", "--num-machines", "2"]),
                                  process_id=0)


def test_module_and_no_python_flags():
    cmd, _ = prepare_simple_launcher_cmd_env(_launch_args(["-m"]))
    assert cmd[:2] == [sys.executable, "-m"]
    cmd, _ = prepare_simple_launcher_cmd_env(_launch_args(["--no-python"]))
    assert cmd[0] == "script.py"


def test_config_defaults_merge_order(tmp_path):
    path = save_config(ClusterConfig(mixed_precision="bf16", tp=2, num_processes=2),
                       str(tmp_path / "c.json"))
    args = _launch_args(["--config-file", path, "--tp", "4"])
    _apply_config_defaults(args)
    assert args.tp == 4
    assert args.mixed_precision == "bf16"
    assert args.num_processes == 2


def test_default_grad_accum_not_serialized(tmp_path):
    path = save_config(ClusterConfig(gradient_accumulation_steps=1), str(tmp_path / "c.json"))
    args = _launch_args(["--config-file", path])
    _apply_config_defaults(args)
    _, env = prepare_simple_launcher_cmd_env(args)
    assert "ACCELERATE_GRADIENT_ACCUMULATION_STEPS" not in env


def test_forwarded_flags_serialise_the_same_environment():
    """The flags another machine's launch is given serialise this one's environment."""
    args = _launch_args(FLAG_SETS["precision_debug_accum"] + FLAG_SETS["mesh"]
                        + FLAG_SETS["data_project"])
    again = _launch_args(_forwarded_flags(args) + ["--dcn-dp", "2"])
    assert (_accelerate(prepare_simple_launcher_cmd_env(again)[1])
            == _accelerate(prepare_simple_launcher_cmd_env(args)[1]))


# ----------------------------------------------------------------------------- dry runs
def _dry_run(args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launch_command(args) == 0
    return buf.getvalue()


def test_launch_dry_run_single():
    out = _dry_run(_launch_args(["--dry-run", "--mixed-precision", "bf16"]))
    assert "ACCELERATE_MIXED_PRECISION=bf16" in out and "script.py" in out


def test_launch_dry_run_multi_process_prints_jax_env_with_torchrun_keys(capsys):
    from accelerate_tpu.commands.launch import launch_command as jax_launch

    flags = ["--dry-run", "--multi-process", "--num-processes", "2", "--mixed-precision",
             "bf16", "--tp", "2"]
    out = _dry_run(_launch_args(flags))
    jax_launch(_jax_launch_args(flags))
    jax_out = capsys.readouterr().out
    assert "--- process 0 ---" in out and "--- process 1 ---" in out
    assert "RANK=1" in out and "MASTER_PORT=29500" in out

    def accelerate_lines(text):
        return sorted(line.strip() for line in text.splitlines()
                      if line.strip().startswith("ACCELERATE_")
                      and not line.strip().startswith(JAX_RENDEZVOUS))

    assert accelerate_lines(out) == accelerate_lines(jax_out)


def test_launch_dry_run_multi_machine_prints_each_machines_launch():
    out = _dry_run(_launch_args(["--dry-run", "--multi-process", "--num-processes", "4",
                                 "--num-machines", "2", "--main-process-ip", "10.0.0.2",
                                 "--mixed-precision", "bf16"]))
    assert out.count("--- process") == 2
    assert "--- machine 1 runs ---" in out and "--machine-rank 1" in out
    assert "--mixed-precision bf16" in out


@pytest.mark.parametrize("flags", [["--tpu-pod", "--tpu-name", "my-pod"],
                                   ["--tpu-name", "my-pod", "--tpu-zone", "z"]])
def test_tpu_pod_raises_with_a_reason(flags):
    with pytest.raises(ValueError, match="no GPU counterpart"):
        launch_command(_launch_args(["--dry-run", *flags]))


# ------------------------------------------------------------------------- the CLI root
def test_cli_help_lists_subcommands(capsys):
    with pytest.raises(SystemExit):
        get_parser().parse_args(["--help"])
    out = capsys.readouterr().out
    for sub in ("capsule-report", "config", "env", "launch", "merge-weights", "metrics-dump",
                "serve-bench", "trace-report"):
        assert sub in out


def test_cli_commands_run_as_module(tmp_path):
    for argv in (["launch", "--help"], ["merge-weights", "--help"], ["config", "--help"],
                 ["env"]):
        res = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch", *argv],
                             capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert res.returncode == 0, (argv, res.stderr)


def test_env_command_reports(capsys):
    from accelerate_tpu_torch.commands.env import env_command

    info = env_command(SimpleNamespace(config_file="/nonexistent"))
    assert info["torch version"] == torch.__version__
    assert info["Device count"] == 0 and info["Devices"] == "cpu"
    assert info["Default config"] == "not found"
    assert "nvidia-smi (name, power limit)" in info
    assert "torch version" in capsys.readouterr().out


def test_subprocess_simple_launch_env_propagation(tmp_path):
    """The whole exec path: the child sees the serialised environment and imports the
    port from the launcher's PYTHONPATH."""
    script = tmp_path / "child.py"
    out = tmp_path / "env.json"
    script.write_text(
        "import json, os, sys\n"
        "import accelerate_tpu_torch\n"
        f"json.dump({{k: v for k, v in os.environ.items() if k.startswith('ACCELERATE_')}}, "
        f"open({str(out)!r}, 'w'))\n")
    res = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch", "launch",
                          "--mixed-precision", "bf16", "--gradient-accumulation-steps", "2",
                          "--cpu", str(script)], capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env={k: v for k, v in os.environ.items()
                                            if k != "PYTHONPATH"} | {
                             "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    env = json.loads(out.read_text())
    assert env["ACCELERATE_MIXED_PRECISION"] == "bf16"
    assert env["ACCELERATE_GRADIENT_ACCUMULATION_STEPS"] == "2"
    assert env["ACCELERATE_USE_CPU"] == "true"


def test_simple_launcher_restarts_then_raises(tmp_path):
    """``--max-restarts`` runs a failing script again; the last exit code is raised."""
    runs = tmp_path / "runs"
    script = tmp_path / "fail.py"
    script.write_text(f"open({str(runs)!r}, 'a').write('x'); import sys; sys.exit(5)\n")
    args = launch_command_parser().parse_args(["--max-restarts", "1", str(script)])
    with pytest.raises(subprocess.CalledProcessError) as exc:
        launch_command(args)
    assert exc.value.returncode == 5
    assert runs.read_text() == "xx"


# ------------------------------------------------- the library reads the environment back
def test_state_reads_the_launcher_environment(monkeypatch):
    from accelerate_tpu_torch.accelerator import Accelerator

    monkeypatch.setenv("ACCELERATE_USE_CPU", "true")
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "bf16")
    monkeypatch.setenv("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", "4")
    monkeypatch.setenv("ACCELERATE_DEBUG_MODE", "1")
    acc = Accelerator()
    assert acc.device == torch.device("cpu")
    assert acc.mixed_precision == "bf16"
    assert acc.gradient_accumulation_steps == 4
    assert acc.state.debug is True
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    # An explicit argument, 1 included, wins over the launcher's variable.
    acc = Accelerator(gradient_accumulation_steps=1, mixed_precision="no")
    assert acc.gradient_accumulation_steps == 1 and acc.mixed_precision == "no"


def test_state_env_matches_jax(monkeypatch):
    """The same variables give the JAX package's ``Accelerator`` the same settings."""
    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu.state import (AcceleratorState as JaxAcceleratorState,
                                      GradientState as JaxGradientState,
                                      PartialState as JaxPartialState)
    from accelerate_tpu_torch.accelerator import Accelerator

    monkeypatch.setenv("ACCELERATE_USE_CPU", "true")
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "bf16")
    monkeypatch.setenv("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", "3")
    for cls in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
        cls._reset_state()
    try:
        jax_acc = JaxAccelerator()
        want = (jax_acc.mixed_precision, jax_acc.gradient_accumulation_steps)
    finally:
        for cls in (JaxAcceleratorState, JaxGradientState, JaxPartialState):
            cls._reset_state()
    acc = Accelerator()
    assert (acc.mixed_precision, acc.gradient_accumulation_steps) == want


@pytest.mark.parametrize("var,value", [
    ("ACCELERATE_USE_FSDP", "true"), ("ACCELERATE_FSDP_ZERO_STAGE", "3"),
    ("ACCELERATE_FSDP_CPU_OFFLOAD", "true"), ("ACCELERATE_SP_MODE", "ring"),
    ("ACCELERATE_PP_MICROBATCHES", "4"), ("ACCELERATE_PP_SCHEDULE", "1f1b"),
    ("ACCELERATE_FP8_FORMAT", "E4M3"), ("ACCELERATE_FP8_OPT_LEVEL", "O2"),
    ("ACCELERATE_LOG_WITH", "tensorboard"), ("ACCELERATE_MIXED_PRECISION", "fp8"),
])
def test_unported_launcher_flags_fail_loudly(monkeypatch, var, value):
    from accelerate_tpu_torch.accelerator import Accelerator

    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="not ported"):
        Accelerator(device="cpu")


def test_use_fsdp_false_is_not_a_request(monkeypatch):
    from accelerate_tpu_torch.accelerator import Accelerator

    monkeypatch.setenv("ACCELERATE_USE_FSDP", "false")
    assert Accelerator(device="cpu").device == torch.device("cpu")


# ------------------------------------------------------------------------ environment
def test_environment_helpers(monkeypatch):
    from accelerate_tpu.utils import environment as jax_env
    from accelerate_tpu_torch.utils import environment as env

    for value in ("1", "true", "YES", "y", "on", "0", "false", "No", "n", "off", ""):
        assert env.str_to_bool(value) == jax_env.str_to_bool(value)
    with pytest.raises(ValueError):
        env.str_to_bool("maybe")
    monkeypatch.setenv("A_INT", "-1")
    monkeypatch.setenv("B_INT", "7")
    assert env.get_int_from_env(["A_INT", "B_INT"], 3) == 7
    assert env.get_int_from_env(["C_INT"], 3) == 3
    for raw in ("true", "0", "garbage", None):
        if raw is None:
            monkeypatch.delenv("SOME_FLAG", raising=False)
        else:
            monkeypatch.setenv("SOME_FLAG", raw)
        for default in (False, True):
            assert (env.parse_flag_from_env("SOME_FLAG", default)
                    == jax_env.parse_flag_from_env("SOME_FLAG", default))
    assert env.parse_choice_from_env("NO_SUCH_CHOICE", "bf16") == "bf16"
    monkeypatch.setenv("ACCELERATE_PURGED", "1")
    with env.patch_environment(new_key="x", accelerate_purged="2"):
        assert os.environ["NEW_KEY"] == "x" and os.environ["ACCELERATE_PURGED"] == "2"
        with env.clear_environment():
            assert os.environ == {}
        assert os.environ["NEW_KEY"] == "x"
    assert "NEW_KEY" not in os.environ and os.environ["ACCELERATE_PURGED"] == "1"
    seen = env.purge_accelerate_environment(
        lambda: sorted(k for k in os.environ if k.startswith("ACCELERATE_")))()
    assert seen == [] and os.environ["ACCELERATE_PURGED"] == "1"
    assert env.subprocess_probe("print('ALIVE')", timeout_s=60)
    assert not env.subprocess_probe("import time; time.sleep(5)", timeout_s=0.5)


def test_other_helpers(tmp_path):
    from accelerate_tpu.utils import other as jax_other
    from accelerate_tpu_torch.utils import other

    for size in (10, 2048, 3.5e9, 7e15):
        assert other.convert_bytes(size) == jax_other.convert_bytes(size)
    a = {"x": {"y": 1, "z": 2}, "w": 1}
    assert other.merge_dicts({"x": {"y": 5}, "v": 3}, dict(a, x=dict(a["x"]))) == {
        "x": {"y": 5, "z": 2}, "w": 1, "v": 3}
    port = other.get_free_port()
    assert 0 < port < 65536 and not other.is_port_in_use(port)
    other.save({"a": torch.arange(3.0), "b": [np.ones(2, np.float32)]}, tmp_path / "t.st")
    from accelerate_tpu_torch.utils.serialization import load_flat_safetensors

    loaded = load_flat_safetensors(tmp_path / "t.st")
    assert sorted(loaded) == ["a", "b/0"] and torch.equal(loaded["a"], torch.arange(3.0))
    other.save({"step": 3}, tmp_path / "meta.pkl")
    import pickle

    assert pickle.loads((tmp_path / "meta.pkl").read_bytes()) == {"step": 3}


# ------------------------------------------------------------------------- merge-weights
def test_merge_weights_roundtrip(tmp_path):
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.commands.merge import merge_weights
    from accelerate_tpu_torch.utils.serialization import load_pytree_safetensors

    acc = Accelerator(device="cpu")
    params = {"w": torch.ones(4, 4) * 3, "b": torch.zeros(4)}
    state = acc.create_train_state({k: v.clone() for k, v in params.items()}, optim.sgd(0.1))
    acc.save_state(str(tmp_path / "ckpt"), train_state=state)
    index = merge_weights(str(tmp_path / "ckpt"), str(tmp_path / "merged"))
    assert set(index["weight_map"]) == {"w", "b"}
    merged = load_pytree_safetensors(tmp_path / "merged" / "model.safetensors")
    assert torch.equal(merged["w"], params["w"])


def test_merge_command_via_cli(tmp_path):
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator

    acc = Accelerator(device="cpu")
    state = acc.create_train_state({"w": torch.arange(6.0).reshape(2, 3)}, optim.sgd(0.1))
    acc.save_state(str(tmp_path / "ckpt"), train_state=state)
    args = get_parser().parse_args(["merge-weights", str(tmp_path / "ckpt" / "sharded_state"),
                                    str(tmp_path / "out"), "--full-state"])
    with contextlib.redirect_stdout(io.StringIO()):
        index = args.func(args)
    assert "params/w" in index["weight_map"] and "step" in index["weight_map"]


# ------------------------------------------------------------------------------ launchers
def rank_report(value):
    import torch.distributed as dist

    from accelerate_tpu_torch.state import PartialState

    state = PartialState(cpu=True)
    assert value == 42, value
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "index": state.process_index, "device": str(state.device),
            "use_cpu": os.environ.get("ACCELERATE_USE_CPU"),
            "precision": os.environ.get("ACCELERATE_MIXED_PRECISION")}


def fail_first_attempt(flag: str):
    import torch.distributed as dist

    if dist.get_rank() == 1 and not os.path.exists(flag):
        open(flag, "w").write("failed once")
        raise RuntimeError("rank 1 fails on the first attempt")
    return dist.get_rank()


def test_notebook_launcher_single_process_runs_inline():
    from accelerate_tpu_torch.launchers import notebook_launcher

    calls = []
    notebook_launcher(lambda v: calls.append(v), ("x",), num_processes=1)
    assert calls == ["x"]


def test_debug_launcher_two_processes_rendezvous():
    from accelerate_tpu_torch.launchers import debug_launcher

    ranks = debug_launcher(rank_report, (42,), num_processes=2)
    assert [(r["rank"], r["world"], r["index"], r["device"], r["use_cpu"]) for r in ranks] == [
        (0, 2, 0, "cpu", "true"), (1, 2, 1, "cpu", "true")]


def test_notebook_launcher_surfaces_child_failure():
    from accelerate_tpu_torch.launchers import debug_launcher

    with pytest.raises(RuntimeError, match="exit codes"):
        debug_launcher(rank_report, (7,), num_processes=2)


def test_notebook_launcher_restarts_on_a_fresh_rendezvous(tmp_path, capsys):
    from accelerate_tpu_torch.launchers import notebook_launcher

    flag = str(tmp_path / "failed_once")
    assert notebook_launcher(fail_first_attempt, (flag,), 2, max_restarts=1, device="cpu",
                             backend="gloo", timeout_s=60) == [0, 1]
    assert os.path.exists(flag)
    assert "restart 1/1" in capsys.readouterr().out
    os.remove(flag)
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed.*attempt 1/1"):
        notebook_launcher(fail_first_attempt, (flag,), 2, device="cpu", backend="gloo",
                          timeout_s=60)


def test_notebook_launcher_mixed_precision_env(monkeypatch):
    from accelerate_tpu_torch.launchers import notebook_launcher

    # Recorded first, so the variable the launcher writes is undone after the test.
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "no")
    ranks = notebook_launcher(rank_report, (42,), 2, mixed_precision="bf16", device="cpu",
                              backend="gloo", timeout_s=60)
    assert [r["precision"] for r in ranks] == ["bf16", "bf16"]
    assert os.environ["ACCELERATE_MIXED_PRECISION"] == "bf16"


def test_notebook_launcher_two_nodes():
    """Two nodes of one process each on this host (``num_nodes=2``, ``node_rank`` 0 and
    1, a tcp rendezvous on ``use_port``): global ranks 0 and 1 of a world of 2."""
    from accelerate_tpu_torch.launchers import notebook_launcher
    from accelerate_tpu_torch.utils.other import get_free_port

    port = get_free_port()
    out = {}

    def node(rank):
        out[rank] = notebook_launcher(rank_report, (42,), 1, use_port=port, node_rank=rank,
                                      num_nodes=2, device="cpu", backend="gloo", timeout_s=60)

    threads = [threading.Thread(target=node, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert [(out[r][0]["rank"], out[r][0]["world"]) for r in (0, 1)] == [(0, 2), (1, 2)]
