"""The launcher's environment: the port's counterpart of ``accelerate_tpu/utils/launch.py``.

The launcher serialises its flags and config file into ``ACCELERATE_*`` variables, key
for key as the JAX package does (``_common_env``), which ``state``, ``accelerator`` and
``utils/dataclasses`` read back. The rendezvous is torchrun's contract in place of the
JAX coordinator triple (``ACCELERATE_COORDINATOR_ADDRESS``, ``_NUM_PROCESSES``,
``_PROCESS_ID``): ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``, which ``state.PartialState`` joins through
``env://``. Here every rank is a process; across machines the global rank is
``machine_rank × processes per machine + local rank``.

``--num-virtual-devices`` (an XLA flag that simulates TPU chips on the CPU) has no
counterpart and raises.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Optional

from .constants import ENV_PREFIX

__all__ = ["prepare_simple_launcher_cmd_env", "prepare_multi_process_env",
           "mesh_env_from_args", "PrepareForLaunch", "RENDEZVOUS_KEYS"]

_MESH_AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep", "dcn_dp")
#: The rendezvous variables of a multi-process launch (torchrun's names).
RENDEZVOUS_KEYS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                   "MASTER_PORT")


def _str_flag(value: bool) -> str:
    return "true" if value else "false"


def mesh_env_from_args(args: Any) -> dict[str, str]:
    """``--dp/--fsdp/--tp/--sp/--pp/--ep`` flags → ``ACCELERATE_MESH_*``."""
    env: dict[str, str] = {}
    for axis in _MESH_AXES:
        value = getattr(args, axis, None)
        if value is not None:
            env[f"{ENV_PREFIX}MESH_{axis.upper()}"] = str(value)
    return env


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _common_env(args: Any) -> dict[str, str]:
    if getattr(args, "num_virtual_devices", None):
        raise ValueError(
            "--num-virtual-devices simulates TPU chips on the CPU through an XLA flag and "
            "has no counterpart on a GPU host: name the processes with --num-processes "
            "(--cpu for CPU ranks)")
    env: dict[str, str] = {}
    # A launched script imports the package from a source tree: its root rides
    # PYTHONPATH (what was there is kept).
    root = _package_root()
    existing = os.environ.get("PYTHONPATH", "")
    if root not in existing.split(os.pathsep):
        env["PYTHONPATH"] = f"{root}{os.pathsep}{existing}" if existing else root
    if getattr(args, "mixed_precision", None):
        env[f"{ENV_PREFIX}MIXED_PRECISION"] = str(args.mixed_precision).lower()
    if getattr(args, "cpu", False) or getattr(args, "use_cpu", False):
        env[f"{ENV_PREFIX}USE_CPU"] = "true"
    if getattr(args, "debug", False):
        env[f"{ENV_PREFIX}DEBUG_MODE"] = "true"
    if getattr(args, "gradient_accumulation_steps", None):
        env[f"{ENV_PREFIX}GRADIENT_ACCUMULATION_STEPS"] = str(args.gradient_accumulation_steps)
    if getattr(args, "use_fsdp", False):
        env[f"{ENV_PREFIX}USE_FSDP"] = "true"
    if getattr(args, "fsdp_zero_stage", None):
        env[f"{ENV_PREFIX}FSDP_ZERO_STAGE"] = str(args.fsdp_zero_stage)
        env.setdefault(f"{ENV_PREFIX}USE_FSDP", "true")
    if getattr(args, "fsdp_cpu_offload", False):
        env[f"{ENV_PREFIX}FSDP_CPU_OFFLOAD"] = "true"
    if getattr(args, "fsdp_state_dict_type", None):
        env[f"{ENV_PREFIX}FSDP_STATE_DICT_TYPE"] = str(args.fsdp_state_dict_type)
    if getattr(args, "fsdp_min_weight_size", None):
        env[f"{ENV_PREFIX}FSDP_MIN_WEIGHT_SIZE"] = str(args.fsdp_min_weight_size)
    if getattr(args, "sp_mode", None):
        env[f"{ENV_PREFIX}SP_MODE"] = str(args.sp_mode)
    if getattr(args, "fp8_format", None):
        env[f"{ENV_PREFIX}FP8_FORMAT"] = str(args.fp8_format)
    if getattr(args, "fp8_margin", None) is not None:
        env[f"{ENV_PREFIX}FP8_MARGIN"] = str(args.fp8_margin)
    if getattr(args, "fp8_amax_history_len", None):
        env[f"{ENV_PREFIX}FP8_AMAX_HISTORY_LEN"] = str(args.fp8_amax_history_len)
    if getattr(args, "fp8_use_delayed_scaling", None):
        env[f"{ENV_PREFIX}FP8_DELAYED_SCALING"] = "true"
    if getattr(args, "fp8_opt_level", None) and args.fp8_opt_level != "O1":
        env[f"{ENV_PREFIX}FP8_OPT_LEVEL"] = str(args.fp8_opt_level)
    if getattr(args, "pp_num_microbatches", None):
        env[f"{ENV_PREFIX}PP_MICROBATCHES"] = str(args.pp_num_microbatches)
    if getattr(args, "pp_schedule", None):
        env[f"{ENV_PREFIX}PP_SCHEDULE"] = str(args.pp_schedule)
    if getattr(args, "pp_virtual_stages", None):
        env[f"{ENV_PREFIX}PP_VIRTUAL_STAGES"] = str(args.pp_virtual_stages)
    if getattr(args, "dispatch_batches", None) is not None:
        env[f"{ENV_PREFIX}DISPATCH_BATCHES"] = _str_flag(args.dispatch_batches)
    if getattr(args, "even_batches", None) is not None:
        env[f"{ENV_PREFIX}EVEN_BATCHES"] = _str_flag(args.even_batches)
    if getattr(args, "use_seedable_sampler", None) is not None:
        env[f"{ENV_PREFIX}USE_SEEDABLE_SAMPLER"] = _str_flag(args.use_seedable_sampler)
    if getattr(args, "project_dir", None):
        env[f"{ENV_PREFIX}PROJECT_DIR"] = str(args.project_dir)
    if getattr(args, "checkpoint_total_limit", None):
        env[f"{ENV_PREFIX}CHECKPOINT_TOTAL_LIMIT"] = str(args.checkpoint_total_limit)
    if getattr(args, "log_with", None):
        env[f"{ENV_PREFIX}LOG_WITH"] = str(args.log_with)
    env.update(mesh_env_from_args(args))
    return env


def _script_cmd(args: Any) -> list[str]:
    cmd = []
    if not getattr(args, "no_python", False):
        cmd.append(sys.executable)
        if getattr(args, "module", False):
            cmd.append("-m")
    cmd.append(args.training_script)
    cmd.extend(getattr(args, "training_script_args", []) or [])
    return cmd


def prepare_simple_launcher_cmd_env(args: Any) -> tuple[list[str], dict[str, str]]:
    """One process: the script's command and the serialised environment."""
    env = {**os.environ, **_common_env(args)}
    return _script_cmd(args), env


def prepare_multi_process_env(args: Any, process_id: int, num_processes: Optional[int] = None,
                              coordinator_address: Optional[str] = None) -> dict[str, str]:
    """The environment of this machine's process ``process_id`` in a multi-process
    launch: the serialised flags and torchrun's rendezvous. ``num_processes`` counts the
    processes of every machine (``--num-processes``), split evenly over
    ``--num-machines``; ``coordinator_address`` is ``host:port`` (default
    ``--main-process-ip``:``--main-process-port``, or 127.0.0.1:29500)."""
    num_processes = num_processes or int(getattr(args, "num_processes", 1) or 1)
    machines = int(getattr(args, "num_machines", None) or 1)
    machine_rank = int(getattr(args, "machine_rank", None) or 0)
    if num_processes % machines:
        raise ValueError(f"--num-processes {num_processes} does not split evenly over "
                         f"--num-machines {machines}")
    if not 0 <= machine_rank < machines:
        raise ValueError(f"--machine-rank {machine_rank} is not in [0, {machines})")
    local = num_processes // machines
    if coordinator_address is None:
        ip = getattr(args, "main_process_ip", None) or "127.0.0.1"
        port = getattr(args, "main_process_port", None) or 29500
        coordinator_address = f"{ip}:{port}"
    host, port = coordinator_address.rsplit(":", 1)
    env = {**os.environ, **_common_env(args)}
    env.update(RANK=str(machine_rank * local + process_id), LOCAL_RANK=str(process_id),
               WORLD_SIZE=str(num_processes), LOCAL_WORLD_SIZE=str(local),
               MASTER_ADDR=host, MASTER_PORT=str(port))
    return env


class PrepareForLaunch:
    """Picklable target of spawned ranks (``launchers.notebook_launcher``): sets the
    rank's rendezvous variables in the child, joins the process group
    (``state.PartialState`` with the given device and backend) and calls
    ``launcher(*args)``, leaving the group afterwards. ``index`` is the rank's index
    on this node; its global rank is ``node_rank × num_processes + index``."""

    def __init__(self, launcher, num_processes: int, init_method: str, num_nodes: int = 1,
                 node_rank: int = 0, device=None, backend: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        self.launcher = launcher
        self.num_processes = num_processes
        self.init_method = init_method
        self.num_nodes = num_nodes
        self.node_rank = node_rank
        self.device = device
        self.backend = backend
        self.timeout_s = timeout_s

    def __call__(self, index: int, *args):
        world = self.num_processes * self.num_nodes
        rank = self.node_rank * self.num_processes + index
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(index),
                          LOCAL_WORLD_SIZE=str(self.num_processes), FORK_LAUNCHED="true")
        if self.init_method.startswith("tcp://"):
            host, port = self.init_method.removeprefix("tcp://").rsplit(":", 1)
            os.environ.update(MASTER_ADDR=host, MASTER_PORT=port)
        from ..state import PartialState

        device = self.device
        if isinstance(device, (list, tuple)):
            device = device[index]
        state = PartialState(device=device, backend=self.backend, init_method=self.init_method,
                             rank=rank, world_size=world, timeout_s=self.timeout_s)
        try:
            return self.launcher(*args)
        finally:
            state.destroy_process_group()
