"""``python -m accelerate_tpu_torch launch``: run a training script with the
``ACCELERATE_*`` environment, the port's counterpart of
``accelerate_tpu/commands/launch.py``.

- **simple** (the default): one process, its flags and config file serialised into its
  environment (``utils/launch.py``), run with ``subprocess``; ``--max-restarts`` runs it
  again after a failure.
- **multi-process** (``--multi-process --num-processes N``): this machine's share of the N
  processes (``N / --num-machines``), each given torchrun's rendezvous (``RANK``,
  ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; global rank =
  ``--machine-rank`` × processes per machine + local rank), under an
  ``elastic.ElasticSupervisor``: any worker's death tears the gang down and launches it
  again on a fresh port (one machine; across machines the given ``--main-process-port``
  is kept), up to ``--max-restarts`` times. Each machine runs its own ``launch``.
- ``--dry-run`` prints each process's command and its ``ACCELERATE_*`` and rendezvous
  variables instead.

``--tpu-pod``/``--tpu-name``/``--tpu-zone`` (a ``gcloud ... tpu-vm ssh`` fan-out) and
``--num-virtual-devices`` (an XLA flag) have no GPU counterpart: they raise.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import time

from ..utils.launch import (
    RENDEZVOUS_KEYS,
    prepare_multi_process_env,
    prepare_simple_launcher_cmd_env,
)
from .config import ClusterConfig, default_config_file, load_config_from_file

__all__ = ["launch_command", "launch_command_parser"]


def launch_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Launch a script on the GPU (or the CPU) with accelerate_tpu_torch."
    if subparsers is not None:
        parser = subparsers.add_parser("launch", description=description, add_help=True)
    else:
        parser = argparse.ArgumentParser("python -m accelerate_tpu_torch launch",
                                         description=description)

    hw = parser.add_argument_group("Hardware selection")
    hw.add_argument("--cpu", "--use_cpu", dest="cpu", action="store_true", help="Run on the CPU.")
    hw.add_argument(
        "--num-virtual-devices", "--num_virtual_devices", type=int, default=None,
        help="The JAX package's XLA CPU simulator; no GPU counterpart (raises).",
    )

    res = parser.add_argument_group("Resource selection")
    res.add_argument("--num-processes", "--num_processes", type=int, default=None,
                     help="Processes over every machine (one per card).")
    res.add_argument("--num-machines", "--num_machines", type=int, default=None)
    res.add_argument("--machine-rank", "--machine_rank", type=int, default=None)
    res.add_argument("--main-process-ip", "--main_process_ip", default=None)
    res.add_argument("--main-process-port", "--main_process_port", type=int, default=None)
    res.add_argument("--multi-process", "--multi_process", action="store_true",
                     help="Spawn this machine's share of --num-processes with a torchrun-style "
                          "rendezvous, supervised by ElasticSupervisor.")
    res.add_argument("--max-restarts", "--max_restarts", type=int, default=0,
                     help="Elastic supervision: restart the launch this many times on failure.")

    mesh = parser.add_argument_group("Mesh / parallelism (chip axes)")
    for axis, doc in (
        ("dp", "data"), ("fsdp", "ZeRO/FSDP"), ("tp", "tensor"),
        ("sp", "sequence"), ("pp", "pipeline"), ("ep", "expert"),
    ):
        mesh.add_argument(f"--{axis}", type=int, default=None, help=f"{doc}-parallel degree.")
    mesh.add_argument(
        "--dcn-dp", "--dcn_dp", dest="dcn_dp", type=int, default=None,
        help="Multi-slice: dp replicas placed across slice boundaries (DCN carries only "
             "the dp all-reduce; other axes stay on intra-slice ICI). Must divide --dp.",
    )
    mesh.add_argument("--use-fsdp", "--use_fsdp", action="store_true")
    mesh.add_argument("--fsdp-zero-stage", "--fsdp_zero_stage", type=int, default=None)
    mesh.add_argument("--fsdp-cpu-offload", "--fsdp_cpu_offload", action="store_true",
                      default=None, help="ZeRO-Offload: optimizer state in host RAM.")
    mesh.add_argument("--fsdp-state-dict-type", "--fsdp_state_dict_type", default=None,
                      choices=[None, "SHARDED_STATE_DICT", "FULL_STATE_DICT"])
    mesh.add_argument("--fsdp-min-weight-size", "--fsdp_min_weight_size", type=int, default=None)
    mesh.add_argument("--sp-mode", "--sp_mode", default=None,
                      choices=[None, "ring", "ulysses", "allgather"])
    mesh.add_argument("--pp-num-microbatches", "--pp_num_microbatches", type=int, default=None,
                      help="GPipe microbatch count for the pp axis.")
    mesh.add_argument("--pp-schedule", "--pp_schedule", default=None,
                      choices=[None, "gpipe", "1f1b"],
                      help="Pipeline schedule (ACCELERATE_PP_SCHEDULE).")
    mesh.add_argument("--pp-virtual-stages", "--pp_virtual_stages", type=int, default=None,
                      help="Interleaved virtual-pipeline chunks per device "
                           "(requires --pp-schedule 1f1b; ACCELERATE_PP_VIRTUAL_STAGES).")

    fp8 = parser.add_argument_group("FP8 recipe")
    fp8.add_argument("--fp8-format", "--fp8_format", default=None,
                     choices=[None, "HYBRID", "E4M3"])
    fp8.add_argument("--fp8-margin", "--fp8_margin", type=int, default=None,
                     help="Back the fp8 scale off by 2^margin.")
    fp8.add_argument("--fp8-amax-history-len", "--fp8_amax_history_len", type=int, default=None,
                     help="Delayed-scaling amax rolling-history length.")
    fp8.add_argument("--fp8-use-delayed-scaling", "--fp8_use_delayed_scaling",
                     action="store_true", default=None,
                     help="TE-style delayed scaling instead of per-call current scaling.")
    fp8.add_argument("--fp8-opt-level", "--fp8_opt_level", default=None,
                     choices=[None, "O1", "O2"],
                     help="MS-AMP analog: O2 stores AdamW moments as scaled-fp8 "
                          "(requires the fused optimizer; ACCELERATE_FP8_OPT_LEVEL).")

    train = parser.add_argument_group("Training")
    train.add_argument("--mixed-precision", "--mixed_precision", default=None,
                       choices=[None, "no", "bf16", "fp16", "fp8"])
    train.add_argument("--gradient-accumulation-steps", "--gradient_accumulation_steps",
                       type=int, default=None)
    train.add_argument("--debug", action="store_true", help="Enable collective shape verification.")
    train.add_argument("--project-dir", "--project_dir", default=None,
                       help="Checkpoint/log root (ProjectConfiguration).")
    train.add_argument("--checkpoint-total-limit", "--checkpoint_total_limit", type=int,
                       default=None, help="Keep at most N checkpoints (rotation).")
    train.add_argument("--log-with", "--log_with", default=None,
                       help="Tracker(s) to enable, e.g. tensorboard or wandb.")

    data = parser.add_argument_group("Data loading")
    data.add_argument("--dispatch-batches", "--dispatch_batches", action="store_true",
                      default=None, help="Rank 0 reads batches and broadcasts slices.")
    data.add_argument("--no-even-batches", dest="even_batches", action="store_false",
                      default=None, help="Allow uneven final batches across processes.")
    data.add_argument("--no-seedable-sampler", dest="use_seedable_sampler",
                      action="store_false", default=None,
                      help="Disable the reproducible seedable sampler.")

    pod = parser.add_argument_group("TPU pod (the JAX package's; no GPU counterpart, raises)")
    pod.add_argument("--tpu-pod", "--tpu_pod", action="store_true",
                     help="gcloud tpu-vm ssh fan-out to pod workers.")
    pod.add_argument("--tpu-name", "--tpu_name", default=None)
    pod.add_argument("--tpu-zone", "--tpu_zone", default=None)
    pod.add_argument("--dry-run", "--dry_run", action="store_true",
                     help="Print the commands/env instead of executing.")

    parser.add_argument("--config-file", "--config_file", default=None)
    parser.add_argument("-m", "--module", action="store_true",
                        help="Interpret training_script as a python module (python -m).")
    parser.add_argument("--no-python", "--no_python", action="store_true",
                        help="Run training_script directly (it has a shebang).")
    parser.add_argument("training_script", help="Script (or module) to launch.")
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER, default=[])
    if subparsers is not None:
        parser.set_defaults(func=launch_command)
    return parser


def _apply_config_defaults(args) -> None:
    """The config file's values fill the flags left unset (flags win)."""
    path = args.config_file or (default_config_file() if os.path.isfile(default_config_file()) else None)
    if path is None:
        return
    cfg: ClusterConfig = load_config_from_file(path)
    defaults = {
        "num_processes": cfg.num_processes,
        "num_machines": cfg.num_machines,
        "machine_rank": cfg.machine_rank,
        "main_process_ip": cfg.main_process_ip,
        "main_process_port": cfg.main_process_port,
        "mixed_precision": None if cfg.mixed_precision == "no" else cfg.mixed_precision,
        # 1 is the neutral default — don't serialize it into the child env, where it would
        # shadow the script's own explicit gradient_accumulation_steps argument.
        "gradient_accumulation_steps": cfg.gradient_accumulation_steps
        if cfg.gradient_accumulation_steps != 1
        else None,
        "fsdp_zero_stage": cfg.fsdp_zero_stage or None,
        "fsdp_cpu_offload": cfg.fsdp_cpu_offload or None,
        "fsdp_state_dict_type": (
            cfg.fsdp_state_dict_type if cfg.fsdp_state_dict_type != "SHARDED_STATE_DICT" else None
        ),
        "fsdp_min_weight_size": (
            cfg.fsdp_min_weight_size if cfg.fsdp_min_weight_size != 1024 else None
        ),
        "sp_mode": cfg.sp_mode if cfg.sp_mode != "ring" else None,
        "fp8_format": cfg.fp8_format if cfg.fp8_format != "HYBRID" else None,
        "fp8_margin": cfg.fp8_margin or None,
        "fp8_amax_history_len": cfg.fp8_amax_history_len if cfg.fp8_amax_history_len != 16 else None,
        "fp8_use_delayed_scaling": cfg.fp8_use_delayed_scaling or None,
        "fp8_opt_level": cfg.fp8_opt_level if cfg.fp8_opt_level != "O1" else None,
        "pp_num_microbatches": cfg.pp_num_microbatches,
        "pp_schedule": getattr(cfg, "pp_schedule", None),
        "pp_virtual_stages": getattr(cfg, "pp_virtual_stages", None),
        "dispatch_batches": cfg.dispatch_batches,
        "even_batches": cfg.even_batches if cfg.even_batches is not True else None,
        "use_seedable_sampler": (
            cfg.use_seedable_sampler if cfg.use_seedable_sampler is not True else None
        ),
        "project_dir": cfg.project_dir,
        "checkpoint_total_limit": cfg.checkpoint_total_limit,
        "log_with": cfg.log_with,
        "num_virtual_devices": cfg.num_virtual_devices,
        "dp": cfg.dp if cfg.dp != -1 else None,
        "fsdp": cfg.fsdp if cfg.fsdp != 1 else None,
        "tp": cfg.tp if cfg.tp != 1 else None,
        "sp": cfg.sp if cfg.sp != 1 else None,
        "pp": cfg.pp if cfg.pp != 1 else None,
        "ep": cfg.ep if cfg.ep != 1 else None,
        "tpu_name": cfg.tpu_name,
        "tpu_zone": cfg.tpu_zone,
    }
    for key, value in defaults.items():
        # Only fill truly-unset (None) args — an explicit 0 (e.g. --machine-rank 0) must win.
        if getattr(args, key, None) is None and value is not None:
            setattr(args, key, value)
    if cfg.use_cpu:
        args.cpu = True
    if cfg.debug:
        args.debug = True


def _shown(env: dict) -> dict:
    return {k: v for k, v in env.items() if k.startswith("ACCELERATE_") or k in RENDEZVOUS_KEYS}


def simple_launcher(args) -> int:
    """One process, run again after a failure up to ``--max-restarts`` times."""
    cmd, env = prepare_simple_launcher_cmd_env(args)
    if args.dry_run:
        _print_plan([(cmd, _shown(env))])
        return 0
    attempts = args.max_restarts + 1
    for attempt in range(attempts):
        proc = subprocess.run(cmd, env=env)
        if proc.returncode == 0:
            return 0
        if attempt < attempts - 1:
            print(f"[accelerate_tpu_torch] child exited {proc.returncode}; "
                  f"restart {attempt + 1}/{args.max_restarts}", flush=True)
            time.sleep(1.0)
    raise subprocess.CalledProcessError(returncode=proc.returncode, cmd=cmd)


def multi_process_launcher(args) -> int:
    """This machine's processes with a shared rendezvous, under ``ElasticSupervisor``:
    a worker's death tears the gang down and relaunches all of it on a fresh port, up to
    ``--max-restarts`` times."""
    from ..elastic import ElasticSupervisor, WorkerFailure

    num = int(args.num_processes or 1)
    machines = int(args.num_machines or 1)
    local = num // machines
    ip = args.main_process_ip or "127.0.0.1"
    cmd, _ = prepare_simple_launcher_cmd_env(args)

    def make_plan(coordinator: str):
        if machines > 1:  # every machine must meet at the same port
            coordinator = f"{ip}:{args.main_process_port or 29500}"
        return [(cmd, prepare_multi_process_env(args, process_id=i, num_processes=num,
                                                coordinator_address=coordinator))
                for i in range(local)]

    if args.dry_run:
        _print_plan([(c, _shown(e)) for c, e in make_plan(
            f"{ip}:{args.main_process_port or 29500}")])
        if machines > 1:
            flags = " ".join(shlex.quote(f) for f in _forwarded_flags(args))
            for rank in range(machines):
                print(f"--- machine {rank} runs ---\n  {sys.executable} -m accelerate_tpu_torch "
                      f"launch {flags} --multi-process --num-processes {num} --num-machines "
                      f"{machines} --machine-rank {rank} --main-process-ip {ip} "
                      f"{shlex.quote(args.training_script)}")
        return 0
    supervisor = ElasticSupervisor(make_plan, max_restarts=args.max_restarts,
                                   coordinator_host=ip, coordinator_port=args.main_process_port)
    try:
        return supervisor.run()
    except WorkerFailure as e:
        raise subprocess.CalledProcessError(returncode=_first_failure(e.exit_codes),
                                            cmd=cmd) from e


# (arg attribute, flag, takes a value): every flag the launch on another machine must be
# given to serialise the same environment (``_common_env``) as this one.
_FORWARDED = [
    ("mixed_precision", "--mixed-precision", True),
    ("dp", "--dp", True), ("fsdp", "--fsdp", True), ("tp", "--tp", True),
    ("sp", "--sp", True), ("pp", "--pp", True), ("ep", "--ep", True),
    ("gradient_accumulation_steps", "--gradient-accumulation-steps", True),
    ("use_fsdp", "--use-fsdp", False),
    ("fsdp_zero_stage", "--fsdp-zero-stage", True),
    ("fsdp_cpu_offload", "--fsdp-cpu-offload", False),
    ("fsdp_state_dict_type", "--fsdp-state-dict-type", True),
    ("fsdp_min_weight_size", "--fsdp-min-weight-size", True),
    ("sp_mode", "--sp-mode", True),
    ("pp_num_microbatches", "--pp-num-microbatches", True),
    ("pp_schedule", "--pp-schedule", True),
    ("pp_virtual_stages", "--pp-virtual-stages", True),
    ("fp8_format", "--fp8-format", True),
    ("fp8_margin", "--fp8-margin", True),
    ("fp8_amax_history_len", "--fp8-amax-history-len", True),
    ("fp8_use_delayed_scaling", "--fp8-use-delayed-scaling", False),
    ("fp8_opt_level", "--fp8-opt-level", True),
    ("project_dir", "--project-dir", True),
    ("checkpoint_total_limit", "--checkpoint-total-limit", True),
    ("log_with", "--log-with", True),
    ("dispatch_batches", "--dispatch-batches", False),
    ("debug", "--debug", False),
    ("cpu", "--cpu", False),
]


def _forwarded_flags(args) -> list[str]:
    flags: list[str] = []
    for attr, flag, has_value in _FORWARDED:
        v = getattr(args, attr, None)
        if v is None or v is False:
            continue
        flags.append(flag)
        if has_value:
            flags.append(str(v))
    # store_false flags: only forward when the user turned the default off.
    if getattr(args, "even_batches", None) is False:
        flags.append("--no-even-batches")
    if getattr(args, "use_seedable_sampler", None) is False:
        flags.append("--no-seedable-sampler")
    return flags


def _first_failure(codes: list[int]) -> int:
    """First nonzero exit code — max() would report 0 when a child died from a signal (<0)."""
    return next((c for c in codes if c != 0), 1)


def _first_failure(codes: list) -> int:
    """The first non-zero exit code (a signal's death is negative, which max() would
    miss)."""
    return next((c for c in codes if c != 0), 1)


def _print_plan(plans) -> None:
    for i, (cmd, env) in enumerate(plans):
        print(f"--- process {i} ---")
        for k in sorted(env or {}):
            print(f"  {k}={env[k]}")
        print("  " + " ".join(map(str, cmd)))


def launch_command(args) -> int:
    _apply_config_defaults(args)
    if args.tpu_pod or args.tpu_name or args.tpu_zone:
        raise ValueError(
            "--tpu-pod/--tpu-name/--tpu-zone fan a launch out over a TPU pod with gcloud "
            "tpu-vm ssh, which has no GPU counterpart: run launch on each machine with "
            "--num-machines, --machine-rank and --main-process-ip")
    if args.multi_process and int(args.num_processes or 1) > 1:
        return multi_process_launcher(args)
    return simple_launcher(args)


def main():
    parser = launch_command_parser()
    args = parser.parse_args()
    sys.exit(launch_command(args))


if __name__ == "__main__":
    main()
