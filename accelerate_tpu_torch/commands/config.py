"""``python -m accelerate_tpu_torch config``: the launch configuration file, the port's
counterpart of ``accelerate_tpu/commands/config.py``.

``ClusterConfig`` has the JAX package's fields, so a config file of either package loads
in the other; ``launch`` reads it as its defaults (flags win) and serialises it into the
``ACCELERATE_*`` environment (``utils/launch.py``). ``config`` asks a short questionnaire
(``commands/menu.py``) over what the port runs; ``config default`` writes defaults;
``config update`` rewrites an old file with the current fields.

JSON is always read and written. YAML is read and written only where ``yaml`` (PyYAML)
imports; elsewhere a ``.yaml`` path raises and says to use ``.json``, and the default
file is ``default_config.json``. The default directory is
``~/.cache/accelerate_tpu_torch`` (``ACCELERATE_TPU_TORCH_CACHE`` overrides it).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

__all__ = ["ClusterConfig", "default_config_file", "load_config_from_file", "save_config",
           "write_basic_config", "config_command", "config_command_parser"]

cache_dir = os.environ.get(
    "ACCELERATE_TPU_TORCH_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "accelerate_tpu_torch"))
default_yaml_config_file = os.path.join(cache_dir, "default_config.yaml")
default_json_config_file = os.path.join(cache_dir, "default_config.json")


def _have_yaml() -> bool:
    return importlib.util.find_spec("yaml") is not None


def _yaml():
    if not _have_yaml():
        raise RuntimeError(
            "a .yaml config file needs PyYAML, which is not installed here: use a .json "
            "path (JSON is always available)")
    import yaml

    return yaml


def default_config_file() -> str:
    """The JSON default when it exists or when YAML is unavailable, else the YAML one."""
    if os.path.isfile(default_json_config_file) or not _have_yaml():
        return default_json_config_file
    return default_yaml_config_file


@dataclass
class ClusterConfig:
    """The whole launch configuration: the JAX package's fields. ``num_processes`` counts
    every machine's processes (one per card); ``-1`` on a mesh axis fills the rest."""

    compute_environment: str = "LOCAL_MACHINE"
    distributed_type: str = "NO"  # NO | MULTI_DEVICE | MULTI_HOST
    num_machines: int = 1
    num_processes: int = 1
    machine_rank: int = 0
    main_process_ip: Optional[str] = None
    main_process_port: Optional[int] = None
    mixed_precision: str = "no"  # no | bf16 | fp16 | fp8
    use_cpu: bool = False
    debug: bool = False
    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    fsdp_zero_stage: int = 0
    fsdp_cpu_offload: bool = False
    fsdp_min_weight_size: int = 1024
    fsdp_state_dict_type: str = "SHARDED_STATE_DICT"
    sp_mode: str = "ring"
    pp_num_microbatches: Optional[int] = None
    pp_schedule: Optional[str] = None
    pp_virtual_stages: Optional[int] = None
    fp8_format: str = "HYBRID"
    fp8_opt_level: str = "O1"
    fp8_margin: int = 0
    fp8_amax_history_len: int = 16
    fp8_use_delayed_scaling: bool = False
    gradient_accumulation_steps: int = 1
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    project_dir: Optional[str] = None
    checkpoint_total_limit: Optional[int] = None
    log_with: Optional[str] = None
    # The JAX package's TPU fields: kept so its files load; launch refuses them.
    num_virtual_devices: Optional[int] = None
    tpu_name: Optional[str] = None
    tpu_zone: Optional[str] = None

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        return {k: v for k, v in out.items() if v is not None}

    def save(self, path: Optional[str] = None) -> str:
        return save_config(self, path)


def save_config(config: ClusterConfig, path: Optional[str] = None) -> str:
    path = path or (default_yaml_config_file if _have_yaml() else default_json_config_file)
    data = config.to_dict()
    if str(path).endswith(".json"):
        text = json.dumps(data, indent=2) + "\n"
    else:
        text = _yaml().safe_dump(data, sort_keys=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Path(path).write_text(text)
    return str(path)


def write_basic_config(mixed_precision: str = "no", save_location: Optional[str] = None):
    """Write a one-machine config with one process per visible card (the CPU when there
    is none); returns the path, or False when a config already exists there."""
    import torch

    save_location = save_location or (default_yaml_config_file if _have_yaml()
                                      else default_json_config_file)
    if Path(save_location).exists():
        print(f"Configuration already exists at {save_location}, will not override. "
              "Run `python -m accelerate_tpu_torch config` or pass another `save_location`.")
        return False
    mixed_precision = mixed_precision.lower()
    if mixed_precision not in ("no", "fp16", "bf16", "fp8"):
        raise ValueError("`mixed_precision` should be one of 'no', 'fp16', 'bf16', or 'fp8'; "
                         f"got {mixed_precision}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    config = ClusterConfig(distributed_type="MULTI_DEVICE" if cards > 1 else "NO",
                           num_processes=max(cards, 1), mixed_precision=mixed_precision,
                           use_cpu=cards == 0)
    return save_config(config, str(save_location))


def load_config_from_file(path: Optional[str] = None) -> ClusterConfig:
    path = path or default_config_file()
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"No config file at {path}. Run `python -m accelerate_tpu_torch config` first or "
            "pass flags explicitly.")
    text = Path(path).read_text()
    data = json.loads(text) if str(path).endswith(".json") else _yaml().safe_load(text)
    known = {f.name for f in dataclasses.fields(ClusterConfig)}
    return ClusterConfig(**{k: v for k, v in (data or {}).items() if k in known})


def _interactive_config() -> ClusterConfig:
    """The questionnaire, over the knobs the port runs (one process per card, precision
    with the fp8 recipe, the ZeRO/FSDP stage with offload and checkpoint layout, the tp
    axis, accumulation, data loading, checkpoints)."""
    from .menu import ask, ask_bool, ask_int, select

    cfg = ClusterConfig()
    cfg.num_machines = ask_int("How many machines?", 1)
    if cfg.num_machines > 1:
        cfg.machine_rank = ask_int("Rank of this machine", 0)
        cfg.main_process_ip = ask("Rendezvous (rank-0 machine) IP", "127.0.0.1")
        cfg.main_process_port = ask_int("Rendezvous port", 29500)
        cfg.distributed_type = "MULTI_HOST"
    cfg.num_processes = ask_int("Total processes (one per card, over every machine)",
                                cfg.num_machines)
    if cfg.num_machines == 1 and cfg.num_processes > 1:
        cfg.distributed_type = "MULTI_DEVICE"
    cfg.use_cpu = ask_bool("Run on the CPU?", False)
    cfg.mixed_precision = select("Mixed precision?", ["bf16", "no", "fp16", "fp8"], default=0)
    if cfg.mixed_precision == "fp8":
        cfg.fp8_format = select("fp8 format?", ["HYBRID", "E4M3"])
        cfg.fp8_margin = ask_int("fp8 scale margin (powers of 2 backed off)", 0)
        cfg.fp8_use_delayed_scaling = ask_bool("Use delayed (history-based) scaling?", False)
        if cfg.fp8_use_delayed_scaling:
            cfg.fp8_amax_history_len = ask_int("fp8 amax history length", 16)
        cfg.fp8_opt_level = select(
            "MS-AMP opt level? (O2 = scaled-fp8 AdamW moments, needs fused_adamw)",
            ["O1", "O2"])
    stage = select("ZeRO/FSDP sharding stage?", [
        "0 — replicated params (plain data parallel)",
        "1 — shard optimizer state",
        "2 — + reduce-scatter gradients",
        "3 — + shard parameters (FSDP FULL_SHARD)",
    ])
    cfg.fsdp_zero_stage = int(stage.split(" ")[0])
    if cfg.fsdp_zero_stage > 0:
        cfg.fsdp = ask_int("fsdp axis size (-1 = all remaining devices)", -1)
        cfg.dp = 1
        cfg.fsdp_cpu_offload = ask_bool(
            "Offload optimizer state to host RAM (ZeRO-Offload)?", False)
        cfg.fsdp_min_weight_size = ask_int(
            "Min parameter size to shard (smaller stay replicated)", 1024)
        cfg.fsdp_state_dict_type = select(
            "Checkpoint layout?", ["SHARDED_STATE_DICT", "FULL_STATE_DICT"])
    cfg.tp = ask_int("Tensor-parallel degree", 1)
    cfg.gradient_accumulation_steps = ask_int("Gradient accumulation steps", 1)
    if ask_bool("Configure dataloader behavior?", False):
        cfg.dispatch_batches = ask_bool(
            "Dispatch batches from the main process (IterableDataset mode)?", False)
        cfg.even_batches = ask_bool("Pad uneven final batches (even_batches)?", True)
        cfg.use_seedable_sampler = ask_bool("Use the seedable sampler?", True)
    if ask_bool("Configure checkpointing defaults?", False):
        cfg.project_dir = ask("Project directory (checkpoints)", None) or None
        limit = ask_int("Max checkpoints to keep (0 = unlimited)", 0)
        cfg.checkpoint_total_limit = limit or None
    cfg.debug = ask_bool("Enable collective debug (shape verification)?", False)
    return cfg


def config_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Create the default config file of python -m accelerate_tpu_torch launch."
    if subparsers is not None:
        parser = subparsers.add_parser("config", description=description)
    else:
        parser = argparse.ArgumentParser("python -m accelerate_tpu_torch config",
                                         description=description)
    parser.add_argument("subcommand", nargs="?", choices=[None, "default", "update"], default=None)
    parser.add_argument("--config_file", "--config-file", default=None,
                        help="Where to write the JSON (or, with PyYAML, YAML) config.")
    if subparsers is not None:
        parser.set_defaults(func=config_command)
    return parser


def config_command(args) -> str:
    if args.subcommand == "default":
        cfg = ClusterConfig(mixed_precision="bf16")
    elif args.subcommand == "update":
        cfg = load_config_from_file(args.config_file)
    else:
        cfg = _interactive_config()
    path = save_config(cfg, args.config_file)
    print(f"accelerate_tpu_torch configuration saved at {path}")
    return path
