"""``python -m accelerate_tpu_torch env``: the environment report for bug reports, the
port's counterpart of ``accelerate_tpu/commands/env.py``: Python, torch and its CUDA,
each visible card's name, the card's name and power limit as ``nvidia-smi`` gives them,
the ``ACCELERATE_*`` variables and the default config. (The JAX package's TPU probe,
``get_tpu_info``, has no counterpart.)"""

from __future__ import annotations

import argparse
import os
import platform
import shutil
import subprocess

__all__ = ["env_command", "env_command_parser", "nvidia_smi_summary"]


def env_command_parser(subparsers=None) -> argparse.ArgumentParser:
    description = "Print the accelerate_tpu_torch environment report (attach to bug reports)."
    if subparsers is not None:
        parser = subparsers.add_parser("env", description=description)
    else:
        parser = argparse.ArgumentParser("python -m accelerate_tpu_torch env",
                                         description=description)
    parser.add_argument("--config_file", "--config-file", default=None)
    if subparsers is not None:
        parser.set_defaults(func=env_command)
    return parser


def nvidia_smi_summary(timeout_s: float = 20.0) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``, or why not."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not found"
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"failed: {e}"
    return out.stdout.strip() if out.returncode == 0 else f"failed: {out.stderr.strip()}"


def env_command(args) -> dict:
    import torch

    import accelerate_tpu_torch

    cuda = torch.cuda.is_available()
    info = {
        "accelerate_tpu_torch version": accelerate_tpu_torch.__version__,
        "Platform": platform.platform(),
        "Python version": platform.python_version(),
        "torch version": torch.__version__,
        "torch CUDA version": torch.version.cuda or "none (a CPU build)",
        "CUDA available": cuda,
        "Device count": torch.cuda.device_count() if cuda else 0,
        "Devices": ", ".join(torch.cuda.get_device_name(i)
                             for i in range(torch.cuda.device_count())) if cuda else "cpu",
        "nvidia-smi (name, power limit)": nvidia_smi_summary(),
    }
    accelerate_env = {k: v for k, v in os.environ.items() if k.startswith("ACCELERATE_")}
    info["ACCELERATE_* env"] = accelerate_env or "not set"

    from .config import default_config_file, load_config_from_file

    path = args.config_file or default_config_file()
    info["Default config"] = (load_config_from_file(path).to_dict() if os.path.isfile(path)
                              else "not found")
    print("\nCopy-and-paste the text below into your bug report\n")
    for key, value in info.items():
        print(f"- `{key}`: {value}")
    return info
