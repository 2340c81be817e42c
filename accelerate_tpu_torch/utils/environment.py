"""Environment-variable parsing and manipulation: the port's copy of
``accelerate_tpu/utils/environment.py``.

The ``ACCELERATE_*`` variables are the wire protocol between the launcher CLI
(``commands/launch.py``, ``utils/launch.py``) and the library (``state``,
``accelerator``, ``utils/dataclasses``); these helpers are the one place it is parsed.

Not ported: ``get_tpu_info`` and ``_gce_metadata``, which read a TPU VM's devices and
the GCE metadata server and have no counterpart on a GPU host (``commands/env.py``
reports the card through ``torch.cuda`` and ``nvidia-smi`` instead).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from contextlib import contextmanager
from typing import Any

__all__ = [
    "str_to_bool", "get_int_from_env", "parse_flag_from_env", "parse_choice_from_env",
    "clear_environment", "patch_environment",
    "purge_accelerate_environment", "subprocess_probe",
]

_TRUE = {"1", "true", "yes", "y", "on"}
_FALSE = {"0", "false", "no", "n", "off", ""}


def str_to_bool(value: str) -> int:
    """A string as 1 or 0; raises ``ValueError`` on any other value."""
    value = str(value).lower().strip()
    if value in _TRUE:
        return 1
    if value in _FALSE:
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def get_int_from_env(env_keys, default: int) -> int:
    """The first non-negative integer among the variables ``env_keys``, else ``default``."""
    for key in env_keys:
        val = int(os.environ.get(key, -1))
        if val >= 0:
            return val
    return default


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    """The variable ``key`` as a boolean flag (``default`` when unset or unrecognised)."""
    value = os.environ.get(key, str(default))
    try:
        return bool(str_to_bool(value))
    except ValueError:
        return default


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, str(default))


@contextmanager
def clear_environment():
    """Run the block with an empty ``os.environ``; restored afterwards."""
    saved = dict(os.environ)
    os.environ.clear()
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


@contextmanager
def patch_environment(**kwargs: Any):
    """Set variables (keys upper-cased) for the block; the prior values come back after."""
    saved: dict[str, str | None] = {}
    for key, value in kwargs.items():
        key = key.upper()
        saved[key] = os.environ.get(key)
        os.environ[key] = str(value)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def purge_accelerate_environment(func):
    """Decorator: run ``func`` with every ``ACCELERATE_*`` variable removed, then restore
    them."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        saved = {k: v for k, v in os.environ.items() if k.startswith("ACCELERATE_")}
        for k in saved:
            del os.environ[k]
        try:
            return func(*args, **kwargs)
        finally:
            for k, v in saved.items():
                os.environ[k] = v

    return wrapper


def subprocess_probe(code: str, timeout_s: float, sentinel: str = "ALIVE") -> bool:
    """Run ``code`` in a fresh interpreter: True iff it prints ``sentinel`` within the
    timeout. A probe that may block (a device's initialisation) cannot wedge the caller."""
    try:
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=timeout_s)
        return sentinel in out.stdout
    except Exception:
        return False
