"""Artifact provenance of the port, the counterpart of
``accelerate_tpu/telemetry/provenance.py``: which code, config and runtime produced a
number.

:func:`provenance_stamp` is the one stamp every serve-bench artifact and row carries:

- ``git_commit``: HEAD of the checkout the package runs from (None outside a checkout;
  ``-dirty`` when the tree differs);
- ``config_fingerprint``: a content hash of the model config and the runtime facts
  below, so two rows with one fingerprint came from one config on one stack;
- ``torch``, ``cuda`` and ``device``: where the JAX stamp names ``jax`` and
  ``backend``, the port names torch's version, ``torch.version.cuda`` and the card's
  name (``cpu`` when no card is present).

Workload-trace replays also stamp the trace's content hash
(``serving_gateway.workload.trace_hash``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Optional

__all__ = ["git_commit", "config_fingerprint", "provenance_stamp", "runtime_facts"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def git_commit(root: str = _REPO_ROOT) -> Optional[str]:
    """Short HEAD hash of the checkout at ``root`` (``-dirty`` suffixed when the
    working tree differs), or None when ``root`` is not a git repo or git is
    unavailable."""
    try:
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=root,
                              capture_output=True, text=True, timeout=10)
        if head.returncode != 0:
            return None
        commit = head.stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain"], cwd=root,
                               capture_output=True, text=True, timeout=10)
        if dirty.returncode == 0 and dirty.stdout.strip():
            commit += "-dirty"
        return commit or None
    except (OSError, subprocess.SubprocessError):
        return None


def runtime_facts() -> dict:
    """torch's version, its CUDA version and the device's name; empty where torch
    does not import (the stdlib readers of a run directory)."""
    try:
        import torch
    except ImportError:
        return {}
    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "device": device}


def config_fingerprint(cfg=None, extra: str = "") -> str:
    """Content hash of ``cfg``'s repr (a dataclass repr lists every field) together
    with :func:`runtime_facts` and ``extra``. Works with ``cfg=None``."""
    facts = sorted(runtime_facts().items())
    text = "\n".join([repr(cfg), repr(facts), extra])
    return hashlib.sha256(text.encode()).hexdigest()[:20]


def provenance_stamp(cfg=None) -> dict:
    """The provenance block serve-bench stamps into every artifact and row."""
    return {"git_commit": git_commit(), "config_fingerprint": config_fingerprint(cfg),
            **runtime_facts()}
