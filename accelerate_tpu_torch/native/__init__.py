"""Host-side C++ helpers of the data path, built with ``g++`` at first use and loaded
through ``ctypes``: the port's counterpart of ``accelerate_tpu/native/__init__.py``.

    g++ -O3 -shared -fPIC -pthread <name>.cpp -o build/native/lib<name>-<hash>.so

The library lands in ``build/native/`` at the repository root (listed in
``.gitignore``), never beside its source; its name carries a hash of the source and
flags, so an edited source is rebuilt and an unchanged one reused. The build writes a
per-process temporary file and renames it, so processes building at once never load a
half-written library. Callers keep their own plain (numpy) path for hosts without a
toolchain: ``load_native`` returns None when the build or the load fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Optional

__all__ = ["NATIVE_DIR", "BUILD_DIR", "GXX_FLAGS", "load_native"]

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


def _lib_path(name: str) -> Path:
    src = (NATIVE_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_native(name: str, configure: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """``native/<name>.cpp`` built (when no library of its hash exists) and loaded, its
    functions typed by ``configure``; None when ``g++`` or the load fails."""
    so = _lib_path(name)
    try:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *GXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp"), "-o",
                                str(tmp)], check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(so))
        configure(lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        return None
