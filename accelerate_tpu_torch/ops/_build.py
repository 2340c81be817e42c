"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by ``nvcc`` into
a shared library under ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), then loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The library name carries a hash of the source, of the ``csrc/`` headers it includes and
of the flags, so an edited source or header is rebuilt and an unchanged one is reused.
Sources are built at first use — never when a module is imported — so CPU-only hosts
(no ``nvcc``) can import every module. A build failure raises; nothing falls back to a
plain version. Each source built counts as one compile of ``telemetry.compile_monitor``
(kind ``kernel_build``, its seconds the build's wall time), attributed to the active
``compile_label``; a library found built counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["BUILD_DIR", "CSRC_DIR", "KERNEL_SOURCES", "build", "finish", "load", "start"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
#: Every CUDA source of the port, as ``build`` names them.
KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_adamw", "fused_xent",
                  "int8_matmul")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Flags of one source only. fused_adamw keeps every multiply and add rounded on its own
# (no fused multiply-add), so its fp32 trajectory is the plain version's, bit for bit.
SOURCE_FLAGS = {"fused_adamw": ("--fmad=false",)}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
            "the port's CUDA kernels are built from source at first use"
        )
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    """The library's path: its name carries a hash of the source, of the ``csrc/``
    headers it includes (``#include "..."``) and of the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = re.findall(rb'^\s*#include\s+"([^"]+)"', src, re.M)
    parts = [src] + [(CSRC_DIR / h.decode()).read_bytes() for h in headers]
    digest = hashlib.sha256(b"".join(parts) + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def start(names: Sequence[str]) -> dict:
    """Start ``nvcc`` for every named source that is not built yet, all together; the
    handle :func:`finish` waits on."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name, lib in paths.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    return {"paths": paths, "procs": procs, "t0": t0}


def finish(started: dict, names: Optional[Sequence[str]] = None) -> dict:
    """Wait for the ``nvcc`` processes :func:`start` started (of ``names``; every one when
    None; the others can be waited for later) → ``{name: library path}`` of ``names``.
    The compiler's output (``-Xptxas -v``: registers, shared memory and spills per
    kernel) is kept beside each library as ``.log``. Raises ``RuntimeError`` naming the
    failed sources."""
    paths, procs = started["paths"], started["procs"]
    names = list(paths) if names is None else list(names)
    waited = [name for name in names if name in procs]
    failed = []
    for name in waited:
        proc, tmp = procs.pop(name)
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    if waited:
        from ..telemetry.compile_monitor import dispatch_compile

        elapsed = time.perf_counter() - started["t0"]
        for _ in waited:  # built together: each charged the wall time until it was waited for
            dispatch_compile("kernel_build", elapsed)
    return {name: paths[name] for name in names}


def build(names: Sequence[str]) -> dict:
    """Compile every named source that is not built yet, all ``nvcc`` processes
    started together (:func:`start`, then :func:`finish`) → ``{name: library path}``."""
    return finish(start(names))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    return ctypes.CDLL(str(build([name])[name]))
