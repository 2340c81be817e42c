"""Capture and replay of one step function as a CUDA graph.

The port's counterpart of compiling a ``lax.scan`` with ``jax.jit``: the serving
engine's ``decode_steps=N`` super-step and ``generation.generate_loop``'s decode step
are plain functions of tensors that run eagerly on the CPU; on CUDA,
:class:`CapturedStep` runs such a function once eagerly (so every kernel is built by
``ops/_build.py``, every plan is cached and cuBLAS has its handle and workspace on the
capture stream), captures it into a CUDA graph with a private memory pool (or a pool
shared with other graphs, ``torch.cuda.graph_pool_handle()``), and replays the graph on
every later call, with no host synchronisation between replays.

The function reads and writes static tensors it closes over (the caller fills the
inputs before each call); its return value is the graph's static output, overwritten by
each replay. A failed capture or replay raises: nothing falls back to eager execution.

Kernel wrappers count a launch only where they launch (not while a stream is being
captured); :attr:`CapturedStep.kernel_nodes` counts the graph's kernel nodes by kernel
name (read through the CUDA driver API), and :attr:`CapturedStep.replays` how often
they ran, so ``nodes × replays`` is the launches of the replayed path. Each capture
counts as one compile of ``telemetry.compile_monitor`` (kind ``graph_capture``, its
seconds ``capture_s``), attributed to the active ``compile_label``.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import time
from typing import Callable

import torch

from ..telemetry.compile_monitor import dispatch_compile

__all__ = ["CapturedStep", "graph_kernel_nodes"]


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of the CUDA driver API."""

    _fields_ = [("func", ctypes.c_void_p), ("gridDimX", ctypes.c_uint),
                ("gridDimY", ctypes.c_uint), ("gridDimZ", ctypes.c_uint),
                ("blockDimX", ctypes.c_uint), ("blockDimY", ctypes.c_uint),
                ("blockDimZ", ctypes.c_uint), ("sharedMemBytes", ctypes.c_uint),
                ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=1)
def _driver() -> ctypes.CDLL:
    cuda = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p
    cuda.cuGraphGetNodes.argtypes = [vp, vp, ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphKernelNodeGetParams_v2.argtypes = [vp, ctypes.POINTER(_KernelNodeParams)]
    cuda.cuKernelGetFunction.argtypes = [ctypes.POINTER(vp), vp]
    cuda.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
    for fn in (cuda.cuGraphGetNodes, cuda.cuGraphNodeGetType, cuda.cuKernelGetFunction,
               cuda.cuGraphKernelNodeGetParams_v2, cuda.cuFuncGetName):
        fn.restype = ctypes.c_int  # CUresult
    return cuda


def _ok(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA driver error {err}")


def graph_kernel_nodes(graph: torch.cuda.CUDAGraph) -> dict:
    """The kernel nodes of a captured graph (``keep_graph=True``), counted by kernel
    name (mangled, as the driver gives it) through the CUDA driver API."""
    cuda = _driver()
    handle, n = graph.raw_cuda_graph(), ctypes.c_size_t(0)
    _ok(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:
        _ok(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts: dict = {}
    kind = ctypes.c_int()
    for node in nodes:
        _ok(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        _ok(cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
            "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p(params.func)
        if not params.func and params.kern:
            _ok(cuda.cuKernelGetFunction(ctypes.byref(func), params.kern),
                "cuKernelGetFunction")
        name = ctypes.c_char_p()
        _ok(cuda.cuFuncGetName(ctypes.byref(name), func), "cuFuncGetName")
        key = name.value.decode()
        counts[key] = counts.get(key, 0) + 1
    return counts


class CapturedStep:
    """``fn()`` run eagerly on its first call, captured then, and replayed from the
    CUDA graph on every later call. The graph holds the addresses of ``fn``'s tensors,
    not the tensors: ``fn`` is dropped after the capture, so the caller keeps alive
    (and in place) what a replay reads and writes.

    After the first call: ``kernel_nodes`` (kernel name → nodes in the graph),
    ``capture_s`` (host seconds of the capture and instantiation), ``pool_bytes`` (the
    device memory the caching allocator reserved during the capture: the graph's
    private pool, or what it added to a shared one) and ``replays``.

    ``pool`` (a ``torch.cuda.graph_pool_handle()``) shares one memory pool among the
    graphs captured with it: a graph may then take memory that another graph's
    temporaries used, so the caller replays them one at a time and consumes each
    replay's outputs before another graph of the pool replays."""

    def __init__(self, fn: Callable, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self.out = None
        self.replays = 0
        self.kernel_nodes: dict = {}
        self.capture_s = None
        self.pool_bytes = None

    def nodes(self, stem: str = "") -> int:
        """Kernel nodes of the graph whose kernel name contains ``stem``."""
        return sum(n for k, n in self.kernel_nodes.items() if stem in k)

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            return self.out
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                eager = self.fn()
            # capture_begin/end rather than torch.cuda.graph, which empties the
            # allocator's cache first: the eager calls around the graph keep their
            # cached blocks. A pool takes new segments, so the reserved bytes grow by
            # what the capture added to it.
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            # No cyclic garbage collection inside the capture: collecting an unreachable
            # cycle that holds another CUDA graph frees that graph's memory pool, a
            # cudaFree that invalidates the capture (torch.cuda.graph collects first).
            gc_was_enabled = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                    try:
                        self.out = self.fn()
                    except BaseException:
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            pass  # the capture was invalidated; the first error is the one
                        raise
                    graph.capture_end()
            finally:
                if gc_was_enabled:
                    gc.enable()
            self.kernel_nodes = graph_kernel_nodes(graph)
            graph.instantiate()
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            cur.wait_stream(side)
        dispatch_compile("graph_capture", self.capture_s)
        self.graph = graph
        self.fn = None  # the graph holds the addresses; fn's references are not needed
        return eager
