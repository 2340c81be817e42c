"""Weight-only int8 / int4 / nf4 quantization: the int8 Hopper CUDA kernel and the plain
PyTorch versions.

Counterpart of ``accelerate_tpu/ops/quantization.py``. A weight is a param leaf, so
quantization is a leaf transform: :func:`quantize_weight` turns a 2-D ``[in, out]``
weight into a :class:`QuantizedWeight` (codes + scales), :func:`load_and_quantize_model`
does it to every eligible leaf of a params tree, and :func:`quant_matmul` is the
projection matmul over such a leaf.

Schemes (the JAX package's, bit for bit):

- ``int8``: per-output-column absmax; ``data`` int8 ``[in, out]``, ``scales`` fp32 ``[out]``.
- ``int4``: blockwise absmax linear codes, two nibbles per uint8 byte.
- ``nf4``: blockwise absmax with the NormalFloat-4 codebook.

The int8 matmul keeps the Pallas kernel's order of operations: ``y = (x_fp32 @ q_fp32)
* s`` — the products summed in fp32 over the whole of K, the column scale applied once
after the sum, the result rounded to ``out_dtype`` once. It never computes
``x @ dequant(w)``, which rounds the dequantized weight to x's dtype first; that is the
``use_kernel=False`` path and the int4/nf4 path, as in JAX.

- :func:`int8_matmul_reference` — the plain version of that order.
- :func:`int8_matmul` — the dispatcher: CPU tensors run the plain version; any other
  tensors go to :func:`int8_matmul_cuda`, which launches a hand-written kernel of
  ``csrc/int8_matmul.cu`` (built at first use, ``ops/_build.py``) on the current stream
  and counts the launch in ``int8_matmul.launches``, or raises. It never falls back.
  :func:`split_plan` picks the kernel by shape before the launch: bf16 x on the serving
  shapes takes the cluster kernel (one launch, K split inside a thread block cluster),
  other bf16 shapes the bounds-checked kernel (counted again in
  ``int8_matmul.launches_ragged``), fp32 x the CUDA-core kernel.
- The backward is the JAX custom VJP's: the weight dequantized to x's dtype, ``dx = g @
  wᵀ`` (a plain matmul outside any kernel); ``data`` gets no gradient, ``scales`` zeros.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional

import torch

from ..utils.tree import listify_int_dicts, named_parameters, tree_map, unflatten_to_nested_dict
from . import _build

__all__ = [
    "BnbQuantizationConfig",
    "QuantizedWeight",
    "quantize_weight",
    "dequantize_weight",
    "quant_matmul",
    "load_and_quantize_model",
    "dequantize_model",
    "NF4_CODEBOOK",
    "int8_matmul",
    "int8_matmul_cuda",
    "int8_matmul_reference",
    "split_plan",
    "Int8Plan",
    "MAX_CLUSTER",
]

# NormalFloat-4: quantiles of N(0,1) normalized to [-1, 1] (QLoRA's table, as in JAX).
NF4_CODEBOOK = torch.tensor(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
        0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
    ],
    dtype=torch.float32,
)


@functools.lru_cache(maxsize=None)
def _nf4_codebook(device: torch.device) -> torch.Tensor:
    """``NF4_CODEBOOK`` on ``device``, copied there once: a dequantize inside a CUDA
    graph capture (the serving engine's prefill programs) may not copy from the host.
    Callers never write to it."""
    return NF4_CODEBOOK.to(device)


@dataclasses.dataclass
class BnbQuantizationConfig:
    """Quantization knobs (the JAX ``BnbQuantizationConfig``, validated the same way)."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    bnb_4bit_quant_type: str = "int4"  # int4 | nf4
    block_size: int = 64               # int4/nf4 scaling-block length
    torch_dtype: Any = torch.bfloat16
    skip_modules: Optional[list[str]] = None
    keep_in_fp32_modules: Optional[list[str]] = None
    min_weight_size: int = 4096        # leaves smaller than this stay unquantized

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("load_in_8bit and load_in_4bit can't be both True")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("load_in_8bit and load_in_4bit can't be both False")
        if self.bnb_4bit_quant_type not in ("int4", "nf4"):
            raise ValueError(f"unsupported 4-bit quant type {self.bnb_4bit_quant_type!r}")

    @property
    def scheme(self) -> str:
        return "int8" if self.load_in_8bit else self.bnb_4bit_quant_type


@dataclasses.dataclass
class QuantizedWeight:
    """Packed codes + scales of one 2-D weight (a single leaf of the params tree).

    int8: ``data`` int8 ``[in, out]``, ``scales`` fp32 ``[out]``. int4/nf4: ``data``
    uint8 ``[in*out/2]`` (two nibbles per byte, row-major), ``scales`` fp32
    ``[n_blocks]``. ``shape``, ``scheme`` and ``block_size`` are metadata."""

    data: torch.Tensor
    scales: torch.Tensor
    shape: tuple
    scheme: str
    block_size: int

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        return int(self.data.numel() * self.data.element_size() + self.scales.numel() * 4)

    def to(self, device) -> "QuantizedWeight":
        """The same weight with its tensors on ``device`` (types unchanged)."""
        return dataclasses.replace(self, data=self.data.to(device),
                                   scales=self.scales.to(device))


def quantize_weight(w: torch.Tensor, scheme: str = "int8", block_size: int = 64) -> QuantizedWeight:
    """Quantize one 2-D weight on its own device. ``scheme``: int8 | int4 | nf4."""
    if w.dim() != 2:
        raise ValueError(f"weight-only quantization expects 2-D weights, got {tuple(w.shape)}")
    shape = tuple(w.shape)
    wf = w.float()
    if scheme == "int8":
        absmax = wf.abs().amax(dim=0)  # per output column
        # A tensor divisor: CUDA turns division by a Python scalar into a product with
        # its reciprocal, which may round the scale differently from JAX (and the CPU).
        scales = absmax.clamp_min(1e-8) / torch.full_like(absmax, 127.0)
        q = torch.clamp(torch.round(wf / scales), -127, 127).to(torch.int8)
        return QuantizedWeight(q, scales, shape, "int8", block_size)
    if scheme not in ("int4", "nf4"):
        raise ValueError(f"unknown scheme {scheme!r}")
    flat = wf.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block_size))
    blocks = flat.reshape(-1, block_size)
    absmax = blocks.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    normed = blocks / absmax  # [-1, 1]
    if scheme == "int4":
        codes = torch.clamp(torch.round(normed * 7.0) + 8, 0, 15).to(torch.uint8)
    else:
        cb = _nf4_codebook(w.device)
        codes = (normed[..., None] - cb).abs().argmin(dim=-1).to(torch.uint8)
    flat_codes = codes.reshape(-1)
    packed = flat_codes[0::2] | (flat_codes[1::2] << 4)
    return QuantizedWeight(packed, absmax[:, 0], shape, scheme, block_size)


def _unpack_codes(qw: QuantizedWeight) -> torch.Tensor:
    lo = qw.data & 0x0F
    hi = qw.data >> 4
    return torch.stack([lo, hi], dim=1).reshape(-1)


def dequantize_weight(qw: QuantizedWeight, dtype=torch.float32) -> torch.Tensor:
    """The dense ``qw.shape`` weight in ``dtype`` (values computed in fp32)."""
    if qw.scheme == "int8":
        return (qw.data.float() * qw.scales).to(dtype).reshape(qw.shape)
    codes = _unpack_codes(qw)
    if qw.scheme == "int4":
        centred = codes.float() - 8.0
        values = centred / torch.full_like(centred, 7.0)  # a tensor divisor, as above
    else:  # nf4
        values = _nf4_codebook(codes.device)[codes.long()]
    blocks = values.reshape(-1, qw.block_size) * qw.scales[:, None]
    n = math.prod(qw.shape)
    return blocks.reshape(-1)[:n].reshape(qw.shape).to(dtype)


# ----------------------------------------------------------------------- int8 matmul
def int8_matmul_reference(x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: ``((x_fp32 @ q_fp32) * s).to(out_dtype)`` for x ``[..., K]``,
    ``data`` int8 ``[K, N]`` and ``scales`` fp32 ``[N]``."""
    return ((x.float() @ data.float()) * scales).to(out_dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Block tiles of csrc/int8_matmul.cu. Both bf16 kernels: 128 weight columns × 64 K rows
# a step, with 8, 16, 32 or 64 tokens (cluster kernel) or 16, 32 or 64 rows (the
# bounds-checked one) a block; the fp32 kernel: 32 rows × 64 columns × 32 K rows.
_BF16_TILE = (128, 64)  # (weight columns, K rows)
_F32_TILE = (32, 64, 32)  # (rows, columns, K rows)
_MIN_K_TILES = 4  # K tiles an fp32 split covers at the least
#: Most blocks the cluster kernel takes in one cluster (past the portable 8: the kernel
#: launches with the non-portable attribute).
MAX_CLUSTER = 16
#: The cluster kernel's K split, as a sweep of it on an H100 found fastest for calls that
#: follow another kernel, as a decode step's do (PERF.md): as many K ranges as keep about
#: two blocks an SM (a block takes 77-98 KB of shared memory, so two fit), in clusters of
#: at most 7, so that the grid stays one wave (32 clusters of 8 did not). Where that
#: leaves the grid short of one block per SM (a weight of few column tiles, N = 1024),
#: the grid grows to one: first by halving the tokens a block down to 32 while the
#: clusters would pass the portable 8 blocks (at 64 tokens, 16 token tiles × 8 ranges
#: measured faster than 8 × 16), then by clusters of up to :data:`MAX_CLUSTER`.
_MOST_SPLITS = 7


class Int8Plan(NamedTuple):
    """One launch of the int8 matmul: ``route`` ``"cluster"`` (bf16 x on the TMA
    shapes: N % 16 == 0, K % 8 == 0, 16-byte aligned tensors), ``"ragged"`` (bf16 x,
    other shapes: the bounds-checked kernel) or ``"fp32"`` (fp32 x); ``bm`` tokens a
    block; ``splits`` K ranges (the cluster's blocks on the cluster route, whose partial
    sums merge inside the cluster; fp32 partials summed by a second kernel on the fp32
    route; 1 on the ragged route) of ``k_chunk`` rows each, in whole K tiles."""

    route: str
    bm: int
    splits: int
    k_chunk: int


@functools.lru_cache(maxsize=1024)
def split_plan(M: int, N: int, K: int, sms: int, bf16: bool = True,
               tma: bool = True) -> Int8Plan:
    """The launch plan, a pure function of the shape and the card's SM count. ``tma``:
    the tensors meet the cluster kernel's TMA rules (16-byte aligned; the shape's rules
    are checked here).

    - cluster: ``bm`` is the smallest of 8/16/32/64 tokens that holds M (64 past that);
      K is cut into as many ranges as keep the grid at about two blocks per SM, at most
      ``_MOST_SPLITS``, or, where that leaves fewer blocks than SMs, ``bm`` is halved
      down to 32 while one block per SM would take clusters past 8, and the ranges are
      as many as give one block per SM, at most ``MAX_CLUSTER``; each range a whole
      number of 64-row K tiles and none empty (N = 4096: 32 column tiles and 7 ranges;
      N = 14336: 112 and 2; N = 1024: 8 tiles and 16 ranges at M = 8, 16 tiles of 32
      tokens and 8 ranges at M = 64);
    - ragged: one block per 128 columns and ``bm`` rows, K unsplit;
    - fp32: K split until the grid holds about two blocks per SM, each split keeping at
      least ``_MIN_K_TILES`` tiles of K."""
    if not bf16:
        bm, bn, bk = _F32_TILE
        tiles = -(-M // bm) * -(-N // bn)
        k_tiles = -(-K // bk)
        want = max(1, -(-2 * sms // tiles))
        per = min(k_tiles, max(_MIN_K_TILES, -(-k_tiles // want)))
        return Int8Plan("fp32", bm, -(-k_tiles // per), per * bk)
    bn, bk = _BF16_TILE
    k_tiles = -(-K // bk)
    if not (tma and N % 16 == 0 and K % 8 == 0 and K > 0):
        return Int8Plan("ragged", 16 if M <= 16 else 32 if M <= 32 else 64, 1,
                        max(1, k_tiles) * bk)
    bm = 8 if M <= 8 else 16 if M <= 16 else 32 if M <= 32 else 64
    tiles = -(-M // bm) * -(-N // bn)
    splits = min(_MOST_SPLITS, k_tiles, max(1, 2 * sms // tiles))
    if tiles * splits < sms:
        while bm > 32 and -(-sms // tiles) > 8:
            bm //= 2
            tiles = -(-M // bm) * -(-N // bn)
        splits = min(MAX_CLUSTER, k_tiles, -(-sms // tiles))
    per = -(-k_tiles // splits)
    return Int8Plan("cluster", bm, -(-k_tiles // per), per * bk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, its entry points' argument types set (built at first use)."""
    lib = _build.load("int8_matmul")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul_launch.argtypes = [vp] * 5 + [ci] * 9 + [vp]
    lib.int8_matmul_launch.restype = ci
    lib.int8_matmul_max_active_clusters.argtypes = [ci, ci]
    lib.int8_matmul_max_active_clusters.restype = ci
    return lib


def _launcher():
    return _lib().int8_matmul_launch


@functools.lru_cache(maxsize=None)
def max_active_clusters(index: int, bm: int, splits: int) -> int:
    """Clusters of ``splits`` blocks of the cluster kernel that card ``index`` holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    with torch.cuda.device(index):
        return _lib().int8_matmul_max_active_clusters(bm, splits)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_matmul kernel: {msg}")


def int8_matmul_cuda(x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the CUDA kernel (:func:`int8_matmul`'s contract) on the route
    :func:`split_plan` picks. Raises ``ValueError`` for anything it does not take:
    tensors off CUDA (the CPU included), mixed devices, non-contiguous tensors, x not
    fp32/bf16, ``out_dtype`` not fp32/bf16, ``data`` not int8 ``[K, N]`` or ``scales``
    not fp32 ``[N]``; ``RuntimeError`` when the card cannot hold the plan's cluster or
    the launch fails."""
    dev = x.device
    _check(dev.type == "cuda", f"tensors must be on CUDA, got {dev}")
    _check(data.device == dev and scales.device == dev, "x, data and scales must share a device")
    _check(x.is_contiguous() and data.is_contiguous() and scales.is_contiguous(),
           "x, data and scales must be contiguous")
    _check(x.dtype in _DTYPE_CODE, f"x dtype {x.dtype} (fp32 or bf16)")
    _check(out_dtype in _DTYPE_CODE, f"out_dtype {out_dtype} (fp32 or bf16)")
    _check(data.dtype == torch.int8 and data.dim() == 2, "data must be int8 [K, N]")
    K, N = data.shape
    _check(scales.dtype == torch.float32 and tuple(scales.shape) == (N,),
           "scales must be fp32 [N]")
    _check(x.dim() >= 1 and x.shape[-1] == K, f"x [..., {K}] expected, got {tuple(x.shape)}")
    lead = x.shape[:-1]
    M = math.prod(lead)
    y = torch.empty((*lead, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return y
    bf16 = x.dtype == torch.bfloat16
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    x_ptr, q_ptr, s_ptr = x.data_ptr(), data.data_ptr(), scales.data_ptr()
    plan = split_plan(M, N, K, _sm_count(index), bf16, (x_ptr | q_ptr | s_ptr) % 16 == 0)
    if plan.route == "cluster" and max_active_clusters(index, plan.bm, plan.splits) < 1:
        raise RuntimeError(f"int8_matmul kernel: the card holds no cluster of {plan.splits} "
                           f"blocks ({plan.bm} tokens each)")
    ws = (torch.empty((plan.splits, M, N), dtype=torch.float32, device=dev)
          if plan.route == "fp32" and plan.splits > 1 else None)
    args = (x_ptr, q_ptr, s_ptr, y.data_ptr(), ws.data_ptr() if ws is not None else None,
            M, N, K, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], plan.bm, plan.splits,
            plan.k_chunk, int(plan.route == "cluster"))
    # The decode step is bound by host work: read the raw current stream, and switch
    # the current device only when it is not x's already.
    if torch.cuda.current_device() == index:
        err = _launcher()(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = _launcher()(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():  # a captured call launches nothing
        int8_matmul.launches += 1
        if plan.route == "ragged":
            int8_matmul.launches_ragged += 1
    return y


def int8_matmul(x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """``((x_fp32 @ q_fp32) * s).to(out_dtype)``: x ``[..., K]``, ``data`` int8 ``[K,
    N]``, ``scales`` fp32 ``[N]`` → ``[..., N]``. CPU tensors run
    :func:`int8_matmul_reference`; any other tensors go to :func:`int8_matmul_cuda`,
    which launches the kernel or raises."""
    if x.device.type == "cpu":
        if data.dim() != 2 or x.shape[-1] != data.shape[0]:
            raise ValueError(f"int8_matmul: x [..., K] against data [K, N], got "
                             f"{tuple(x.shape)} and {tuple(data.shape)}")
        return int8_matmul_reference(x, data, scales, out_dtype)
    return int8_matmul_cuda(x, data, scales, out_dtype)


#: Kernel launches since the count was last reset (one per call that launched a kernel,
#: any route; CPU calls, and calls captured into a CUDA graph, are not counted: a
#: graph's launches are its kernel nodes times its replays, ``utils/cuda_graph.py``).
#: ``launches_ragged`` counts the calls among them
#: that took the bounds-checked bf16 kernel (shapes outside the cluster kernel's rules).
int8_matmul.launches = 0
int8_matmul.launches_ragged = 0


class _Int8Matmul(torch.autograd.Function):
    """The kernel forward with the JAX custom VJP's backward (``_int8_mm_bwd``): the
    weight dequantized to x's dtype, ``dx = g @ wᵀ``; the quantized weight is frozen."""

    @staticmethod
    def forward(ctx, x, data, scales, out_dtype):
        ctx.save_for_backward(data, scales)
        ctx.x_dtype = x.dtype
        return int8_matmul(x, data, scales, out_dtype)

    @staticmethod
    def backward(ctx, g):
        data, scales = ctx.saved_tensors
        w = (data.float() * scales).to(ctx.x_dtype)
        dx = g.to(ctx.x_dtype) @ w.T
        d_scales = torch.zeros_like(scales) if ctx.needs_input_grad[2] else None
        return dx, None, d_scales, None


def quant_matmul(x: torch.Tensor, qw: QuantizedWeight, out_dtype=None,
                 use_kernel: bool = True) -> torch.Tensor:
    """``x @ qw`` → ``out_dtype`` (default x's dtype). int8 with ``use_kernel`` (and x of
    at least 2 dims) runs :func:`int8_matmul` — the kernel on the card — differentiable
    w.r.t. x; otherwise (int4, nf4, ``use_kernel=False``) the weight is dequantized to
    x's dtype and multiplied, as in JAX."""
    out_dtype = out_dtype or x.dtype
    if qw.scheme == "int8" and use_kernel and x.dim() >= 2:
        if torch.is_grad_enabled() and x.requires_grad:
            return _Int8Matmul.apply(x, qw.data, qw.scales, out_dtype)
        return int8_matmul(x, qw.data, qw.scales, out_dtype)
    w = dequantize_weight(qw, dtype=x.dtype)
    return (x @ w).to(out_dtype)


# ------------------------------------------------------------------- model transform
def load_and_quantize_model(params: Any, quantization_config: BnbQuantizationConfig) -> Any:
    """Quantize every eligible 2-D weight leaf of a params tree (on the leaf's device).

    Eligibility is the JAX package's: 2-D, at least ``min_weight_size`` elements, key
    path (``"layers/0/wq"``) not named by ``skip_modules`` / ``keep_in_fp32_modules``
    (the whole key, a leading prefix or a trailing suffix). Other leaves are kept as
    they are; the tree comes back with sorted dict keys, as in JAX."""
    cfg = quantization_config
    skip = set(cfg.skip_modules or []) | set(cfg.keep_in_fp32_modules or [])
    out = {}
    for name, leaf in named_parameters(params).items():
        eligible = (
            torch.is_tensor(leaf)
            and leaf.dim() == 2
            and leaf.numel() >= cfg.min_weight_size
            and not any(name == s or name.startswith(s + "/") or name.endswith("/" + s)
                        for s in skip)
        )
        out[name] = quantize_weight(leaf, cfg.scheme, cfg.block_size) if eligible else leaf
    return listify_int_dicts(unflatten_to_nested_dict(out))


def dequantize_model(params: Any, dtype=torch.float32) -> Any:
    """Inverse transform: :class:`QuantizedWeight` leaves → dense tensors in ``dtype``."""
    return tree_map(lambda leaf: dequantize_weight(leaf, dtype)
                    if isinstance(leaf, QuantizedWeight) else leaf, params)
