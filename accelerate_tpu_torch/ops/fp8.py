"""fp8 training ops: per-tensor scaled fp8 products with current and delayed scaling.

Counterpart of ``accelerate_tpu/ops/fp8.py``, name for name. Models call
:func:`fp8_dot` (a ``torch.autograd.Function``) in place of ``@``
(``LlamaConfig.use_fp8``): the forward quantizes both operands to e4m3, the backward
quantizes the output's cotangent to e5m2 (the HYBRID recipe) or e4m3 (E4M3), and every
product takes fp8 operands with fp32 accumulation, rescaled by the operands' scales.

- **Scales.** :func:`compute_scale` is TransformerEngine's: the largest power of two
  with ``amax * scale <= fp8_max / 2**margin``. Current scaling takes each tensor's own
  amax; delayed scaling (:class:`DelayedScalingState`, :func:`delayed_scales`) derives
  the scales from a rolling amax history updated once a step. A NaN scale means
  "current scaling" (``torch.where``, never a host read): every scale stays on the
  device, so an fp8 forward can be captured into a CUDA graph.
- **Casts.** :func:`quantize` clips, then casts with torch's fp8 conversion, which
  rounds as ``ml_dtypes`` does: the codes are JAX's bit for bit.
- **Residuals.** The forward keeps the fp8 codes and the scales for the backward
  (never the wide operands), as the JAX custom VJP's residuals do.
- **The product.** JAX leaves it to XLA's fp8 ``dot_general`` (no Pallas kernel). Here
  :func:`scaled_product` takes, on the card, ``torch._scaled_mm`` (cuBLASLt's fp8 GEMM)
  for the forward and both backward products: its first operand row-major, its second
  column-major, every dimension padded to a multiple of 16 with zero codes (after the
  amax), and the scales passed as their reciprocals (``_scaled_mm`` multiplies by
  dequantization factors; the reciprocal of a power of two is exact). On the CPU it
  runs :func:`scaled_product_reference`, the plain version: the codes widened to fp32,
  multiplied, divided by the product of the scales, as XLA computes it.
- **Tensor parallelism.** Under GSPMD, JAX's ``jnp.max(jnp.abs(w))`` of a sharded
  operand is the global amax. Here every amax is taken over ``group`` (an all-reduce
  MAX over the tp ranks) when one is given: a weight's shard, a row-parallel input,
  a column-parallel output's cotangent.
- **Delayed scaling under remat.** :func:`autoscale_ctx` routes its scales to every
  :func:`fp8_dot` called while it is open and collects the forward amaxes. A block
  checkpointed with ``torch.utils.checkpoint`` runs its forward again in the backward,
  so the context must stay open across the backward as well (``Accelerator.
  build_train_step`` keeps it open around ``torch.autograd.grad``): the recomputed
  products then take the same scales, and their amaxes, equal to the first ones,
  leave the collected maxima unchanged.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch

from ..parallel.tp import all_reduce

__all__ = [
    "FP8_MAX",
    "Format",
    "set_default_recipe",
    "compute_scale",
    "quantize",
    "dequantize",
    "scaled_product",
    "scaled_product_reference",
    "fp8_dot",
    "fp8_linear",
    "DelayedScalingState",
    "delayed_scales",
    "autoscale_ctx",
]

#: Largest finite magnitude of each fp8 format.
FP8_MAX = {
    torch.float8_e4m3fn: 448.0,
    torch.float8_e5m2: 57344.0,
}

_ALIGN = 16  # _scaled_mm's rule for every dimension on sm_90


class Format:
    """Recipe formats."""

    E4M3 = "E4M3"      # e4m3 everywhere
    HYBRID = "HYBRID"  # e4m3 forward, e5m2 backward (the TransformerEngine default)


# Process-wide recipe defaults, set by Accelerator(mixed_precision="fp8", kwargs_handlers=
# [FP8RecipeKwargs(...)]) and read whenever a call site passes no format or margin.
_DEFAULT_RECIPE = {"fp8_format": Format.HYBRID, "margin": 0}


def set_default_recipe(fp8_format: Optional[str] = None, margin: Optional[int] = None) -> None:
    if fp8_format is not None:
        _DEFAULT_RECIPE["fp8_format"] = fp8_format.upper()
    if margin is not None:
        _DEFAULT_RECIPE["margin"] = int(margin)


def _resolve(fp8_format, margin):
    return (_DEFAULT_RECIPE["fp8_format"] if fp8_format is None else fp8_format,
            _DEFAULT_RECIPE["margin"] if margin is None else margin)


def _fmt_dtypes(fp8_format: str):
    if fp8_format == Format.E4M3:
        return torch.float8_e4m3fn, torch.float8_e4m3fn
    if fp8_format == Format.HYBRID:
        return torch.float8_e4m3fn, torch.float8_e5m2
    raise ValueError(f"unknown fp8 format {fp8_format!r}")


def compute_scale(amax: torch.Tensor, fp8_dtype, margin: int = 0) -> torch.Tensor:
    """Largest power of two with ``amax * scale <= fp8_max / 2**margin`` (fp32)."""
    amax = torch.clamp_min(torch.as_tensor(amax).float(), 1e-12)
    # A tensor numerator: a Python scalar over a tensor divides through the reciprocal.
    exp = torch.floor(torch.log2(torch.full_like(amax, FP8_MAX[fp8_dtype]) / amax)) - margin
    return torch.exp2(exp)


def quantize(x: torch.Tensor, scale: torch.Tensor, fp8_dtype) -> torch.Tensor:
    """Scale, then saturate-cast to fp8 (``scale`` multiplies x into range)."""
    fp8_max = FP8_MAX[fp8_dtype]
    return torch.clamp(x.float() * scale, -fp8_max, fp8_max).to(fp8_dtype)


def dequantize(x: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (x.float() / scale).to(dtype)


def _amax(t: torch.Tensor, group=None) -> torch.Tensor:
    """fp32 max |t| (one reduction pass, no copy), global over ``group``."""
    return _amaxes([t], group)[0]


def _amaxes(tensors, group=None) -> torch.Tensor:
    """fp32 ``[len(tensors)]`` of max |t|, global over ``group`` (one all-reduce)."""
    amax = torch.stack([torch.linalg.vector_norm(t.detach(), math.inf).float()
                        for t in tensors])
    return amax if group is None else all_reduce(amax, "max", group)


def _pick_scale(provided, amax, fp8_dtype, margin):
    """``provided`` where it is set, else the current scale of ``amax`` (NaN = unset)."""
    current = compute_scale(amax, fp8_dtype, margin)
    return torch.where(torch.isnan(provided), current, provided)


# -------------------------------------------------------------------------- the product
def scaled_product_reference(a_q, b_q, a_scale, b_scale, out_dtype) -> torch.Tensor:
    """Plain version: ``(a_q @ b_q) / (a_scale * b_scale)`` on fp32-widened codes."""
    y = a_q.float() @ b_q.float()
    return (y / (a_scale * b_scale)).to(out_dtype)


def _padded_rows(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` (fp8, 2-D, any strides) as a contiguous ``[rows, cols]`` tensor, zero codes
    past its edge. The copy goes through uint8 views: a byte copy of the codes."""
    if tuple(t.shape) == (rows, cols) and t.is_contiguous():
        return t
    out = torch.zeros((rows, cols), dtype=torch.uint8, device=t.device)
    out[: t.shape[0], : t.shape[1]].copy_(t.view(torch.uint8))
    return out.view(t.dtype)


def _scaled_mm_cuda(a_q, b_q, a_scale, b_scale, out_dtype) -> torch.Tensor:
    if a_q.device.type != "cuda" or b_q.device != a_q.device:
        raise ValueError(f"scaled_product: operands on {a_q.device} and {b_q.device}")
    if torch.float8_e5m2 == a_q.dtype == b_q.dtype:
        raise ValueError("scaled_product: e5m2 x e5m2 has no fp8 GEMM on sm_90")
    if out_dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"scaled_product: out_dtype {out_dtype}")
    (M, K), N = a_q.shape, b_q.shape[1]
    pad = lambda n: -(-n // _ALIGN) * _ALIGN  # noqa: E731
    Mp, Kp, Np = pad(M), pad(K), pad(N)
    a = _padded_rows(a_q, Mp, Kp)                 # row-major [Mp, Kp]
    b = _padded_rows(b_q.t(), Np, Kp).t()         # column-major [Kp, Np]
    out = torch._scaled_mm(a, b, scale_a=torch.reciprocal(a_scale).reshape(()),
                           scale_b=torch.reciprocal(b_scale).reshape(()), out_dtype=out_dtype)
    if isinstance(out, tuple):  # older releases also return the output's amax
        out = out[0]
    if not torch.cuda.is_current_stream_capturing():
        scaled_product.launches += 1
    return out if (Mp, Np) == (M, N) else out[:M, :N]


def scaled_product(a_q, b_q, a_scale, b_scale, out_dtype) -> torch.Tensor:
    """``(a_q @ b_q) / (a_scale * b_scale)`` for fp8 codes ``a_q [M, K]``, ``b_q [K, N]``
    (any strides) and fp32 0-d scales, in ``out_dtype``: ``torch._scaled_mm`` on the
    card (counted in ``scaled_product.launches``), :func:`scaled_product_reference` for
    CPU tensors."""
    if a_q.device.type == "cpu":
        return scaled_product_reference(a_q, b_q, a_scale, b_scale, out_dtype)
    return _scaled_mm_cuda(a_q, b_q, a_scale, b_scale, out_dtype)


#: ``_scaled_mm`` calls since the count was last reset (CPU calls are not counted).
scaled_product.launches = 0


class _Fp8Dot(torch.autograd.Function):
    """``x @ w`` on fp8 codes; ``scales`` = fp32 ``[3]`` (x, w, grad), NaN = current;
    ``amax`` = fp32 ``[2]``, the operands' amaxes (taken once, by :func:`fp8_dot`)."""

    @staticmethod
    def forward(ctx, x, w, scales, amax, fp8_format, margin, group):
        fwd_dtype, _ = _fmt_dtypes(fp8_format)
        x_scale = _pick_scale(scales[0], amax[0], fwd_dtype, margin)
        w_scale = _pick_scale(scales[1], amax[1], fwd_dtype, margin)
        x_q = quantize(x, x_scale, fwd_dtype)
        w_q = quantize(w, w_scale, fwd_dtype)
        y = scaled_product(x_q.reshape(-1, x.shape[-1]), w_q, x_scale, w_scale, x.dtype)
        ctx.save_for_backward(x_q, w_q, x_scale, w_scale, scales[2])
        ctx.fp8_format, ctx.margin, ctx.group = fp8_format, margin, group
        ctx.dtypes = (x.dtype, w.dtype)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        _, bwd_dtype = _fmt_dtypes(ctx.fp8_format)
        x_q, w_q, x_scale, w_scale, g_scale_in = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        g_scale = _pick_scale(g_scale_in, _amax(g, ctx.group), bwd_dtype, ctx.margin)
        g_q = quantize(g, g_scale, bwd_dtype).reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:  # dx = g @ w.T
            dx = scaled_product(g_q, w_q.t(), g_scale, w_scale, x_dtype).reshape(
                *x_q.shape[:-1], w_q.shape[0])
        if ctx.needs_input_grad[1]:  # dw = x.T @ g over every batch dim
            dw = scaled_product(x_q.reshape(-1, x_q.shape[-1]).t(), g_q, x_scale, g_scale,
                                w_dtype)
        return dx, dw, None, None, None, None, None


# ------------------------------------------------------------------------ delayed scaling
# The open delayed-scaling context: {"scales": fp32 [3], "amax": fp32 [2]}.
_AUTOSCALE: dict = {"scales": None, "amax": None}


@contextlib.contextmanager
def autoscale_ctx(scales: torch.Tensor):
    """Route ``scales`` to every :func:`fp8_dot` in the block that passes none, and
    collect the forward amaxes (x, w; elementwise max over the call sites) in
    ``ctx["amax"]``. Keep it open across the backward of a checkpointed forward (see
    the module docstring)."""
    prev = dict(_AUTOSCALE)
    _AUTOSCALE["scales"] = scales
    _AUTOSCALE["amax"] = torch.zeros((2,), dtype=torch.float32, device=scales.device)
    try:
        yield _AUTOSCALE
    finally:
        _AUTOSCALE["scales"] = prev["scales"]
        _AUTOSCALE["amax"] = prev["amax"]


def fp8_dot(x: torch.Tensor, w: torch.Tensor, fp8_format: Optional[str] = None,
            margin: Optional[int] = None, scales: Optional[torch.Tensor] = None,
            group=None) -> torch.Tensor:
    """``x @ w`` (``x [..., K]``, ``w [K, N]``) with fp8-quantized operands, in x's
    dtype. ``fp8_format``/``margin`` default to the process recipe
    (:func:`set_default_recipe`). ``scales``: optional fp32 ``[3]`` ``(x, w, grad)``
    from :func:`delayed_scales`; None takes the open :func:`autoscale_ctx`'s scales,
    else current scaling. ``group``: the process group over which each amax is taken
    (a tp group when the operands are shards)."""
    fp8_format, margin = _resolve(fp8_format, margin)
    # One amax pass per operand: it feeds the current scale and the context's maxima.
    amax = _amaxes([x, w], group)
    if scales is None and _AUTOSCALE["scales"] is not None:
        scales = _AUTOSCALE["scales"]
        _AUTOSCALE["amax"] = torch.maximum(_AUTOSCALE["amax"], amax)
    if scales is None:
        scales = torch.full((3,), math.nan, dtype=torch.float32, device=x.device)
    return _Fp8Dot.apply(x, w, scales, amax, fp8_format, margin, group)


def fp8_linear(x, w, b=None, fp8_format: Optional[str] = None, margin: Optional[int] = None,
               scales=None, group=None):
    """A linear layer on :func:`fp8_dot`."""
    y = fp8_dot(x, w, fp8_format, margin, scales, group)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class DelayedScalingState(NamedTuple):
    """Rolling amax history per quantized role, carried in ``TrainState.fp8_state``:
    ``history`` fp32 ``[3, amax_history_len]`` (rows x, w, grad), ``step`` int32 0-d.
    Both stay on the device; :meth:`update` returns a new state."""

    history: torch.Tensor
    step: torch.Tensor

    @classmethod
    def init(cls, amax_history_len: int = 16, device=None) -> "DelayedScalingState":
        return cls(history=torch.zeros((3, amax_history_len), dtype=torch.float32,
                                       device=device),
                   step=torch.zeros((), dtype=torch.int32, device=device))

    def update(self, x_amax, w_amax, g_amax) -> "DelayedScalingState":
        dev, n = self.history.device, self.history.shape[1]
        vals = torch.stack([torch.as_tensor(a, dtype=torch.float32, device=dev).reshape(())
                            for a in (x_amax, w_amax, g_amax)])
        column = torch.arange(n, device=dev) == torch.remainder(self.step, n)
        history = torch.where(column[None, :], vals[:, None], self.history)
        return DelayedScalingState(history=history, step=self.step + 1)


def delayed_scales(state: DelayedScalingState, fp8_format: str = Format.HYBRID,
                   margin: int = 0, amax_compute_algo: str = "max") -> torch.Tensor:
    """fp32 ``[3]`` scales (x, w, grad) from the history (``amax_compute_algo``: max |
    most_recent); a role whose amax is still 0 comes out NaN (current scaling)."""
    fwd_dtype, bwd_dtype = _fmt_dtypes(fp8_format)
    if amax_compute_algo == "max":
        amaxes = state.history.amax(dim=1)
    elif amax_compute_algo == "most_recent":
        idx = torch.remainder(state.step - 1, state.history.shape[1]).reshape(1).long()
        amaxes = state.history.index_select(1, idx)[:, 0]
    else:
        raise ValueError(f"unknown amax_compute_algo {amax_compute_algo!r}")
    scales = torch.stack([compute_scale(amaxes[0], fwd_dtype, margin),
                          compute_scale(amaxes[1], fwd_dtype, margin),
                          compute_scale(amaxes[2], bwd_dtype, margin)])
    return torch.where(amaxes > 0, scales, torch.full_like(scales, math.nan))
