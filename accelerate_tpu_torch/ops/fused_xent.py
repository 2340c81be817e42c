"""Fused linear + cross-entropy, forward and backward: the Hopper CUDA kernels and their
plain PyTorch versions. The logits ``x @ w`` never reach device memory.

Counterpart of ``accelerate_tpu/ops/fused_xent.py``. x ``[T,D]`` and w ``[D,V]`` share a
type (fp32 or bf16); targets ``[T]`` are integer ids, and -1 (or any id outside
``[0, V)``) matches no column, so its nll is just the lse.

- :func:`_fwd` → ``(nll, lse)``, both fp32 ``[T]``; :func:`_bwd` → ``(dx, dw)`` in x's
  and w's types, from the forward's lse and the cotangent ``g [T]`` of nll. One kernel
  launch computes both gradients (``csrc/fused_xent.cu`` explains why).
- :func:`fused_xent_reference`, :func:`fused_xent_dx_reference` and
  :func:`fused_xent_dw_reference` are the plain versions: the same formulas over the
  whole ``[T,V]`` score matrix.
- Each raw entry point runs its plain version on CPU tensors. Any other tensors go to
  the hand-written kernels of ``csrc/fused_xent.cu`` (built at first use by
  ``ops/_build.py``), whose launches are counted in ``_fwd.launches`` and
  ``_bwd.launches``. A CUDA call never falls back: a refused device, type, shape or
  launch raises.
- :func:`fused_cross_entropy` is differentiable: a ``torch.autograd.Function`` that
  saves ``(x, w, targets, lse)`` and calls :func:`_bwd` in its backward.
- The vocab-sharded (tensor-parallel) variant: :func:`_fwd_partial` → ``(m, l, tgt)``,
  fp32 [T] each, of one rank's head slice ``[D, Vl]`` against shard-local targets (the
  row's max capped score, its sum of ``exp(score - m)`` at that max, and the target's
  score, 0 when the target lies outside ``[0, Vl)``); its plain version is
  :func:`fused_xent_partial_reference`, its launches ``_fwd_partial.launches``.
  :func:`fused_cross_entropy_tp` merges the ranks' partials in fp32 over the tp group
  (``lse = m_g + log l_g``) and runs :func:`_bwd` against the global lse in its
  backward: dw stays the rank's slice, dx is summed over the group (x is replicated
  over it, and its gradient is summed here and nowhere else).

Semantics kept from the Pallas kernels: scores are dots over D in the input type with
fp32 sums, capped as ``cap·tanh(s/cap)`` when ``softcap`` > 0; ``lse = m + log(l)`` and
``nll = lse - target score``; the backward recomputes the scores and takes
``d = (exp(capped - lse) - onehot)·g``, times ``1 - (capped/cap)²`` under the cap,
rounds d to w's type before ``d·wᵀ`` and to x's type before ``xᵀ·d``.

Layout: the kernels read x and w in place when their last dim is contiguous and their
rows are 16-byte aligned with a row length that is a multiple of 16 bytes (every
model's head); any other operand is copied once into a zero-padded buffer of that
layout. The tied head ``embed.T`` is such an operand: :func:`fused_cross_entropy` makes
it contiguous once in the forward and saves that copy for the backward.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.tp import all_reduce, group_rank_size
from . import _build

__all__ = [
    "fused_cross_entropy", "fused_cross_entropy_tp", "fused_xent_reference",
    "fused_xent_partial_reference", "fused_xent_dx_reference", "fused_xent_dw_reference",
    "_fwd", "_fwd_partial", "_bwd",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper


# --------------------------------------------------------------------------- plain math
def _scores(x, w, softcap):
    """fp32 scores ``x·w`` [T,V] (the dot over the input values with fp32 sums) and,
    under a cap, ``cap·tanh(s/cap)`` with its derivative ``1 - (capped/cap)²``
    (``None`` without a cap)."""
    s = x.float() @ w.float()
    if not softcap:
        return s, None
    capped = softcap * torch.tanh(s / softcap)
    return capped, 1.0 - (capped / softcap) ** 2


def _target_index(targets, V):
    """(clamped int64 ids, whether each id names a column)."""
    t = targets.long()
    return t.clamp(0, V - 1), (t >= 0) & (t < V)


def fused_xent_reference(x, w, targets, softcap=0.0):
    """Plain forward: ``(nll, lse)``, fp32 [T]."""
    s, _ = _scores(x, w, softcap)
    lse = torch.logsumexp(s, dim=-1)
    idx, hit = _target_index(targets, s.shape[1])
    tgt = torch.where(hit, s.gather(1, idx[:, None])[:, 0], 0.0)
    return lse - tgt, lse


def fused_xent_partial_reference(x, w_shard, t_local, softcap=0.0):
    """Plain partial forward of a vocab shard: ``(m, l, tgt)``, fp32 [T] — the max
    capped score of each row, the sum of ``exp(score - m)``, and the score of the
    shard-local target (0 when it lies outside ``[0, Vl)``)."""
    s, _ = _scores(x, w_shard, softcap)
    m = s.max(dim=-1).values
    l = torch.exp(s - m[:, None]).sum(dim=-1)
    idx, hit = _target_index(t_local, s.shape[1])
    tgt = torch.where(hit, s.gather(1, idx[:, None])[:, 0], 0.0)
    return m, l, tgt


def _dlogits(s, chain, lse, g, targets):
    """fp32 d [T,V] = ``(exp(s - lse) - onehot)·g``, times ``chain`` when given."""
    d = torch.exp(s - lse.float()[:, None])
    idx, hit = _target_index(targets, s.shape[1])
    d.scatter_add_(1, idx[:, None], -hit.float()[:, None])  # no host sync: graph-capturable
    d = d * g.float()[:, None]
    return d if chain is None else d * chain


def _dx_from(d, w, dtype):
    """``d·wᵀ`` with d rounded to w's type, written in ``dtype``."""
    return (d.to(w.dtype).float() @ w.float().T).to(dtype)


def _dw_from(d, x, dtype):
    """``xᵀ·d`` with d rounded to x's type, written in ``dtype``."""
    return (x.float().T @ d.to(x.dtype).float()).to(dtype)


def fused_xent_dx_reference(x, w, targets, lse, g, softcap=0.0):
    """Plain dx [T,D] in x's type from the recomputed d."""
    s, chain = _scores(x, w, softcap)
    return _dx_from(_dlogits(s, chain, lse, g, targets), w, x.dtype)


def fused_xent_dw_reference(x, w, targets, lse, g, softcap=0.0):
    """Plain dw [D,V] in w's type from the recomputed d."""
    s, chain = _scores(x, w, softcap)
    return _dw_from(_dlogits(s, chain, lse, g, targets), x, w.dtype)


# ------------------------------------------------------------------------ CUDA launches
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_xent")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
        lib.fxent_fwd_launch.argtypes = [vp] * 6 + [ci] * 3 + [cl, cl, cf, ci, vp]
        lib.fxent_bwd_launch.argtypes = [vp] * 9 + [ci] * 3 + [cl, cl, cf, ci, vp]
        lib.fxent_fwd_partial_launch.argtypes = [vp] * 7 + [ci] * 3 + [cl, cl, cf, ci, vp]
        lib.fxent_fwd_launch.restype = lib.fxent_bwd_launch.restype = ci
        lib.fxent_fwd_partial_launch.restype = ci
        lib.fxent_num_vtiles.argtypes = [ci]
        lib.fxent_smem_bytes.argtypes = [ci, ci]
        lib.fxent_num_vtiles.restype = lib.fxent_smem_bytes.restype = ci
        lib._argtypes_set = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_xent kernel: {msg}")


def _operand(a: torch.Tensor) -> torch.Tensor:
    """``a`` as the kernels read it: the tensor itself when its last dim is contiguous,
    its rows start on 16-byte boundaries and its row length is a multiple of 16 bytes;
    otherwise a copy whose rows are padded with zeros to such a length."""
    vec = 16 // a.element_size()
    if (a.stride(1) == 1 and a.data_ptr() % 16 == 0 and a.stride(0) % vec == 0
            and a.shape[1] % vec == 0):
        return a
    R, C = a.shape
    buf = torch.zeros((R, -(-C // vec) * vec), dtype=a.dtype, device=a.device)
    buf[:, :C] = a
    return buf[:, :C]


def _launch_args(x, w, targets, which: int):
    """Validate a CUDA call and bring its operands into the kernels' layout."""
    _check(x.device.type == "cuda", f"tensors must be on CUDA, got {x.device}")
    _check(w.device == x.device and targets.device == x.device,
           "x, w and targets must share a device")
    _check(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} (fp32 or bf16)")
    _check(w.dtype == x.dtype, "x and w must share a dtype")
    code = _DTYPE_CODE[x.dtype]
    lib = _lib()
    smem = lib.fxent_smem_bytes(which, code)
    _check(smem <= _SMEM_LIMIT, f"{smem} bytes of shared memory")
    return lib, _operand(x), _operand(w), targets.to(torch.int32).contiguous(), code


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused_xent {what} kernel launch failed: CUDA error {err}")


def _fwd_cuda(x, w, targets, softcap):
    lib, x, w, t, code = _launch_args(x, w, targets, 0)
    (T, D), V = x.shape, w.shape[1]
    part = torch.empty((3, T, lib.fxent_num_vtiles(V)), dtype=torch.float32,
                       device=x.device)
    nll = torch.empty((T,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    with torch.cuda.device(x.device):
        err = lib.fxent_fwd_launch(
            x.data_ptr(), w.data_ptr(), t.data_ptr(), part.data_ptr(), nll.data_ptr(),
            lse.data_ptr(), T, D, V, x.stride(0), w.stride(0), float(softcap), code,
            _stream(x.device))
    _raise_on(err, "forward")
    _fwd.launches += 1
    return nll, lse


def _fwd_partial_cuda(x, w, t_local, softcap):
    lib, x, w, t, code = _launch_args(x, w, t_local, 0)
    (T, D), V = x.shape, w.shape[1]
    part = torch.empty((3, T, lib.fxent_num_vtiles(V)), dtype=torch.float32,
                       device=x.device)
    m, l, tgt = torch.empty((3, T), dtype=torch.float32, device=x.device).unbind(0)
    with torch.cuda.device(x.device):
        err = lib.fxent_fwd_partial_launch(
            x.data_ptr(), w.data_ptr(), t.data_ptr(), part.data_ptr(), m.data_ptr(),
            l.data_ptr(), tgt.data_ptr(), T, D, V, x.stride(0), w.stride(0),
            float(softcap), code, _stream(x.device))
    _raise_on(err, "partial forward")
    _fwd_partial.launches += 1
    return m, l, tgt


def _bwd_cuda(x, w, targets, lse, g, softcap):
    lib, xk, wk, t, code = _launch_args(x, w, targets, 1)
    (T, D), V = x.shape, w.shape[1]
    _check(lse.shape == (T,) and g.shape == (T,), "lse and g must be [T]")
    lse = lse.to(x.device, torch.float32).contiguous()
    g = g.to(x.device, torch.float32).contiguous()
    dx = torch.empty((T, D), dtype=x.dtype, device=x.device)
    dw = torch.empty((D, V), dtype=w.dtype, device=x.device)
    if x.dtype == torch.float32:  # the fp32 sums are the result
        dx32, dw32 = dx, dw
    else:
        dx32 = torch.empty((T, D), dtype=torch.float32, device=x.device)
        dw32 = torch.empty((D, V), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fxent_bwd_launch(
            xk.data_ptr(), wk.data_ptr(), t.data_ptr(), lse.data_ptr(), g.data_ptr(),
            dx32.data_ptr(), dw32.data_ptr(), dx.data_ptr(), dw.data_ptr(), T, D, V,
            xk.stride(0), wk.stride(0), float(softcap), code, _stream(x.device))
    _raise_on(err, "backward")
    _bwd.launches += 1
    return dx, dw


# ---------------------------------------------------------------------- raw entry points
def _check_shapes(x, w, targets):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("fused cross-entropy: x must be [T,D] and w [D,V]")
    if tuple(targets.shape) != (x.shape[0],):
        raise ValueError("fused cross-entropy: targets must be [T]")


def _fwd(x, w, targets, softcap=0.0):
    """Raw forward: x [T,D], w [D,V], targets [T] → (nll, lse), fp32 [T]. CPU tensors
    run :func:`fused_xent_reference`; others launch the kernel."""
    _check_shapes(x, w, targets)
    if x.device.type == "cpu":
        return fused_xent_reference(x, w, targets, softcap)
    return _fwd_cuda(x, w, targets, softcap)


def _fwd_partial(x, w_shard, t_local, softcap=0.0):
    """Raw partial forward of a vocab shard: x [T,D], w_shard [D,Vl], shard-local
    targets [T] → (m, l, tgt), fp32 [T]. CPU tensors run
    :func:`fused_xent_partial_reference`; others launch the kernel."""
    _check_shapes(x, w_shard, t_local)
    if x.device.type == "cpu":
        return fused_xent_partial_reference(x, w_shard, t_local, softcap)
    return _fwd_partial_cuda(x, w_shard, t_local, softcap)


def _bwd(x, w, targets, lse, g, softcap=0.0):
    """Raw backward → (dx [T,D] in x's type, dw [D,V] in w's type) from the forward's
    lse and the cotangent g [T] of nll: one kernel launch for both."""
    _check_shapes(x, w, targets)
    if x.device.type == "cpu":
        return (fused_xent_dx_reference(x, w, targets, lse, g, softcap),
                fused_xent_dw_reference(x, w, targets, lse, g, softcap))
    return _bwd_cuda(x, w, targets, lse, g, softcap)


#: Kernel launches since the counts were last reset (CPU calls are not counted).
_fwd.launches = 0
_fwd_partial.launches = 0
_bwd.launches = 0


# ---------------------------------------------------------------------------- autograd
class _FusedXent(torch.autograd.Function):
    """Differentiable fused CE (``_fce`` and its custom VJP in the JAX package)."""

    @staticmethod
    def forward(ctx, x, w, targets, softcap):
        if w.device.type != "cpu":
            w = _operand(w)  # a tied head's embed.T: one contiguous copy, kept for backward
        nll, lse = _fwd(x, w, targets, softcap)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.softcap = softcap
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        dx, dw = _bwd(x, w, targets, lse, g, ctx.softcap)
        return dx, dw, None, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                        softcap: float = 0.0) -> torch.Tensor:
    """Per-token ``-log p(target)`` for ``logits = x @ w`` without materializing the
    logits: x [T,D], w [D,V] (one type), targets [T] int → nll [T] fp32; differentiable
    in x and w. Mask and mean outside: a -1 target's nll is its lse (finite, safe to
    mask)."""
    _check_shapes(x, w, targets)
    return _FusedXent.apply(x, w, targets, float(softcap))


class _FusedXentTP(torch.autograd.Function):
    """Differentiable vocab-sharded fused CE (``_fce_tp`` and its custom VJP in the JAX
    package). The JAX backward scales the cotangent by the axis size to undo
    shard_map's split-cotangent convention; with explicit collectives every rank gets
    the true cotangent, so nothing is scaled here."""

    @staticmethod
    def forward(ctx, x, w, targets, group, softcap):
        rank, _ = group_rank_size(group)
        if w.device.type != "cpu":
            w = _operand(w)  # a tied head's embed.T: one contiguous copy, kept for backward
        t_local = targets.long() - rank * w.shape[1]  # other ranks' ids fall out of range
        m, l, tgt = _fwd_partial(x, w, t_local, softcap)
        m_g = all_reduce(m.clone(), "max", group)
        l_g = all_reduce(l * torch.exp(m - m_g), "sum", group)
        tgt_g = all_reduce(tgt.clone(), "sum", group)  # exactly one rank owns each id
        lse = m_g + torch.log(l_g)
        ctx.save_for_backward(x, w, t_local, lse)
        ctx.group, ctx.softcap = group, softcap
        return lse - tgt_g

    @staticmethod
    def backward(ctx, g):
        x, w, t_local, lse = ctx.saved_tensors
        dx, dw = _bwd(x, w, t_local, lse, g.contiguous(), ctx.softcap)
        return all_reduce(dx, "sum", ctx.group), dw, None, None, None


def fused_cross_entropy_tp(x: torch.Tensor, w_shard: torch.Tensor, targets: torch.Tensor,
                           group=None, softcap: float = 0.0) -> torch.Tensor:
    """Per-token ``-log p(target)`` over a vocab-sharded head: x [T,D] (replicated over
    ``group``), this rank's slice ``w_shard`` [D, V/n] (rank r holds columns
    ``r·V/n ..``) and the global targets [T] → nll [T] fp32, the same on every rank;
    differentiable in x and w_shard. ``group`` is the tensor-parallel process group
    (``None``: one rank holding the whole head)."""
    _check_shapes(x, w_shard, targets)
    return _FusedXentTP.apply(x, w_shard, targets, group, float(softcap))
