"""Flash attention, forward and backward: the Hopper CUDA kernels and their plain
PyTorch versions.

Counterpart of ``accelerate_tpu/ops/flash_attention.py``. Layout: the raw entry points
take q ``[B,H,S,hd]`` and k/v ``[B,K,T,hd]`` with K dividing H (GQA: q head h reads kv
head ``h // (H//K)``); :func:`flash_attention` takes the user layout ``[B,S,H,hd]``.

- :func:`_fwd` → ``(o, lse)``; :func:`_bwd_dq` → dq; :func:`_bwd_dkv` → ``(dk, dv)``.
  They take ``q_offset``/``kv_offset`` (global positions of the local blocks, for the
  ring attention of a later slice), ``segments`` (None, one ``[B,S]`` array, or a
  ``(q_seg [B,S], kv_seg [B,T])`` pair; 0 = padding), ``window`` and ``softcap``.
  Gradients come back in fp32, as the Pallas kernels write them.
- :func:`flash_attention_reference`, :func:`flash_dq_reference` and
  :func:`flash_dkv_reference` are the plain versions: the same masks and recompute
  formulas over the whole score matrix.
- Each raw entry point runs its plain version on CPU tensors. Any other tensors go to
  the hand-written kernels of ``csrc/flash_attention.cu`` (built at first use by
  ``ops/_build.py``), whose launches are counted in ``_fwd.launches``,
  ``_bwd_dq.launches`` and ``_bwd_dkv.launches``. A CUDA call never falls back: a
  refused device, type, head dim or launch raises.
- :func:`flash_attention` is differentiable: a ``torch.autograd.Function`` that saves
  ``(q, k, v, o, lse)`` and, in backward, computes ``delta = sum(do * o)`` in fp32 and
  calls dq and dk/dv (``_flash_bhsd`` and its VJP in the JAX package).

Semantics kept from the Pallas kernels: key j is visible to query i iff (causal)
``kv_offset + j <= q_offset + i``, (window) ``kv_offset + j > q_offset + i - window``,
and (segments) the two segment ids are equal and the key's is not 0. Scores are
``q·k`` with fp32 accumulation times ``sm_scale``, optionally ``cap·tanh(s/cap)``; p is
rounded to the value type before ``p·v``; a row that sees no key outputs zeros with
lse = -1e30; ds is rounded to the input type before the ``ds·k`` / ``dsᵀ·q`` products.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = [
    "flash_attention", "flash_attention_reference", "flash_dq_reference",
    "flash_dkv_reference", "_fwd", "_bwd_dq", "_bwd_dkv",
]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper


# --------------------------------------------------------------------------- plain math
def _seg_pair(segments):
    """None | [B,S] | (q_seg [B,S], kv_seg [B,T]) → None or an int32 pair."""
    if segments is None:
        return None
    if not isinstance(segments, (tuple, list)):
        segments = (segments, segments)
    return tuple(torch.as_tensor(s).to(torch.int32) for s in segments)


def _visible(S, T, causal, window, q_offset, kv_offset, segs, device) -> torch.Tensor:
    """Boolean visibility [B|1, 1, 1, S, T] (broadcast over kv heads and groups)."""
    row = q_offset + torch.arange(S, device=device)[:, None]
    col = kv_offset + torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (col <= row)
    if window:
        mask = mask & (col > row - window)
    mask = mask[None]
    if segs is not None:
        q_seg, kv_seg = (s.to(device) for s in segs)
        mask = mask & (q_seg[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] != 0)
    return mask[:, None, None]


def _scores(q, k, sm_scale, softcap):
    """fp32 scores [B,K,G,S,T] (and tanh(s/cap) under a cap): the dot in fp32 over the
    input values, which is what an input-type dot with fp32 accumulation computes."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(B, K, H // K, S, hd).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * sm_scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    return s, t


def flash_attention_reference(q, k, v, causal=True, sm_scale=None, q_offset=0, kv_offset=0,
                              segments=None, window=0, softcap=0.0):
    """Plain forward: q [B,H,S,hd], k/v [B,K,T,hd] → (o [B,H,S,hd] in q's type,
    lse [B,H,S] fp32)."""
    B, H, S, hd = q.shape
    sm_scale = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    s, _ = _scores(q, k, sm_scale, softcap)
    mask = _visible(S, k.shape[2], causal, window, q_offset, kv_offset, _seg_pair(segments),
                    q.device)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype).float(), v.float())
    o = (acc / l_safe).to(q.dtype).reshape(B, H, S, hd)
    lse = torch.where(l == 0.0, _NEG_INF, m + torch.log(l_safe)).reshape(B, H, S)
    return o, lse


def _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale, q_offset, kv_offset, segments,
               window, softcap):
    """The backward's recompute: p = exp(s - lse) (masked to 0) and ds (fp32 values
    rounded to the input type), both [B,K,G,S,T]."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    s, t = _scores(q, k, sm_scale, softcap)
    mask = _visible(S, k.shape[2], causal, window, q_offset, kv_offset, _seg_pair(segments),
                    q.device)
    lse_g = lse.reshape(B, K, H // K, S, 1).float()
    delta_g = delta.reshape(B, K, H // K, S, 1).float()
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dog = do.reshape(B, K, H // K, S, hd).float()
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, v.float())
    ds = p * (dp - delta_g) * sm_scale
    if softcap:
        ds = ds * (1.0 - t * t)
    return p, ds.to(k.dtype).float(), dog


def flash_dq_reference(q, k, v, do, lse, delta, causal=True, sm_scale=None, q_offset=0,
                       kv_offset=0, segments=None, window=0, softcap=0.0):
    """Plain dq [B,H,S,hd] fp32 from the recomputed ds: dq = ds · k."""
    B, H, S, hd = q.shape
    sm_scale = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    _, ds, _ = _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale, q_offset, kv_offset,
                          segments, window, softcap)
    return torch.einsum("bkgst,bktd->bkgsd", ds, k.float()).reshape(B, H, S, hd)


def flash_dkv_reference(q, k, v, do, lse, delta, causal=True, sm_scale=None, q_offset=0,
                        kv_offset=0, segments=None, window=0, softcap=0.0):
    """Plain (dk, dv) [B,K,T,hd] fp32, summed over each kv head's query group:
    dk = dsᵀ · q, dv = pᵀ · do (p rounded to do's type)."""
    B, H, S, hd = q.shape
    sm_scale = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    p, ds, dog = _bwd_terms(q, k, v, do, lse, delta, causal, sm_scale, q_offset, kv_offset,
                            segments, window, softcap)
    qg = q.reshape(B, k.shape[1], H // k.shape[1], S, hd).float()
    dv = torch.einsum("bkgst,bkgsd->bktd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg)
    return dk, dv


# ------------------------------------------------------------------------ CUDA launches
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_launch.argtypes = [vp] * 7 + [ci] * 6 + [vp] * 4 + [cf, cf] + [ci] * 5 + [vp]
        lib.flash_bwd_dq_launch.argtypes = (
            [vp] * 9 + [ci] * 6 + [vp] * 5 + [cf, cf] + [ci] * 5 + [vp])
        lib.flash_bwd_dkv_launch.argtypes = (
            [vp] * 10 + [ci] * 6 + [vp] * 6 + [cf, cf] + [ci] * 5 + [vp])
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_dkv_launch):
            fn.restype = ctypes.c_int
        lib.flash_smem_bytes.argtypes = [ci, ci, ci]
        lib.flash_smem_bytes.restype = ci
        lib._argtypes_set = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def _tma_ok(x: torch.Tensor) -> bool:
    """Whether the kernels read ``x`` in place: its last dim contiguous, its base and the
    stride of every other dim of more than one element on 16 bytes (what TMA and
    cp.async need; a dim of one element may have any stride, the kernels never step
    along it). The model's ``[B,S,H,hd]`` tensors viewed as ``[B,H,S,hd]`` qualify."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % vec == 0 for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n > 1))


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when :func:`_tma_ok`, else a fresh contiguous copy (``contiguous``
    would hand back a contiguous tensor whose base is off 16 bytes as it is)."""
    return x if _tma_ok(x) else x.clone(memory_format=torch.contiguous_format)


def _strides(x: torch.Tensor):
    return (ctypes.c_int64 * 3)(*x.stride()[:3])


def _launch_args(q, k, v, segments, window, causal, q_offset, kv_offset, sm_scale, softcap,
                 which: int):
    """Validate a CUDA call and bring its operands into the kernels' layout."""
    B, H, S, hd = q.shape
    _check(q.device.type == "cuda", f"tensors must be on CUDA, got {q.device}")
    _check(k.device == q.device and v.device == q.device, "q, k, v must share a device")
    _check(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (fp32 or bf16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype, "q, k, v must share a dtype")
    _check(hd in _HEAD_DIMS, f"head dim {hd} not in {_HEAD_DIMS}")
    _check(k.dim() == 4 and k.shape[0] == B and k.shape[3] == hd and v.shape == k.shape,
           "k/v must be [B,K,T,hd]")
    _check(H % k.shape[1] == 0, f"q heads ({H}) must be a multiple of kv heads ({k.shape[1]})")
    segs = _seg_pair(segments)
    if segs is not None:
        segs = tuple(s.to(q.device).contiguous() for s in segs)
        _check(tuple(segs[0].shape) == (B, S) and tuple(segs[1].shape) == (B, k.shape[2]),
               "segments must be [B,S] and [B,T]")
    lib = _lib()
    smem = lib.flash_smem_bytes(which, hd, _DTYPE_CODE[q.dtype])
    _check(0 < smem <= _SMEM_LIMIT, f"{smem} bytes of shared memory")
    scale = 1.0 / math.sqrt(hd) if sm_scale is None else float(sm_scale)
    seg_ptrs = (segs[0].data_ptr(), segs[1].data_ptr()) if segs is not None else (None, None)
    tail = [scale, float(softcap), int(window), int(bool(causal)), int(q_offset),
            int(kv_offset), _DTYPE_CODE[q.dtype]]
    return lib, segs, seg_ptrs, tail


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention {what} kernel launch failed: CUDA error {err}")


def _fwd_cuda(q, k, v, causal, sm_scale, q_offset, kv_offset, segments, window, softcap):
    lib, segs, seg_ptrs, tail = _launch_args(q, k, v, segments, window, causal, q_offset,
                                             kv_offset, sm_scale, softcap, 0)
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    B, H, S, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), *seg_ptrs,
            B, H, k.shape[1], S, k.shape[2], hd, _strides(q), _strides(k), _strides(v),
            _strides(o), *tail, _stream(q.device))
    _raise_on(err, "forward")
    _fwd.launches += 1
    return o, lse


def _bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale, q_offset, kv_offset, segments,
                 window, softcap):
    lib, segs, seg_ptrs, tail = _launch_args(q, k, v, segments, window, causal, q_offset,
                                             kv_offset, sm_scale, softcap, 1)
    _check(do.shape == q.shape and do.dtype == q.dtype and do.device == q.device,
           "do must match q")
    q, k, v, do = (_kernel_layout(x) for x in (q, k, v, do))
    lse, delta = (x.float().contiguous() for x in (lse, delta))
    B, H, S, hd = q.shape
    dq = torch.empty_like(q, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *seg_ptrs, B, H, k.shape[1], S, k.shape[2], hd,
            _strides(q), _strides(k), _strides(v), _strides(do), _strides(dq), *tail,
            _stream(q.device))
    _raise_on(err, "dq")
    _bwd_dq.launches += 1
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale, q_offset, kv_offset, segments,
                  window, softcap):
    lib, segs, seg_ptrs, tail = _launch_args(q, k, v, segments, window, causal, q_offset,
                                             kv_offset, sm_scale, softcap, 2)
    _check(do.shape == q.shape and do.dtype == q.dtype and do.device == q.device,
           "do must match q")
    q, k, v, do = (_kernel_layout(x) for x in (q, k, v, do))
    lse, delta = (x.float().contiguous() for x in (lse, delta))
    B, H, S, hd = q.shape
    dk = torch.empty_like(k, dtype=torch.float32)
    dv = torch.empty_like(v, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *seg_ptrs, B, H, k.shape[1], S,
            k.shape[2], hd, _strides(q), _strides(k), _strides(v), _strides(do),
            _strides(dk), _strides(dv), *tail, _stream(q.device))
    _raise_on(err, "dk/dv")
    _bwd_dkv.launches += 1
    return dk, dv


# ---------------------------------------------------------------------- raw entry points
def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash attention: q must be [B,H,S,hd] and k/v [B,K,T,hd]")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads ({q.shape[1]}) must be a multiple of kv heads "
                         f"({k.shape[1]})")


def _fwd(q, k, v, causal=True, sm_scale=None, q_offset=0, kv_offset=0, segments=None,
         window=0, softcap=0.0):
    """Raw forward: q [B,H,S,hd], k/v [B,K,T,hd] → (o [B,H,S,hd], lse [B,H,S] fp32).
    CPU tensors run :func:`flash_attention_reference`; others launch the kernel."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale, q_offset, kv_offset,
                                         segments, window, softcap)
    return _fwd_cuda(q, k, v, causal, sm_scale, q_offset, kv_offset, segments, window, softcap)


def _bwd_dq(q, k, v, do, lse, delta, causal=True, sm_scale=None, q_offset=0, kv_offset=0,
            segments=None, window=0, softcap=0.0):
    """Raw dq [B,H,S,hd] fp32 for q against one kv block (``delta = sum(do·o)``)."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, causal, sm_scale, q_offset,
                                  kv_offset, segments, window, softcap)
    return _bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale, q_offset, kv_offset,
                        segments, window, softcap)


def _bwd_dkv(q, k, v, do, lse, delta, causal=True, sm_scale=None, q_offset=0, kv_offset=0,
             segments=None, window=0, softcap=0.0):
    """Raw (dk, dv) [B,K,T,hd] fp32 for one kv block, summed over each kv head's group."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, sm_scale, q_offset,
                                   kv_offset, segments, window, softcap)
    return _bwd_dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale, q_offset, kv_offset,
                         segments, window, softcap)


#: Kernel launches since the counts were last reset (CPU calls are not counted).
_fwd.launches = 0
_bwd_dq.launches = 0
_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------- autograd
class _FlashBHSD(torch.autograd.Function):
    """Differentiable flash attention over [B,H,S,hd] / [B,K,T,hd] (``_flash_bhsd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, kv_offset, segments, window,
                softcap):
        o, lse = _fwd(q, k, v, causal, sm_scale, q_offset, kv_offset, segments, window,
                      softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.segments = segments
        ctx.args = (causal, sm_scale, q_offset, kv_offset)
        ctx.band = (window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, q_offset, kv_offset = ctx.args
        window, softcap = ctx.band
        delta = (do.float() * o.float()).sum(dim=-1)  # [B,H,S]
        kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset, kv_offset=kv_offset,
                  segments=ctx.segments, window=window, softcap=softcap)
        dq = _bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = _bwd_dkv(q, k, v, do, lse, delta, **kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    sm_scale: Optional[float] = None, segment_ids: Optional[torch.Tensor] = None,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Flash attention over the user layout q [B,S,H,hd], k/v [B,T,K,hd] (GQA: K ≤ H)
    → [B,S,H,hd] in q's type; differentiable.

    ``segment_ids`` [B,S] (packed rows: 0 = pad, 1..k = sequences) keeps attention
    inside each segment and needs self-attention shapes (T == S); ``window`` > 0 limits
    position i to keys in (i-window, i]; ``softcap`` > 0 caps scores as cap·tanh(s/cap)."""
    B, S, H, hd = q.shape
    if segment_ids is not None and k.shape[1] != S:
        raise ValueError("segment_ids requires self-attention shapes (kv length == q length)")
    if H % k.shape[2]:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads ({k.shape[2]})")
    sm_scale = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    # [B,S,H,hd] → [B,H,S,hd] as views: the kernels read either layout through strides,
    # and the output keeps q's memory layout, so the transpose back is free.
    o = _FlashBHSD.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
                         sm_scale, 0, 0, segment_ids, int(window), float(softcap))
    return o.transpose(1, 2)
