"""Shared model-family machinery: activation checkpointing, the attention and
cross-entropy dispatch of the training path, and KV-cache planes, dense and paged.

Counterpart of ``remat_wrap``, ``attention_dispatch``, ``resolve_loss_chunk``,
``chunked_ce``, ``ce_sum``, ``ce_sum_dispatch``, ``fused_ce_allowed``,
``fused_ce_single_shard`` and the KV helpers in
``accelerate_tpu/models/common.py``. ``jax.checkpoint`` becomes
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the block's forward runs
again during the backward, so a checkpointed block launches its attention forward twice
per step. Attention ``flash`` launches the port's flash kernels on CUDA tensors (their
plain versions on the CPU) and never falls back to the ``xla`` path; ``auto`` is
``flash`` on CUDA and ``xla`` on the CPU. ``loss_impl="fused"`` launches the fused
cross-entropy kernels on CUDA tensors (their plain versions on the CPU) and never falls
back to the chunked path. Caches are plane
dicts: ``k``/``v`` ``[B,C,heads,hd]`` (dense) or ``[P,page_size,heads,hd]`` (paged
pool), plus ``k_scale``/``v_scale`` ``[...,1]`` fp32 when int8-quantized.

JAX arrays are immutable and the JAX engine donates its cache; here the writers update
the planes IN PLACE and return them, so a cache is never copied per step. JAX scatter
semantics are reproduced explicitly: out-of-range per-row writes and writes through
the sentinel page id are DROPPED (masked), and a scalar-start slice write CLAMPS its
start like ``lax.dynamic_update_slice``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.fused_xent import fused_cross_entropy
from ..ops.paged_attention import gather_pages, paged_attention

__all__ = [
    "remat_wrap", "attention_dispatch",
    "resolve_loss_chunk", "chunked_ce", "ce_sum", "ce_sum_dispatch",
    "fused_ce_allowed", "fused_ce_single_shard",
    "kv_planes", "quant_kv", "write_kv", "read_kv",
    "paged_kv_planes", "write_kv_paged", "read_kv_paged", "paged_write_coords",
    "paged_attention_dispatch",
]

_SP_MODES = ("ring", "ulysses", "ulysses_ppermute", "allgather")


def remat_wrap(fn: Callable, *, remat: bool, policy: str = "full") -> Callable:
    """``fn`` under the config's activation-checkpointing policy. ``full`` recomputes
    the whole call in the backward (``torch.utils.checkpoint``, non-reentrant, so
    non-tensor arguments such as configs pass through as they are). ``dots`` and
    ``offload`` are not ported."""
    if not remat:
        return fn
    if policy in ("dots", "offload"):
        raise NotImplementedError(f"remat_policy={policy!r} is not ported yet (only 'full')")
    if policy != "full":
        raise ValueError(f"remat_policy={policy!r}: expected 'full', 'dots' or 'offload'")

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped


def attention_dispatch(q, k, v, mask, *, impl: str, sm_scale: float, window: int = 0,
                       softcap: float = 0.0, segment_ids=None, xla_attention=None):
    """Causal self-attention over q [B,S,H,hd], k/v [B,S,K,hd] (GQA: K ≤ H): ``impl``
    ``flash`` (the flash kernels; segment ids, window and softcap in-kernel), ``xla``
    (the family's ``xla_attention(q, k, v, mask)``) or ``auto`` (flash on CUDA, xla on
    the CPU). The sequence-parallel modes are not ported."""
    if impl in _SP_MODES:
        raise NotImplementedError(f"attn_impl={impl!r} (sequence parallelism) is not ported")
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "xla"
    if impl == "flash":
        return flash_attention(q, k, v, causal=True, sm_scale=sm_scale,
                               segment_ids=segment_ids, window=window, softcap=softcap)
    if impl == "xla":
        return xla_attention(q, k, v, mask)
    raise ValueError(f"attn_impl={impl!r}: expected 'auto', 'flash' or 'xla'")


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit capping: cap·tanh(x/cap) (identity when cap == 0)."""
    return cap * torch.tanh(scores / cap) if cap else scores


def resolve_loss_chunk(loss_chunk: int, S: int, vocab_size: int) -> int:
    """Chunked-CE chunk length (0 = don't chunk): an explicit ``loss_chunk`` is honored
    (capped at S), ``-1`` disables chunking, and auto (0) chunks at 512 only when the
    fp32 logits of one row would pass 2**24 elements (64 MB)."""
    if loss_chunk == -1:
        return 0
    if loss_chunk > 0:
        return min(loss_chunk, S)
    if S * vocab_size <= 2**24:
        return 0
    return min(512, S)


def _head_logits(x, head, dtype, softcap, bias):
    logits = (x @ head.to(dtype)).float()
    if bias is not None:
        logits = logits + bias.float()
    return _softcap(logits, softcap)


def _chunk_loss(xc, head, tc, mc, dtype, softcap, bias):
    logits = _head_logits(xc, head, dtype, softcap, bias)          # [B, c, V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None]).squeeze(-1)
    return -((tgt - lse) * mc).sum()


def chunked_ce(x, head, targets, mask, chunk: int, dtype, final_softcap: float = 0.0,
               bias=None):
    """Memory-efficient cross-entropy: the sum of -log p(target) over unmasked
    positions, one [B, chunk, V] block of fp32 logits at a time, each recomputed in the
    backward (checkpointed), so peak memory is O(chunk·V) instead of O(S·V). S is padded
    up to a chunk multiple with masked positions."""
    B, S, D = x.shape
    targets = targets.long()
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
        S += pad
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        total = total + checkpoint(
            _chunk_loss, x[:, i:i + chunk], head, targets[:, i:i + chunk],
            mask[:, i:i + chunk], dtype, final_softcap, bias, use_reentrant=False)
    return total


def ce_sum(x, head, targets, mask, *, dtype, chunk: int = 0, softcap: float = 0.0,
           bias=None) -> torch.Tensor:
    """SUM-style CE (chunked when ``chunk`` > 0): the one copy of the softcap +
    log-softmax + target-gather math."""
    if chunk > 0:
        return chunked_ce(x, head, targets, mask, chunk, dtype, final_softcap=softcap,
                          bias=bias)
    logp = torch.log_softmax(_head_logits(x, head, dtype, softcap, bias), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None]).squeeze(-1)
    return -(ll * mask).sum()


def ce_sum_dispatch(x, head, targets, mask, *, loss_impl: str, dtype, chunk: int = 0,
                    softcap: float = 0.0, bias=None) -> torch.Tensor:
    """SUM-style CE dispatch over ``loss_impl``: ``auto`` takes :func:`ce_sum`, ``fused``
    the fused linear + CE kernels (:func:`fused_ce_single_shard`, converted back to a
    sum). The fused kernels have no bias term, so a non-None ``bias`` takes
    :func:`ce_sum` whatever ``loss_impl`` says. ``fused_dp`` and ``fused_tp`` need a
    process mesh and are not ported."""
    if loss_impl not in ("auto", "fused", "fused_dp", "fused_tp"):
        raise ValueError(f"loss_impl={loss_impl!r}: expected 'auto', 'fused', 'fused_dp', "
                         "or 'fused_tp' (a typo would otherwise silently run the chunked path)")
    if bias is not None:
        loss_impl = "auto"
    if loss_impl in ("fused_dp", "fused_tp"):
        raise NotImplementedError(f"loss_impl={loss_impl!r} needs a process mesh, which is "
                                  "not ported yet (ROADMAP A.7)")
    if loss_impl == "fused":
        loss = fused_ce_single_shard(x, head.to(dtype), targets, mask, softcap=softcap)
        if loss is None:
            raise NotImplementedError("loss_impl='fused' runs in one process; across "
                                      "processes it needs 'fused_dp' (ROADMAP A.7)")
        # The masked mean, back to a sum: every branch here returns a sum.
        return loss * torch.clamp(mask.sum(), min=1.0)
    return ce_sum(x, head, targets, mask, dtype=dtype, chunk=chunk, softcap=softcap,
                  bias=bias)


def fused_ce_allowed() -> bool:
    """True when the single-shard fused-CE kernel may run: one process (no
    ``torch.distributed`` group of more than one rank)."""
    return not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1)


def fused_ce_single_shard(x, head, targets, mask, softcap: float = 0.0):
    """Masked-mean fused cross-entropy over [B,S,D] hidden states, or None when
    :func:`fused_ce_allowed` says the kernel must not run. ``mask`` [B,S] float;
    ``head`` [D,V] already in the compute type."""
    if not fused_ce_allowed():
        return None
    B, S, D = x.shape
    nll = fused_cross_entropy(x.reshape(B * S, D), head, targets.reshape(B * S),
                              softcap=softcap)
    mask1d = mask.reshape(B * S)
    return (nll * mask1d).sum() / torch.clamp(mask1d.sum(), min=1.0)


def kv_planes(batch: int, max_len: int, heads: int, head_dim: int, dtype, quantized: bool,
              device=None) -> dict:
    """One layer's empty cache planes: {k, v} (+ {k_scale, v_scale} when int8)."""
    shape = (batch, max_len, heads, head_dim)
    if quantized:
        scale = (batch, max_len, heads, 1)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scale, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(scale, dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization per (batch, token, head): x [B,T,K,hd] →
    (int8 values, fp32 scales [B,T,K,1]). Scale floor keeps all-zero rows exact."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _planes(kv: dict, name: str, val: torch.Tensor):
    if f"{name}_scale" in kv:
        q, scale = quant_kv(val)
        return ((name, q), (f"{name}_scale", scale))
    return ((name, val),)


def write_kv(kv: dict, name: str, val: torch.Tensor, index: Union[int, torch.Tensor]) -> dict:
    """Write ``val`` [B,T,...] into cache plane ``name`` IN PLACE at ``index`` — a
    scalar start slot for all rows (clamped into range, as ``dynamic_update_slice``
    does) or a per-row vector ``[B]`` (row b's tokens land at ``index[b] ..
    index[b]+T-1``; slots past the cache end are dropped) — quantizing when the cache
    is int8. Returns the written planes."""
    out = {}
    for key, plane in _planes(kv, name, val):
        dst = kv[key]
        B, T = plane.shape[0], plane.shape[1]
        if not torch.is_tensor(index) or index.dim() == 0:
            start = min(max(int(index), 0), dst.shape[1] - T)
            dst[:, start:start + T] = plane.to(dst.dtype)
        else:
            slots = index.long()[:, None] + torch.arange(T, device=dst.device)[None, :]
            rows = torch.arange(B, device=dst.device)[:, None].expand(B, T)
            keep = slots < dst.shape[1]
            dst[rows[keep], slots[keep]] = plane[keep].to(dst.dtype)
        out[key] = dst
    return out


def read_kv(kv: dict, name: str, dtype) -> torch.Tensor:
    """Cache plane as compute dtype; int8 planes dequantize against their scales."""
    if f"{name}_scale" in kv:
        return kv[name].to(dtype) * kv[f"{name}_scale"].to(dtype)
    return kv[name]


def paged_kv_planes(num_pages: int, page_size: int, heads: int, head_dim: int, dtype,
                    quantized: bool, device=None) -> dict:
    """One layer's empty paged pool: {k, v} [P, page_size, K, hd] (+ fp32 scales
    [P, page_size, K, 1] when int8) — indexed by (physical page, slot);
    ``paged_kv.BlockManager`` owns which lane references which page."""
    return kv_planes(num_pages, page_size, heads, head_dim, dtype, quantized, device)


def write_kv_paged(kv: dict, name: str, val: torch.Tensor, pages: torch.Tensor,
                   offs: torch.Tensor) -> dict:
    """Write ``val`` [B,T,K,hd] IN PLACE into pool plane ``name`` at physical slots
    ``(pages[b,t], offs[b,t])``, quantizing when the pool is int8 (the same per-slot
    quantization as :func:`write_kv`). Sentinel page ids (== num_pages) are DROPPED —
    stale/unallocated table entries never corrupt another lane's pages."""
    out = {}
    for key, plane in _planes(kv, name, val):
        dst = kv[key]
        keep = pages < dst.shape[0]
        dst[pages[keep].long(), offs[keep].long()] = plane[keep].to(dst.dtype)
        out[key] = dst
    return out


def read_kv_paged(kv: dict, name: str, tables: torch.Tensor, length: int,
                  dtype) -> torch.Tensor:
    """Dense ``[B, length, K, hd]`` compute-dtype view of pool plane ``name`` gathered
    through block tables — ONE implementation shared with the kernel's plain version
    (``ops.paged_attention.gather_pages``)."""
    return gather_pages(kv, name, tables, length, dtype)


def paged_write_coords(tables: torch.Tensor, pos_grid: torch.Tensor, page_size: int,
                       max_len: int, num_pages: int):
    """Physical (page, slot) write coordinates for logical positions ``pos_grid``
    [B,T] through block tables [B,MP]. Positions at/past ``max_len`` and unallocated
    logical pages route to the SENTINEL page id (== ``num_pages``) so the paged write
    drops them."""
    logical = torch.clamp(pos_grid.long() // page_size, max=tables.shape[1] - 1)
    sentinel = torch.full_like(tables[:, :1], num_pages)
    pages = torch.where(pos_grid < max_len, torch.gather(tables, 1, logical), sentinel)
    return pages, pos_grid % page_size


def paged_attention_dispatch(q, pool, tables, positions, valid, *, page_size: int,
                             sm_scale: float, window: int = 0, softcap: float = 0.0,
                             dtype, dense_attention: Callable):
    """Family-shared paged-attention read: the CUDA kernel for CUDA tensors
    (``ops.paged_attention.paged_attention``); on the CPU, gather through the tables
    into the family's own dense cached attention (``dense_attention(ck, cv)``) — which
    makes CPU paged decode bitwise the dense engine, as the JAX package's non-TPU
    path does."""
    if q.device.type == "cuda":
        return paged_attention(
            q, pool, tables, positions, valid, page_size=page_size,
            sm_scale=sm_scale, window=window, softcap=softcap,
        )
    ck = read_kv_paged(pool, "k", tables, valid.shape[1], dtype)
    cv = read_kv_paged(pool, "v", tables, valid.shape[1], dtype)
    return dense_attention(ck, cv)
