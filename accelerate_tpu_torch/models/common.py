"""Shared model-family machinery: KV-cache planes, dense and paged.

Counterpart of the KV helpers in ``accelerate_tpu/models/common.py``. Caches are plane
dicts: ``k``/``v`` ``[B,C,heads,hd]`` (dense) or ``[P,page_size,heads,hd]`` (paged
pool), plus ``k_scale``/``v_scale`` ``[...,1]`` fp32 when int8-quantized.

JAX arrays are immutable and the JAX engine donates its cache; here the writers update
the planes IN PLACE and return them, so a cache is never copied per step. JAX scatter
semantics are reproduced explicitly: out-of-range per-row writes and writes through
the sentinel page id are DROPPED (masked), and a scalar-start slice write CLAMPS its
start like ``lax.dynamic_update_slice``.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from ..ops.paged_attention import gather_pages, paged_attention

__all__ = [
    "kv_planes", "quant_kv", "write_kv", "read_kv",
    "paged_kv_planes", "write_kv_paged", "read_kv_paged", "paged_write_coords",
    "paged_attention_dispatch",
]


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
