"""Paged-attention decode: the Hopper CUDA kernel and its plain PyTorch version.

Counterpart of ``accelerate_tpu/ops/paged_attention.py``. K/V lives in a shared pool
``[num_pages, page_size, K, hd]`` and each lane maps its logical pages to physical
pages through an int32 block table ``[B, MP]``; this module is the attention read
through that indirection.

- :func:`gather_pages` — dense ``[B, length, K, hd]`` view of a pool plane through the
  tables (sentinel entries clamp to a real page; callers mask those slots).
- :func:`paged_attention_reference` — the plain version: gather, mask, fp32 softmax,
  the same math as the dense cached attention.
- :func:`paged_attention` — the wrapper. On CPU tensors it runs the plain version;
  otherwise :func:`paged_attention_cuda` launches a hand-written kernel of
  ``csrc/paged_attention.cu`` (built at first use, ``ops/_build.py``) and counts the
  launch in ``paged_attention.launches``. :func:`paged_plan` chooses the kernel by dtype
  and shape before the launch: bf16 q takes the cluster kernel (one launch; the blocks of
  one (lane, kv head) split its live tiles as :func:`lane_tiles` says and merge inside
  their thread block cluster) on every shape it takes, the serving path's among them;
  fp32 q, and bf16 q on other shapes (page sizes such as 4 or 24), the CUDA-core pair
  (partial + combine), whose bf16 launches are counted again in
  ``paged_attention.launches_ragged``. A CUDA launch never falls back: a refused device,
  shape, dtype or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_cuda", "paged_attention_reference",
           "gather_pages", "cluster_blocks", "lane_tiles", "paged_plan", "PagedPlan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (32, 64, 128, 256)
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
#: The cluster kernel's tile of key slots, its most blocks per cluster (the portable
#: size) and its most query rows T·H/K (8 n-tiles of the mma; half that at head dim 256).
TILE_SLOTS = 64
MAX_CLUSTER = 8
MAX_ROWS = 64


@functools.lru_cache(maxsize=256)
def cluster_blocks(B: int, K: int, MP: int, page_size: int, sms: int) -> int:
    """Blocks in the bf16 kernel's cluster of one (lane, kv head), each walking tiles of
    ``TILE_SLOTS`` key slots: one per tile of a full lane (``MP * page_size`` slots), at
    most :data:`MAX_CLUSTER`, and no more than keep the ``B * K`` clusters at about two
    blocks an SM, so that the grid runs in one wave. A pure function of the shapes and
    the card's SM count."""
    tiles = -(-(MP * page_size) // TILE_SLOTS)
    fill = 2 * sms // max(1, B * K)
    return max(1, min(MAX_CLUSTER, tiles, fill))


class PagedPlan(NamedTuple):
    """One launch: ``route`` ``"cluster"`` (the bf16 cluster kernel, ``blocks`` blocks a
    cluster) or ``"pair"`` (the partial + combine pair; ``blocks`` 0)."""

    route: str
    blocks: int


@functools.lru_cache(maxsize=256)
def paged_plan(bf16: bool, B: int, T: int, H: int, K: int, hd: int, page_size: int,
               MP: int, sms: int, aligned: bool = True) -> PagedPlan:
    """The kernel of a call, by dtype and shape: the cluster kernel for bf16 q when the
    page size is a power of two of at least 8 (its TMA copies whole pages into 64-slot
    tiles), the query rows T·H/K number at most :data:`MAX_ROWS` (half that at head dim
    256) and q starts on a 16-byte boundary (``aligned``; the pool planes must, on both
    routes); the pair otherwise. A pure function of its arguments."""
    rows = T * (H // K)
    max_rows = MAX_ROWS if hd < 256 else MAX_ROWS // 2
    if (bf16 and aligned and page_size >= 8 and page_size & (page_size - 1) == 0
            and rows <= max_rows):
        return PagedPlan("cluster", cluster_blocks(B, K, MP, page_size, sms))
    return PagedPlan("pair", 0)


def lane_tiles(pos0: int, T: int, MP: int, page_size: int, window: int,
               blocks: int, tile: int = TILE_SLOTS) -> list[range]:
    """The tiles (indices of ``tile``-slot tiles from slot 0) that each block of a lane's
    cluster walks, in rank order: the lane's live range — the tiles that hold a slot in
    ``[max(0, pos0 - window + 1) if window else 0, min(pos0 + T, MP * page_size))`` — cut
    into contiguous shares of ``ceil(n / blocks)`` tiles; the blocks past the last share
    get none (and only meet the cluster's barriers). With the pair's chunk as ``tile``
    and a block per chunk, the pair's split."""
    end = max(0, min(pos0 + T, MP * page_size))
    first = max(0, pos0 - window + 1) if window > 0 else 0
    t0 = first // tile
    n = max(0, -(-(end - t0 * tile) // tile))
    per = -(-n // blocks)
    return [range(t0 + min(n, z * per), t0 + min(n, (z + 1) * per)) for z in range(blocks)]


def gather_pages(pool: dict, name: str, tables: torch.Tensor, length: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Dense ``[B, length, K, hd]`` view of pool plane ``name`` through block tables
    ``[B, MP]`` — sentinel entries clamp to a real page (callers mask those slots).
    int8 planes dequantize against their scale pages."""
    plane = pool[name]
    P, ps = plane.shape[0], plane.shape[1]
    ids = tables.clamp(max=P - 1).long()
    B, MP = ids.shape
    x = plane[ids].reshape(B, MP * ps, *plane.shape[2:])[:, :length]
    if f"{name}_scale" in pool:
        scale = pool[f"{name}_scale"][ids]
        scale = scale.reshape(B, MP * ps, *scale.shape[3:])[:, :length]
        return x.to(dtype) * scale.to(dtype)
    return x.to(dtype)


def paged_attention_reference(q, pool, tables, positions, valid, *, page_size,
                              sm_scale, window: int = 0, softcap: float = 0.0):
    """Plain version: q ``[B,T,H,hd]`` against the paged pool via gather — the same
    math as the dense cached-attention path (GQA contraction against the unrepeated
    cache, fp32 softmax, probs cast to q's dtype before PV). ``positions`` ``[B]`` is
    each lane's first query position; ``valid`` ``[B,C]`` marks live cache slots.

    A query row that sees no key outputs zeros, as the kernel's does (the Pallas
    kernel's ``l == 0`` rule); the dense cached attention, and the JAX package's
    reference, give such a row a uniform softmax instead. Rows that see a key are
    unaffected."""
    B, T, H, hd = q.shape
    C = valid.shape[1]
    ck = gather_pages(pool, "k", tables, C, q.dtype)
    cv = gather_pages(pool, "v", tables, C, q.dtype)
    K = ck.shape[2]
    G = H // K
    qg = q.reshape(B, T, K, G, hd)
    scores = torch.einsum("btkgd,bckd->bkgtc", qg, ck) * sm_scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = positions.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    slots = torch.arange(C, device=q.device)[None, None, :]
    causal = slots <= q_pos[:, :, None]                                   # [B,T,C]
    if window:
        causal = causal & (slots > q_pos[:, :, None] - window)
    mask = (causal & valid[:, None, :])[:, None, None, :, :]              # [B,1,1,T,C]
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0).to(q.dtype)
    return torch.einsum("bkgtc,bckd->btkgd", probs, cv).reshape(B, T, H, hd)


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_launch.argtypes = (
            [vp] * 11 + [ci] * 9 + [cf, ci, cf, ci, ci, ci, vp]
        )
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_chunk.argtypes = [ci, ci]
        lib.paged_attention_chunk.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci]
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention_cuda(q, pool, tables, positions, valid, *, page_size, sm_scale,
                         window: int = 0, softcap: float = 0.0):
    """Launch the CUDA kernel (:func:`paged_attention`'s contract) that
    :func:`paged_plan` chooses: the cluster kernel, or the partial + combine pair.
    Raises ``ValueError`` for anything it does not take: tensors off CUDA (the CPU
    included), mixed devices, non-contiguous tensors, q not fp32/bf16, a pool neither of
    q's dtype nor int8, a head dim outside 32/64/128/256, pool planes off 16-byte
    boundaries, or, on the pair, more shared memory than a block may use;
    ``RuntimeError`` when the launch fails."""
    B, T, H, hd = q.shape
    P, ps, K = pool["k"].shape[0], pool["k"].shape[1], pool["k"].shape[2]
    quantized = "k_scale" in pool
    MP, C = tables.shape[1], valid.shape[1]
    tensors = [q, pool["k"], pool["v"], tables, positions, valid]
    if quantized:
        tensors += [pool["k_scale"], pool["v_scale"]]
    _check(q.device.type == "cuda", f"tensors must be on CUDA, got {q.device}")
    _check(all(t.device == q.device for t in tensors), "all tensors must share q's device")
    _check(all(t.is_contiguous() for t in tensors), "all tensors must be contiguous")
    _check(ps == page_size, f"pool page_size {ps} != page_size argument {page_size}")
    _check(H % K == 0, f"H={H} must be a multiple of KV heads K={K}")
    _check(q.dtype in (torch.float32, torch.bfloat16), f"q dtype {q.dtype}")
    kv_dtype = pool["k"].dtype
    _check(pool["v"].dtype == kv_dtype and kv_dtype in (q.dtype, torch.int8),
           f"pool dtype {kv_dtype} with q dtype {q.dtype}")
    _check(quantized == (kv_dtype == torch.int8), "int8 pools need k_scale/v_scale")
    _check(hd in _HEAD_DIMS, f"head dim {hd} not in {_HEAD_DIMS}")
    _check(tuple(pool["v"].shape) == tuple(pool["k"].shape) and pool["k"].shape[3] == hd,
           "pool planes must be [P, page_size, K, hd]")
    if quantized:
        for name in ("k_scale", "v_scale"):
            _check(tuple(pool[name].shape) == (P, ps, K, 1)
                   and pool[name].dtype == torch.float32, f"{name} must be fp32 [P,ps,K,1]")
    _check(tables.dtype == torch.int32 and tuple(tables.shape) == (B, MP), "tables [B,MP] int32")
    _check(positions.dtype == torch.int32 and tuple(positions.shape) == (B,),
           "positions [B] int32")
    _check(valid.dtype == torch.bool and valid.shape[0] == B and C <= MP * ps,
           "valid [B,C] bool with C <= MP*page_size")
    lib = _lib()
    R = T * (H // K)
    q_code, kv_code = _DTYPE_CODE[q.dtype], _DTYPE_CODE[kv_dtype]
    out = torch.empty_like(q)
    part_acc = part_ml = None
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    _check(pool["k"].data_ptr() % 16 == 0 and pool["v"].data_ptr() % 16 == 0,
           "the pool planes must start on 16-byte boundaries")
    plan = paged_plan(q.dtype == torch.bfloat16, B, T, H, K, hd, ps, MP, _sm_count(index),
                      q.data_ptr() % 16 == 0)
    if plan.route == "pair":
        smem = lib.paged_attention_smem_bytes(R, hd, kv_code)
        _check(smem <= _SMEM_LIMIT, f"{smem} bytes of shared memory for T*H/K={R}")
        S = -(-(MP * ps) // lib.paged_attention_chunk(hd, kv_code))  # key chunks per lane
        part_acc = torch.empty((B, K, S, R, hd), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, K, S, R, 2), dtype=torch.float32, device=q.device)
    scale_k = pool["k_scale"].data_ptr() if quantized else None
    scale_v = pool["v_scale"].data_ptr() if quantized else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), pool["k"].data_ptr(), pool["v"].data_ptr(), scale_k, scale_v,
            tables.data_ptr(), positions.data_ptr(), valid.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), out.data_ptr(),
            B, T, H, K, hd, P, ps, MP, C, float(sm_scale), int(window), float(softcap),
            q_code, kv_code, plan.blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():  # a captured call launches nothing
        paged_attention.launches += 1
        if plan.route == "pair" and q.dtype == torch.bfloat16:
            paged_attention.launches_ragged += 1
    return out


def paged_attention(q, pool, tables, positions, valid, *, page_size, sm_scale,
                    window: int = 0, softcap: float = 0.0):
    """Paged-attention decode: q ``[B,T,H,hd]`` against pool pages through block tables.

    - ``pool``: ``{"k","v": [P, page_size, K, hd]}`` (+ ``k_scale``/``v_scale``
      ``[P, page_size, K, 1]`` fp32 when int8).
    - ``tables`` ``[B, MP]`` int32: physical page per logical page (sentinel == P for
      unallocated entries — clamped for the read, masked by ``valid``).
    - ``positions`` ``[B]`` int32: the lane's first query position (query t sits at
      ``positions[b] + t``); ``valid`` ``[B, C]`` bool marks live cache slots.

    Returns ``[B, T, H, hd]`` in q's dtype. CPU tensors run
    :func:`paged_attention_reference`; any other tensors go to
    :func:`paged_attention_cuda`, which launches the kernel or raises."""
    if q.device.type == "cpu":
        ps, K = pool["k"].shape[1], pool["k"].shape[2]
        if ps != page_size:
            raise ValueError(f"pool page_size {ps} != page_size argument {page_size}")
        if q.shape[2] % K:
            raise ValueError(f"H={q.shape[2]} must be a multiple of KV heads K={K}")
        return paged_attention_reference(
            q, pool, tables, positions, valid, page_size=page_size,
            sm_scale=sm_scale, window=window, softcap=softcap,
        )
    return paged_attention_cuda(q, pool, tables, positions, valid, page_size=page_size,
                                sm_scale=sm_scale, window=window, softcap=softcap)


#: Kernel launches since the count was last reset (one per call that launched a kernel,
#: either route; CPU calls, and calls captured into a CUDA graph, are not counted: a
#: graph's launches are its kernel nodes times its replays, ``utils/cuda_graph.py``). ``launches_ragged`` counts the bf16 calls
#: among them that took the pair (shapes outside the cluster kernel's rules).
paged_attention.launches = 0
paged_attention.launches_ragged = 0
