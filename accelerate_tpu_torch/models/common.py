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
cross-entropy kernels on CUDA tensors (their plain versions on the CPU) in one process; with more than one
process it runs the chunked CE, as the JAX dispatcher falls through on a multi-device
mesh. ``fused_tp`` and ``fused_dp`` run under a process mesh (``parallel.mesh.
mesh_context``): tokens are sharded over the batch axes, and every branch's sum is
summed over the batch ranks (``replica_sum``). Caches are plane
dicts: ``k``/``v`` ``[B,C,heads,hd]`` (dense) or ``[P,page_size,heads,hd]`` (paged
pool), plus ``k_scale``/``v_scale`` ``[...,1]`` fp32 when int8-quantized.

JAX arrays are immutable and the JAX engine donates its cache; here the writers update
the planes IN PLACE and return them, so a cache is never copied per step. JAX scatter
semantics are reproduced with fixed-shape writes that never wait on the host (no
boolean-mask indexing), so a decode step can be captured into a CUDA graph:
out-of-range per-row writes and writes through the sentinel page id are DROPPED
(:func:`put_or_drop`: each dropped entry writes a slot with the bytes that slot ends up
holding anyway, so no writer races another), and a scalar-start slice write CLAMPS its
start like ``lax.dynamic_update_slice`` (the start may be a device tensor).

:func:`multi_step_decode` runs N cached decode steps with the lane-freezing carry of
the JAX super-step, and :func:`spec_multi_step_decode` N speculative draft → verify →
accept rounds; on CUDA the serving engine and ``generation.generate_loop`` replay such
steps from a CUDA graph (``utils/cuda_graph.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.fused_xent import fused_cross_entropy, fused_cross_entropy_tp
from ..ops.paged_attention import gather_pages, paged_attention
from ..parallel.mesh import current_mesh
from ..parallel.tp import replica_sum
from ..utils.constants import BATCH_AXES, TENSOR_AXIS

__all__ = [
    "remat_wrap", "attention_dispatch",
    "resolve_loss_chunk", "chunked_ce", "ce_sum", "ce_sum_dispatch",
    "fused_ce_allowed", "fused_ce_single_shard",
    "kv_planes", "quant_kv", "put_or_drop", "write_kv", "read_kv",
    "paged_kv_planes", "write_kv_paged", "read_kv_paged", "paged_write_coords",
    "paged_attention_dispatch", "multi_step_decode", "spec_multi_step_decode",
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
    """SUM-style CE dispatch over ``loss_impl``, the one place every ``loss_impl`` routes
    through. ``auto`` takes :func:`ce_sum`; ``fused`` the fused linear + CE kernels
    (:func:`fused_ce_single_shard`, converted back to a sum) in one process, and
    :func:`ce_sum` in more than one (as the JAX dispatcher falls through on a
    multi-device mesh). Under a mesh (:func:`parallel.mesh.current_mesh`) x, targets
    and mask are this rank's slice of the batch and the sum is taken over every batch
    rank (``replica_sum``: its gradient is scaled for the train step's average over
    those ranks):

    - ``fused_tp``: ``head`` is this rank's vocab slice ``[D, V/tp]``; the vocab-sharded
      kernel runs on it and merges over the tp group
      (``ops.fused_xent.fused_cross_entropy_tp``);
    - ``fused_dp``: the single-shard kernel on this rank's tokens against a replicated
      head (the train step's average over the batch ranks gives the head's gradient).

    Both raise ``ValueError`` outside a mesh context, as in JAX. The chunked CE runs over
    a whole head only: under a tp-sharded head it raises ``NotImplementedError``. The
    fused kernels have no bias term, so a non-None ``bias`` takes :func:`ce_sum`
    whatever ``loss_impl`` says."""
    if loss_impl not in ("auto", "fused", "fused_dp", "fused_tp"):
        raise ValueError(f"loss_impl={loss_impl!r}: expected 'auto', 'fused', 'fused_dp', "
                         "or 'fused_tp' (a typo would otherwise silently run the chunked path)")
    if bias is not None:
        loss_impl = "auto"
    mesh = current_mesh()
    if loss_impl in ("fused_tp", "fused_dp") and mesh is None:
        raise ValueError(
            f"loss_impl={loss_impl!r} needs an active mesh context "
            "(Accelerator.build_train_step provides one; or wrap in parallel.mesh.mesh_context).")
    tp = mesh.group(TENSOR_AXIS) if mesh is not None else None
    B, S, D = x.shape
    if loss_impl == "fused_tp":
        nll = fused_cross_entropy_tp(x.reshape(B * S, D), head.to(dtype),
                                     targets.reshape(B * S), group=tp, softcap=softcap)
        total = (nll * mask.reshape(B * S)).sum()
    elif tp is not None:
        raise NotImplementedError(
            f"loss_impl={loss_impl!r} over a tp-sharded head is not ported: the chunked CE "
            "and the fused_dp kernel take the whole head; use loss_impl='fused_tp'")
    elif loss_impl == "fused_dp":
        nll = fused_cross_entropy(x.reshape(B * S, D), head.to(dtype), targets.reshape(B * S),
                                  softcap=softcap)
        total = (nll * mask.reshape(B * S)).sum()
    else:
        loss = None
        if loss_impl == "fused":
            loss = fused_ce_single_shard(x, head.to(dtype), targets, mask, softcap=softcap)
        if loss is not None:
            # The masked mean, back to a sum: every branch here returns a sum.
            total = loss * torch.clamp(mask.sum(), min=1.0)
        else:
            total = ce_sum(x, head, targets, mask, dtype=dtype, chunk=chunk,
                           softcap=softcap, bias=bias)
    if mesh is not None:
        total = replica_sum(total, mesh.group(BATCH_AXES))
    return total


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


def put_or_drop(dst: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor, vals,
                keep: torch.Tensor) -> None:
    """``dst[i0[m], i1[m]] = vals[m]`` IN PLACE for the entries ``m`` where ``keep``
    (flat ``[M]`` indices, ``vals`` ``[M, ...]`` in ``dst``'s dtype); the others are
    DROPPED, as JAX's out-of-bounds scatter drops them, where their indices may be out
    of range. The write keeps a fixed shape and never waits on the host: a dropped
    entry writes the slot and the bytes of the first live entry (which that entry
    writes too), or, when none is live, slot (0, 0) back with the bytes it holds — every
    writer of a slot writes the same bytes, so nothing races."""
    first = keep.to(torch.int32).argmax().reshape(1)  # 0 when none is live
    live = keep.any()
    i0 = torch.where(keep, i0, torch.where(live, i0.index_select(0, first), 0))
    i1 = torch.where(keep, i1, torch.where(live, i1.index_select(0, first), 0))
    fill = torch.where(live, vals.index_select(0, first), dst[0:1, 0])
    dst[i0, i1] = torch.where(keep.reshape(-1, *([1] * (vals.dim() - 1))), vals, fill)


def write_kv(kv: dict, name: str, val: torch.Tensor, index: Union[int, torch.Tensor]) -> dict:
    """Write ``val`` [B,T,...] into cache plane ``name`` IN PLACE at ``index`` — a
    scalar start slot for all rows (an int or a 0-d tensor, clamped into range as
    ``dynamic_update_slice`` does) or a per-row vector ``[B]`` (row b's tokens land at
    ``index[b] .. index[b]+T-1``; slots past the cache end are dropped,
    :func:`put_or_drop`) — quantizing when the cache is int8. Returns the written
    planes. No path waits on the host."""
    out = {}
    for key, plane in _planes(kv, name, val):
        dst = kv[key]
        B, T = plane.shape[0], plane.shape[1]
        C = dst.shape[1]
        if not torch.is_tensor(index):
            start = min(max(int(index), 0), C - T)
            dst[:, start:start + T] = plane.to(dst.dtype)
        elif index.dim() == 0:
            slots = index.long().clamp(0, C - T) + torch.arange(T, device=dst.device)
            dst.index_copy_(1, slots, plane.to(dst.dtype))
        else:
            slots = (index.long()[:, None] + torch.arange(T, device=dst.device)).reshape(-1)
            rows = torch.arange(B, device=dst.device).repeat_interleave(T)
            put_or_drop(dst, rows, slots, plane.reshape(B * T, *plane.shape[2:]).to(dst.dtype),
                        slots < C)
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
    quantization as :func:`write_kv`). Sentinel page ids (== num_pages) are DROPPED
    (:func:`put_or_drop`) — stale/unallocated table entries never corrupt another
    lane's pages."""
    out = {}
    pg, off = pages.reshape(-1).long(), offs.reshape(-1).long()
    for key, plane in _planes(kv, name, val):
        dst = kv[key]
        put_or_drop(dst, pg, off, plane.reshape(pg.shape[0], *plane.shape[2:]).to(dst.dtype),
                    pg < dst.shape[0])
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


def multi_step_decode(forward_one: Callable, cache, tokens: torch.Tensor,
                      positions: torch.Tensor, active: torch.Tensor, budgets: torch.Tensor,
                      eos_ids: torch.Tensor, select_token: Callable, xs, n_steps: int,
                      max_len: int):
    """N cached decode steps with the JAX super-step's carry ``(tokens, positions,
    done, count)`` — the loop both ``forward_slots_multi`` callers share, written with
    fixed shapes and no host reads so that a CUDA graph can hold all N steps.

    Per step the carried ``tokens`` [B] int32 (each lane's PENDING token — emitted by
    the previous step but not yet written, the engine's host-loop invariant) are
    written and attended at ``positions`` through ``forward_one(cache, tokens,
    write_pos) -> (logits [B,V], cache)``; ``select_token(logits, xs[j])`` picks one new
    token per lane (``xs`` None: ``select_token(logits, None)``); EOS and budget masking
    freeze finished lanes: a frozen lane writes at ``max_len``, so the dense write and
    the paged sentinel route both DROP it — which is also why a finishing lane's last
    token is never written, as in the N = 1 loop, where the engine frees the lane first.

    ``active`` bool [B] marks live lanes (idle lanes start frozen and never write;
    their host position stays put). ``budgets`` int32 [B] is each lane's REMAINING
    token budget; ``eos_ids`` int32 [B] uses -1 for "no EOS".

    Returns ``(cache, tok_buf [N, B] int32, counts [B] int32, logits [B, V])``: the
    token buffer is step-major (drain order), ``counts[b]`` how many of lane b's rows
    are real emissions (its final position is ``positions[b] + counts[b]``), and
    ``logits`` the last step's (the JAX function returns the first three)."""
    done = ~active
    count = torch.zeros_like(tokens, dtype=torch.int32)
    tok, pos = tokens.to(torch.int32), positions.to(torch.int32)
    rows, logits = [], None
    for j in range(n_steps):
        write_pos = pos.masked_fill(done, max_len)
        logits, cache = forward_one(cache, tok, write_pos)
        nxt = select_token(logits, None if xs is None else xs[j]).to(torch.int32)
        nxt = torch.where(done, tok, nxt)
        emit = ~done
        count = count + emit.to(torch.int32)
        hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
        done = done | (emit & (hit_eos | (count >= budgets)))
        pos = torch.where(emit, pos + 1, pos)
        tok = nxt
        rows.append(nxt)
    return cache, torch.stack(rows), count, logits


def spec_multi_step_decode(forward_verify: Callable, propose: Callable, select_ref: Callable,
                           cache, tokens: torch.Tensor, positions: torch.Tensor,
                           active: torch.Tensor, budgets: torch.Tensor,
                           eos_ids: torch.Tensor, noise_tab, history: torch.Tensor,
                           hist_lens: torch.Tensor, n_steps: int, spec_k: int,
                           max_len: int):
    """N speculative rounds (draft → verify → accept) with the JAX super-step's carry
    ``(cache, history, hist_lens, tokens, positions, done, count, proposed, accepted)``,
    written like :func:`multi_step_decode` (fixed shapes, no host reads) so that a CUDA
    graph can hold all N rounds.

    Per round: ``propose(history, hist_lens) -> [B, k]`` drafts from the carried token
    history; the pending ``tokens`` and the proposals form the ``[B, k+1]`` verify
    sequence, written and attended at ``positions`` through ``forward_verify(cache, seq,
    write_pos) -> (logits [B, k+1, V], cache)``; ``select_ref(logits, noise) -> [B, k+1]``
    picks the reference tokens (argmax for greedy lanes, the replayed draw for sampled
    lanes); acceptance is ``generation.speculative_prefix_accept``.

    JAX's key cursor becomes a NOISE cursor: ``noise_tab`` [B, R, V] (R ≥ N·(k+1)) holds
    each lane's Gumbel noise rows of its next R emissions, and the carried ``count`` is
    the cursor, so round r of lane b reads rows ``count[b] .. count[b]+k`` — the rows the
    host loop's replay round reads at the same point, since ``len(req.tokens)`` grows by
    the same per-lane ``n_emit``. ``noise_tab`` None (every lane greedy) passes None.

    A frozen lane writes at ``max_len`` (dropped); rejected drafts leave K/V above the
    accepted prefix, hidden by the causal mask until the next round's window, which
    starts at the first such slot, overwrites it. Accepted emissions are appended to a
    copy of ``history`` inside the loop (columns past ``n_emit`` drop), so round r+1
    drafts from round r's tokens.

    Returns ``(cache, tok_buf [N, B, k+1], emits [N, B], counts [B], proposed [B],
    accepted [B], logits)``: ``tok_buf[r, b, :emits[r, b]]`` are lane b's emissions of
    round r (drain round-major, lane-minor), ``counts`` the per-lane totals,
    ``proposed``/``accepted`` the accept-rate counters, and ``logits`` the last round's
    ``[B, k+1, V]`` (the JAX function returns the first six)."""
    from ..generation import speculative_prefix_accept

    B, S = history.shape
    k1 = spec_k + 1
    dev = tokens.device
    cols = torch.arange(k1, dtype=torch.int32, device=dev)[None, :]
    rows = torch.arange(B, device=dev).repeat_interleave(k1)
    done = ~active
    zeros = torch.zeros_like(tokens, dtype=torch.int32)
    count, proposed, accepted = zeros, zeros, zeros
    hist, lens = history.clone(), hist_lens.to(torch.int32)
    tok, pos = tokens.to(torch.int32), positions.to(torch.int32)
    refs, emits, logits = [], [], None
    for _ in range(n_steps):
        live = ~done
        props = propose(hist, lens)
        seq = torch.cat([tok[:, None], props.to(torch.int32)], dim=1)
        write_pos = pos.masked_fill(done, max_len)
        logits, cache = forward_verify(cache, seq, write_pos)
        noise = None
        if noise_tab is not None:
            # The clamp only guards the table's edge: a live lane never reads past row
            # N·(k+1) - 1.
            ni = torch.clamp(count[:, None] + cols, 0, noise_tab.shape[1] - 1).long()
            noise = torch.gather(noise_tab, 1,
                                 ni[:, :, None].expand(B, k1, noise_tab.shape[2]))
        ref = select_ref(logits, noise).to(torch.int32)
        n_emit, last, hit_eos, n_acc = speculative_prefix_accept(
            props, ref, live, budgets - count, eos_ids)
        # This round's emissions append to the drafting history (columns past n_emit,
        # and past the history's end, drop).
        wi = (lens[:, None] + cols).reshape(-1).long()
        keep = ((cols < n_emit[:, None]).reshape(-1)) & (wi < S)
        put_or_drop(hist, rows, wi, ref.reshape(-1), keep)
        lens = lens + n_emit
        tok = torch.where(n_emit > 0, last, tok)
        count = count + n_emit
        pos = pos + n_emit
        done = done | (live & (hit_eos | (count >= budgets)))
        proposed = proposed + torch.where(live, spec_k, 0).to(torch.int32)
        accepted = accepted + n_acc
        refs.append(ref)
        emits.append(n_emit)
    return (cache, torch.stack(refs), torch.stack(emits), count, proposed, accepted,
            logits)
