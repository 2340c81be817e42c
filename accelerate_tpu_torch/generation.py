"""Sampling and the one-request decode loop: decode-time knobs, the filtered
categorical draw, and prefill + cached decode steps.

Counterpart of ``GenerationConfig``, ``filtered_logits``, ``sampling_core``,
``sampling_core_dyn_k``, ``speculative_accept(_batch)``, ``speculative_prefix_accept``,
``sample_logits`` and ``generate_loop`` in ``accelerate_tpu/generation.py``. JAX
threads ``jax.random`` keys; the port draws from ``torch.Generator``s. The two give
different numbers for the same seed, so a sampled token stream (and a speculative
accept/reject) matches the JAX one in distribution, not draw for draw.

The draw is Gumbel-max over the filtered logits (what ``jax.random.categorical``
does). Its noise comes from a CPU generator (:func:`gumbel_noise`) and is then moved
to the logits' device, so the same generator state draws the same token on the CPU
and on the card. Code that replays decode steps from a CUDA graph draws the noise of
the steps ahead on the host and uploads it once (the serving engine's super-step,
:func:`generate_loop`); :func:`sampling_core_dyn_k` then filters with per-row
temperature, top-p and top-k tensors, bitwise what :func:`filtered_logits` gives each
row.

:func:`generate_loop` runs on the CPU eagerly; on the card its decode steps are one
step captured into a CUDA graph and replayed with the token fed back on the device
(``utils/cuda_graph.py``), and the host reads the tokens once, at the end; the graph
is kept for later calls on the same params and cache.

What later calls reuse lives in one cache bounded in bytes (:data:`GENERATE_CACHE_BYTES`,
least recently used evicted first): ``llama.generate``'s (prefill, decode) pairs with
the KV caches they hold, and on CUDA the decode graphs with their state (the cache,
noise, output) and private pools. :func:`release_generate_caches` empties it
(``Accelerator.free_memory`` calls it; JAX's counterpart is ``jax.clear_caches()``).
Two calls that share a pair share its cache, so ``generate`` is not re-entrant where
JAX's is functional.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from .utils.cuda_graph import CapturedStep
from .utils.tree import tree_leaves

__all__ = ["GenerationConfig", "filtered_logits", "filtered_logits_dyn_k", "sampling_core",
           "sampling_core_dyn_k", "speculative_accept", "speculative_accept_batch",
           "speculative_prefix_accept", "accept_draws",
           "sample_logits", "gumbel_noise", "emission_generator", "generate_loop",
           "GENERATE_CACHE_BYTES", "cache_lookup", "cache_store", "held_bytes",
           "release_generate_caches"]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode-time knobs (the transformers ``GenerationConfig`` analog)."""

    max_new_tokens: int = 128
    temperature: float = 0.0  # 0.0 → greedy (argmax)
    top_k: int = 0            # 0 → disabled
    top_p: float = 1.0        # 1.0 → disabled
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def _scaled(logits: torch.Tensor, temperature) -> torch.Tensor:
    """fp32 ``logits / temperature`` as a true division on every device: a Python
    temperature becomes a 0-d tensor on the logits' device (CUDA multiplies by the
    reciprocal of a host scalar instead, which can differ in the last bit), so the
    scalar and the per-row tensor temperatures give the same bits."""
    if not torch.is_tensor(temperature):
        temperature = torch.full((), temperature, dtype=torch.float32, device=logits.device)
    return logits.float() / temperature


def _nucleus(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Top-p filter of fp32 ``logits`` [.., V]: keep the smallest prefix of the sorted
    distribution whose cumulative probability reaches ``top_p`` (always keeping the
    best token); ``top_p`` a number or a tensor that broadcasts as ``[.., 1]``."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < top_p
    threshold = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, -torch.inf, logits)


def filtered_logits(logits: torch.Tensor, temperature, top_p, top_k: int,
                    apply_top_p: bool = True) -> torch.Tensor:
    """Temperature / top-k / top-p filtered logits [.., V] fp32 (filtered entries -inf).
    Top-p keeps the smallest prefix of the sorted distribution whose cumulative
    probability reaches ``top_p`` (always keeping the best token)."""
    logits = _scaled(logits, temperature)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if apply_top_p:
        logits = _nucleus(logits, top_p)
    return logits


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Gumbel noise of ``shape`` from CPU ``generator`` (fp32, on the CPU): the noise
    :func:`sampling_core` adds to the filtered logits."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sampling_core(logits: torch.Tensor, generator: torch.Generator, temperature, top_p,
                  top_k: int, apply_top_p: bool = True) -> torch.Tensor:
    """One categorical draw per row of ``logits`` [.., V] from the filtered
    distribution → int64 token ids [..]. ``generator`` is a CPU generator: the Gumbel
    noise is drawn on the CPU and moved to the logits' device.

    The nucleus filter runs whenever ``apply_top_p`` is true, at ``top_p = 1.0`` too,
    as the JAX engine's draw does: where the fp32 cumulative sum reaches 1.0 before the
    tail ends, the tail tokens past that point are masked on both sides."""
    filt = filtered_logits(logits, temperature, top_p, top_k, apply_top_p)
    return torch.argmax(filt + gumbel_noise(filt.shape, generator).to(filt.device), dim=-1)


def filtered_logits_dyn_k(logits: torch.Tensor, temperature: torch.Tensor,
                          top_p: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """:func:`filtered_logits` (nucleus filter on) with per-row ``temperature``,
    ``top_p`` and ``top_k`` tensors (shape ``logits.shape[:-1]``; ``top_k`` 0 disables),
    bitwise :func:`filtered_logits` of each row with that row's knobs: the k-th
    threshold is the (k−1)-th element of the descending sort — the value ``torch.topk``
    returns last (both exact selections) — the mask is gated by ``top_k > 0`` as the
    static path skips its branch, the division is the same true division
    (:func:`_scaled`), and the top-p block is the same function."""
    x = _scaled(logits, temperature[..., None])
    V = x.shape[-1]
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    k_idx = (top_k.long().clamp(1, V) - 1).expand(x.shape[:-1])[..., None]
    kth = torch.gather(sorted_desc, -1, k_idx)
    x = torch.where((top_k[..., None] > 0) & (x < kth), -torch.inf, x)
    return _nucleus(x, top_p[..., None])


def sampling_core_dyn_k(logits: torch.Tensor, noise: torch.Tensor, temperature, top_p,
                        top_k: torch.Tensor) -> torch.Tensor:
    """:func:`sampling_core` with per-row ``temperature``, ``top_p`` and ``top_k``
    tensors (:func:`filtered_logits_dyn_k`) and the Gumbel ``noise`` given
    (:func:`gumbel_noise`, logits' shape, on their device) → int64 token ids.

    The serving super-step samples every lane inside ONE captured program, so per-lane
    knobs cannot be Python numbers. Held bitwise against ``sampling_core`` across k,
    top-p and temperature in tests/test_torch_multistep_decode.py."""
    return torch.argmax(filtered_logits_dyn_k(logits, temperature, top_p, top_k) + noise,
                        dim=-1)


def accept_draws(generators, n: int, V: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(uniforms [n], Gumbel noise [n, V]) on ``device``: row i's uniform and then its
    noise drawn from ``generators[i]``, a CPU generator."""
    if len(generators) != n:
        raise ValueError(f"{len(generators)} generators for {n} rows")
    u = torch.empty((n,), dtype=torch.float32)
    noise = torch.empty((n, V), dtype=torch.float32)
    for i, g in enumerate(generators):
        u[i] = torch.rand((), generator=g, dtype=torch.float32)
        noise[i] = gumbel_noise((V,), g)
    return u.to(device), noise.to(device)


def speculative_accept_batch(p_probs: torch.Tensor, q_probs: torch.Tensor,
                             draft_tokens: torch.Tensor, generators):
    """N independent speculative-sampling accept/reject tests (Leviathan et al. 2022)
    at once: the draft proposed ``draft_tokens[i]`` from ``q_probs[i]``; the target
    distribution is ``p_probs[i]``. Row i accepts with probability min(1, p/q) and
    otherwise draws from the residual norm(max(p − q, 0)); each row's output is
    distributed exactly as its p. ``p_probs``/``q_probs`` [N, V], ``draft_tokens`` [N]
    → (accepted bool [N], tokens int32 [N]).

    ``generators``: one CPU generator per row (row i draws its uniform, then its Gumbel
    noise for the residual, from ``generators[i]``); the draws move to the
    probabilities' device. Where JAX splits each row's key in two,
    the port draws both from the row's generator in turn. An all-zero residual (p == q
    exactly; the draw is then unused) falls back to p, so the categorical never sees
    -inf everywhere."""
    p = p_probs.float()
    q = q_probs.float()
    n, V = p.shape
    drafts = torch.as_tensor(draft_tokens, device=p.device).long()
    u, noise = accept_draws(generators, n, V, p.device)
    p_tok = p.gather(1, drafts[:, None])[:, 0]
    q_tok = q.gather(1, drafts[:, None])[:, 0]
    ratio = p_tok / torch.clamp(q_tok, min=1e-30)
    accepted = u < torch.clamp(ratio, max=1.0)
    residual = torch.clamp(p - q, min=0.0)
    denom = residual.sum(dim=1, keepdim=True)
    safe = torch.where(denom > 0, residual / torch.clamp(denom, min=1e-30), p)
    resid_tok = torch.argmax(torch.log(torch.clamp(safe, min=1e-30)) + noise, dim=1)
    return accepted, torch.where(accepted, drafts, resid_tok).to(torch.int32)


def speculative_accept(p_probs: torch.Tensor, q_probs: torch.Tensor, draft_token,
                       generator: torch.Generator):
    """One accept/reject of :func:`speculative_accept_batch` (``p_probs``/``q_probs``
    [V], one CPU ``generator``, where JAX takes a key) → (accepted bool 0-d, token
    int32 0-d); the output is distributed exactly as p."""
    accepted, token = speculative_accept_batch(
        p_probs[None], q_probs[None], torch.as_tensor(draft_token).reshape(1), [generator])
    return accepted[0], token[0]


def speculative_prefix_accept(proposals: torch.Tensor, ref: torch.Tensor, live: torch.Tensor,
                              limits: torch.Tensor, eos_ids: torch.Tensor):
    """Batched greedy-prefix acceptance, the accept walk of the serving engine's
    speculative round as fixed-shape tensor ops (no host read, so a CUDA graph holds
    it). ``proposals`` [B, k] (the drafter's), ``ref`` [B, k+1] (the tokens the verify
    selected at each position), ``live`` bool [B], ``limits`` [B] (remaining budget:
    a round emits at most ``min(k+1, max(limits, 1))``), ``eos_ids`` [B] (-1: none).

    Per lane: the longest prefix where proposal j == ref j is accepted, and ref's next
    token (correction or bonus) follows it; the emissions are cut at the budget, then
    at the first EOS inclusive. Returns ``(n_emit int32 [B], last_tok int32 [B],
    hit_eos bool [B], n_accepted int32 [B])``: emissions (0 for dead lanes), the last
    emitted token (``ref[:, 0]`` where nothing is emitted), whether the round ended on
    the lane's EOS, and how many emissions were accepted proposals. Pure integer
    logic: equal to the JAX function's outputs."""
    k = proposals.shape[1]
    match = (proposals == ref[:, :k]).to(torch.int32)
    n_match = torch.cumprod(match, dim=1).sum(dim=1)
    m = torch.minimum(n_match + 1, torch.clamp(limits, min=1))
    is_eos = (eos_ids[:, None] >= 0) & (ref == eos_ids[:, None])
    within = torch.arange(k + 1, device=ref.device)[None, :] < m[:, None]
    hits = is_eos & within
    has_eos = hits.any(dim=1)
    first_eos = hits.to(torch.int32).argmax(dim=1)
    m = torch.where(has_eos, first_eos + 1, m)
    n_emit = torch.where(live, m, 0).to(torch.int32)
    last_idx = torch.clamp(n_emit - 1, 0, k).long()
    last_tok = ref.gather(1, last_idx[:, None])[:, 0]
    n_accepted = torch.minimum(n_match, n_emit).to(torch.int32)
    return n_emit, last_tok.to(torch.int32), has_eos & live, n_accepted


def sample_logits(logits: torch.Tensor, gen: GenerationConfig,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits [B, V] → int32 token ids [B] via greedy / temperature / top-k / top-p
    (``generator``: a CPU generator, where JAX takes a key)."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature sampling needs a generator")
    return sampling_core(logits, generator, gen.temperature, gen.top_p, gen.top_k,
                         apply_top_p=gen.top_p < 1.0).to(torch.int32)


def _sample_with_noise(logits: torch.Tensor, gen: GenerationConfig, noise) -> torch.Tensor:
    """:func:`sample_logits` with the draw's Gumbel ``noise`` given (None when greedy)."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filt = filtered_logits(logits, gen.temperature, gen.top_p, gen.top_k,
                           apply_top_p=gen.top_p < 1.0)
    return torch.argmax(filt + noise, dim=-1).to(torch.int32)


def emission_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator for emission ``index`` of a request seeded with ``seed`` — a
    fixed per-emission schedule, so a request's draws never depend on what else runs
    beside it."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint32)
    return torch.Generator().manual_seed(int(state[0]))


def _carry(dst, src) -> None:
    """Copy into ``dst`` (a nest of dicts, lists and tensors) each tensor of ``src``
    that is not already the same tensor: a decode step's state stays in the tensors a
    CUDA graph captured."""
    if isinstance(dst, dict):
        for k in dst:
            _carry(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _carry(d, s)
    elif torch.is_tensor(dst) and src is not dst:
        dst.copy_(src)


#: The bound, in bytes of device memory held, on what ``generate`` keeps between calls.
#: An entry stored past it evicts the least recently used others; it should exceed one
#: call's cache, graph pool and noise, or each call evicts the last one's.
GENERATE_CACHE_BYTES = 2 << 30

#: key -> (value, held), least recently used first; ``held(value)`` gives the tensors
#: the entry keeps alive and the bytes of its graph pool. Keys: ``("fns", config,
#: max_len)`` for ``llama.generate``'s (prefill, decode) pairs; ``("graph", decode
#: function, knobs, shapes, params' and cache's addresses)`` for a decode graph with its
#: state (in JAX, jit's cache of compiled programs).
_GEN_CACHE: OrderedDict = OrderedDict()


def cache_lookup(key):
    """The value cached under ``key`` (now the most recently used), or None."""
    entry = _GEN_CACHE.get(key)
    if entry is None:
        return None
    _GEN_CACHE.move_to_end(key)
    return entry[0]


def held_bytes(entries=None) -> int:
    """Device bytes the cache's entries hold: each tensor storage counted once (a pair's
    cache is also its decode graph's), plus the graphs' pools."""
    storages, pools = {}, 0
    for value, held in (entries if entries is not None else _GEN_CACHE.values()):
        tensors, pool = held(value)
        pools += pool
        for t in tensors:
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values()) + pools


def cache_store(key, value, held: Callable):
    """Cache ``value`` under ``key``, then evict least recently used entries (never this
    one) while the cache holds more than :data:`GENERATE_CACHE_BYTES`."""
    _GEN_CACHE[key] = (value, held)
    _GEN_CACHE.move_to_end(key)
    while len(_GEN_CACHE) > 1 and held_bytes() > GENERATE_CACHE_BYTES:
        _GEN_CACHE.popitem(last=False)
    return value


def release_generate_caches() -> None:
    """Drop every cached pair, cache and decode graph (their device memory returns to
    the allocator; ``torch.cuda.empty_cache()`` gives it back to the device)."""
    _GEN_CACHE.clear()
    generate_loop.last_step = None


def _graph_held(entry) -> tuple[list, int]:
    st, run = entry
    return [t for t in tree_leaves(st) if torch.is_tensor(t)], run.pool_bytes or 0


def _addresses(tree) -> tuple:
    """Device addresses of a tree's tensors (a quantized leaf: its codes and scales)."""
    out = []
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            out.append(leaf.data_ptr())
        elif dataclasses.is_dataclass(leaf):
            out.extend(t.data_ptr() for t in vars(leaf).values() if torch.is_tensor(t))
    return tuple(out)


def _decode_body(decode_fn: Callable, params, gen: GenerationConfig, st: dict) -> None:
    """One decode step over the loop's state ``st`` (in place): feed the pending token,
    sample the next (its noise row ``st["noise"][step]``), mask after EOS, write the
    emission into column ``step`` of ``st["out"]``, advance ``step``."""
    logits, new_cache = decode_fn(params, st["cache"], st["token"])
    _carry(st["cache"], new_cache)
    step = st["step"]
    nz = None if st["noise"] is None else st["noise"].index_select(0, step)[0]
    nxt = _sample_with_noise(logits, gen, nz)
    emitted = nxt
    if gen.eos_token_id is not None:
        emitted = torch.where(st["done"], torch.full_like(nxt, gen.pad_token_id), nxt)
        st["done"].logical_or_(nxt == gen.eos_token_id)
    st["out"].index_copy_(1, step, emitted[:, None])
    st["token"].copy_(nxt)
    step.add_(1)


def generate_loop(prefill_fn: Callable, decode_fn: Callable, params, prompt: torch.Tensor,
                  prompt_mask: torch.Tensor, gen: GenerationConfig,
                  seed: Optional[int] = None) -> torch.Tensor:
    """Prefill + ``max_new_tokens - 1`` cached decode steps.

    ``prefill_fn(params, prompt, prompt_mask) -> (last_logits [B,V], cache)`` and
    ``decode_fn(params, cache, token [B]) -> (logits [B,V], cache)``, the cache updated
    in place but for tensors the step returns anew (copied back into the first ones).
    ``prompt`` [B, S0] int, left-padded; ``prompt_mask`` [B, S0] bool (False on pads).
    Returns int32 ids [B, max_new_tokens] on the prompt's device; positions after an
    EOS are ``pad_token_id`` (the EOS itself is emitted).

    Emission t of every row draws its Gumbel noise from ``emission_generator(seed, t)``
    (``seed`` default 0, as JAX's default key); all of it is drawn on the host and
    uploaded once. On CUDA the decode step is a CUDA graph (``utils.cuda_graph``): its
    first run is eager and captures it, and every other step replays it, the token fed
    back on the device; the host reads nothing until the ids are returned. The graph is
    kept for later calls whose prefill returns the same cache tensors (:func:`cache_store`).
    A failed capture or replay raises."""
    T = gen.max_new_tokens
    last_logits, cache = prefill_fn(params, prompt, prompt_mask)
    B, V = last_logits.shape
    dev = last_logits.device
    seed = 0 if seed is None else int(seed)
    noise = None
    if gen.temperature > 0.0:
        noise = torch.stack([gumbel_noise((B, V), emission_generator(seed, t))
                             for t in range(T)]).to(dev)
    first = _sample_with_noise(last_logits, gen, None if noise is None else noise[0])
    done = (first == gen.eos_token_id if gen.eos_token_id is not None
            else torch.zeros((B,), dtype=torch.bool, device=dev))
    cuda = dev.type == "cuda"
    key = (("graph", decode_fn, gen, B, V, str(dev), _addresses(params), _addresses(cache))
           if cuda else None)
    entry = cache_lookup(key) if cuda else None
    if entry is None:
        st = {"cache": cache, "token": first.clone(), "done": done,
              "out": torch.empty((B, T), dtype=torch.int32, device=dev),
              "step": torch.ones((1,), dtype=torch.long, device=dev), "noise": noise}
        run = functools.partial(_decode_body, decode_fn, params, gen, st)
        if cuda:
            run = CapturedStep(run, dev)
            cache_store(key, (st, run), _graph_held)
    else:
        st, run = entry
        st["token"].copy_(first)
        st["done"].copy_(done)
        st["step"].fill_(1)
        if noise is not None:
            st["noise"].copy_(noise)
    st["out"][:, 0] = first
    for _ in range(T - 1):
        run()
    generate_loop.last_step = run if cuda else None
    return st["out"].clone()


#: The last call's decode runner on CUDA (a ``CapturedStep``: its graph's kernel nodes,
#: capture time, pool bytes and replays so far), None after a CPU call.
generate_loop.last_step = None
