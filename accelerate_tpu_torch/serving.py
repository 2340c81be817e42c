"""Continuous-batching inference engine (slot-based KV cache, per-slot positions).

Counterpart of ``accelerate_tpu/serving.py``'s ``ContinuousBatcher`` for the plain
decode path and its admission path, dense (``page_size=0``) and paged
(``page_size > 0``):

- ``max_slots`` decode lanes share one cache; each lane has its own write position.
- Admission prefills one row (``llama.forward_cached`` over a dense ``[1, max_len]``
  row cache) and copies it into the engine cache: into the lane's row (dense), or
  through the lane's block table into pool pages (paged). The prompt is left-padded
  to a whole number of ``prompt_bucket`` chunks, or, with ``prompt_buckets``, to the
  smallest rung of that ladder that fits it (one dispatch; prompts past the top rung
  fall back to chunks); with ``prefix_cache`` it is RIGHT-aligned in chunks instead
  and resumes from the longest registered full-chunk prefix: a clone of the row cache
  (dense) or a refcounted page list whose partial boundary page is copied on write
  (paged, ``paged_kv.BlockManager``). The registry is an LRU of ``prefix_cache``
  entries; under pool pressure it yields its pages before an admission defers.
- On the card every prefill program (a bucket rung, the first chunk and the chunk
  append, the prefix layout's full-logits and keep programs) is one CUDA graph per
  ``(program, width)``, its inputs in static row and mask buffers and its row cache
  one static buffer whose write index is a device tensor; the graphs share one
  memory pool (each replay's outputs are consumed before another prefill replays).
  ``warm_programs()`` captures every graph the engine can dispatch ahead of traffic.
- Each ``step()`` advances every lane one token with ONE batched forward
  (``llama.forward_slots`` / ``forward_slots_paged``); paged decode attention runs in
  the CUDA kernel ``ops/paged_attention.py`` on the card, over block tables whose
  lanes may share prefix pages.
- Paged admission allocates the lane's pages for prompt + budget up front (adopting a
  registered prefix's full pages read-only) and DEFERS in FIFO order when the pool is
  short, so no table entry appears during a multi-step super-step.
- ``decode_steps=N > 1`` runs N decode steps per dispatch (``llama.forward_slots_multi``:
  in-step sampling, EOS/budget masking and lane freezing) and drains the ``[N, B]``
  token buffer and the ``[B]`` counts with ONE host read; on the card the super-step
  is replayed from a CUDA graph per ``(N, sampled, paged)`` (``utils/cuda_graph.py``),
  its inputs in static tensors the host fills before each replay. Tokens are the
  N = 1 engine's, greedy and sampled: a sampled lane's Gumbel noise for its next N
  emissions is drawn on the host from the same per-emission generators and uploaded.

Params may hold quantized projection leaves (``ops.quantization.QuantizedWeight``,
int8 through its CUDA kernel on the card): the engine reads only the embedding's
device and leaves every weight to ``models.llama``.

The JAX engine donates its cache to jitted programs; this one updates the cache
tensors in place. Greedy output matches the JAX engine token for token at fp32 on the
CPU, and so do the prefix and bucket counters. Sampled requests take an integer
``seed``: emission ``i`` draws from a generator seeded from ``(seed, i)``
(``generation.emission_generator``), so a request's tokens do not depend on what else
is in the batch.

- ``spec_k=k > 0`` decodes speculatively: a ``spec_decode.DraftSource`` (default
  ``NgramDrafter``) proposes k tokens a lane, ONE target forward over ``[B, k+1]``
  (``llama.forward_slots``, dense or paged: kernel #1 at T = k+1 query rows a lane)
  verifies them, and each lane accepts a prefix (1..k+1 tokens a step). Greedy lanes
  accept by exact match with the verify's argmax; sampled lanes either REPLAY the
  target's own draw at each position with the noise rows of emissions ``len(tokens) ..
  len(tokens)+k`` (``spec_accept="replay"``: tokens bitwise ``spec_k=0``'s) or run the
  Leviathan accept/reject (``"residual"``: emission m draws its uniform and its
  residual noise from ``emission_generator(seed, m)``; lossless in distribution). On
  the card this host-loop step runs eagerly; it is the parity reference of the fused
  path. Rejected drafts leave K/V above each lane's position that the causal mask
  hides until the next step overwrites it; paged draft tails past a lane's pages route
  to the sentinel and drop (admission reserves only prompt + budget).
- ``spec_k > 0`` with ``decode_steps=N > 1``, replay acceptance and a resident drafter
  runs N draft → verify → accept rounds per dispatch (``llama.forward_slots_spec_multi``
  with the device n-gram proposer ``spec_decode.ngram_propose_resident``): on the card
  one CUDA graph per ``(N, k, max_ngram, sampled, paged)``, its inputs (history,
  tokens, positions, budgets, EOS ids, the ``[B, N·(k+1), V]`` noise table and the
  sampling knobs) in static buffers; a lane's noise cursor is its emission count, so
  its tokens are the host loop's, bitwise. One host read drains the round buffers.
  ``set_spec_enabled(False)`` falls back to the plain super-step (never N = 1).

Disaggregated roles (``role="prefill"|"decode"``, paged only): a prefill engine admits
and prefills on lanes freed the same step and exports each request's KV as a
:class:`KVHandoff` (the context pages move into the record, refcounts kept) instead of
decoding; a decode engine never prefills: ``adopt_handoff`` scatters a transferred page
block into pages of its own pool, adopts the full context pages read-only, copies the
boundary page on write, installs the lane's valid range from the handoff and decodes
from there, kernel #1 reading the adopted pages. The decode lane draws emission
``len(tokens)`` on, so its tokens are the mixed engine's, greedy and sampled.
``serving_gateway.DisaggRouter`` drives the pair. The handoff carries the request's
integer ``seed`` where the JAX record carries its ``rng`` key, and the exported block
holds the handoff's real pages only (the JAX gather is table-width, one compiled
program for every size).

The fault boundary (``faults``, ``step_timeout_s``, ``recover``): a
``resilience.FaultPlan`` fires seeded faults at ``serving.decode``, ``serving.prefill``
and ``serving.kv_admit``, each on the host before the launch it guards (``hang`` sleeps
there), and a ``StepWatchdog`` checks a dispatch's wall time after its one host read,
where the host first waits for the device. With recovery armed, a failed dispatch
quarantines the poison request (``failed = "step_fault:<kind>"``; by bisection over the
active lanes when the fault names no request), and a dispatch that may have touched the
device (a timeout, a real error) rebuilds the survivors: the cache is reset IN PLACE
(the same storage, which every captured graph reads at fixed addresses; the JAX engine
allocates a fresh one), a new ``BlockManager`` takes the pool, and each survivor is
re-admitted from its host record (prompt + emitted tokens) through the warmed prefill
programs, its sampled draws resuming at emission ``len(tokens)``. A ``crash`` fault
raises ``EngineCrashed`` past the boundary (``crashed`` set): the fleet router's
failover. A real CUDA error poisons the process's context: a rebuild cannot recover
from it, and the next launch raises it again.

``telemetry`` (any object with ``enabled`` and ``emit``) receives a ``serving/v1``
record a step, ``serving.kv/v1`` (paged), ``serving.spec/v1`` (speculative), fault and
recovery records and a ``serving.throughput/v1`` record from ``run(report_throughput=
True)``; ``tracer`` (``telemetry.Tracer``) gets the admit, prefill, decode and fault
spans of gateway-bound requests. Off, each costs two attribute reads a step: no clock
read, no record.

Not in this slice: the cross-family draft (``models/gpt.py`` is not ported) and the
compile cache itself (the JAX engine's ``compile_cache`` and its bucket ``ladder()``;
``warm_programs`` captures graphs in the process instead of filling an AOT cache).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np
import torch

from .compile_cache import pick_bucket
from .generation import (GenerationConfig, accept_draws, emission_generator, filtered_logits,
                         gumbel_noise, sampling_core, sampling_core_dyn_k,
                         speculative_accept_batch)
from .models import llama
from .paged_kv import BlockManager, KVBudgetError, pages_for
from .resilience.faults import EngineCrashed, StepWatchdog
from .spec_decode import ModelDrafter, NgramDrafter, ngram_propose_resident
from .telemetry.compile_monitor import compile_label
from .telemetry.schemas import (FAULT_SCHEMA, RECOVERY_SCHEMA, SERVING_KV_SCHEMA,
                                SERVING_SCHEMA, SERVING_SPEC_SCHEMA,
                                SERVING_THROUGHPUT_SCHEMA)
from .telemetry.slo import latency_summary
from .telemetry.steady import TELEMETRY_REV
from .utils.cuda_graph import CapturedStep

__all__ = ["ContinuousBatcher", "ENGINE_ROLES", "KVBudgetError", "KVHandoff", "Request",
           "normalize_submit"]

#: Engine roles: ``mixed`` prefills and decodes on the same lanes; ``prefill`` prefills
#: admitted requests and exports their KV as page-list handoffs instead of decoding;
#: ``decode`` never prefills: its work arrives as handoffs whose pages it adopts.
ENGINE_ROLES = ("mixed", "prefill", "decode")


def normalize_submit(prompt, max_new_tokens=None, eos_token_id=None, gen=None, seed=None):
    """Validate and normalize one ``submit()`` call's arguments →
    ``(prompt int32 [L], GenerationConfig)``: either ``max_new_tokens``/
    ``eos_token_id`` or a full ``gen`` (not both), a seed only with temperature
    sampling (and always with it), an integral positive budget, a non-empty prompt."""
    prompt = np.asarray(prompt, np.int32).ravel()
    if prompt.size == 0:
        raise ValueError("empty prompt: prefill needs at least one token")
    if gen is not None and (max_new_tokens is not None or eos_token_id is not None):
        raise ValueError("pass either gen= or max_new_tokens/eos_token_id, not both")
    if seed is not None and (gen is None or gen.temperature <= 0.0):
        raise ValueError(
            "seed was given but the request is greedy (no gen / temperature<=0): it "
            "would be silently ignored — pass gen=GenerationConfig(temperature=...)"
        )
    if gen is None:
        gen = GenerationConfig(
            max_new_tokens=32 if max_new_tokens is None else max_new_tokens,
            temperature=0.0, eos_token_id=eos_token_id,
        )
    mnt = gen.max_new_tokens
    if isinstance(mnt, bool) or not isinstance(mnt, (int, np.integer)):
        raise TypeError(f"max_new_tokens must be an int, got {type(mnt).__name__} ({mnt!r})")
    if mnt < 1:
        raise ValueError(f"max_new_tokens={mnt} must be >= 1 (the prefill emits the first token)")
    if gen.temperature > 0.0 and seed is None:
        raise ValueError("temperature sampling needs a per-request integer seed")
    return prompt, gen


@dataclasses.dataclass
class KVHandoff:
    """One prefilled request's transferable KV state, built by a prefill engine the
    step its prefill lands. The lane is freed at once, but its pages covering the
    context ``[0, prefill_len)`` move INTO this record (``BlockManager.detach_slot``:
    refcounts kept). A decode engine adopts them through
    :meth:`ContinuousBatcher.adopt_handoff` after ``ops.collectives.kv_page_transfer``
    moved the page block. The record keeps its pages on the SOURCE pool until the
    request is terminal, so a dead decode replica's request can adopt them again; the
    router then releases it (:meth:`ContinuousBatcher.release_handoff`)."""

    uid: int                      # source-engine request uid
    prompt: np.ndarray
    gen: GenerationConfig
    seed: Optional[int]           # sampled requests: emission i draws from (seed, i)
    tokens: list                  # already emitted (the prefill's first token)
    pages: np.ndarray             # [n] int32 source-pool page ids covering the context
    prefill_len: int              # next write position (= the adopted context length)
    valid_range: tuple            # (v0, v1): positions [v0, v1) hold real tokens


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    gen: GenerationConfig
    seed: Optional[int] = None  # sampled requests: emission i draws from (seed, i)
    #: Streaming hook: called as ``on_token(token_id)`` the moment each token is
    #: appended (prefill's first token included).
    on_token: Optional[Callable[[int], None]] = None
    # filled by the engine
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    enqueued_at: float = 0.0  # time.monotonic() at submit
    #: Machine-readable reason when the fault boundary quarantined this request
    #: (``step_fault:<kind>`` / ``prefill_fault:<kind>`` / ``recovery_unservable:<detail>``);
    #: None = never failed. A failed request is ``done`` with the tokens it got.
    failed: Optional[str] = None
    #: Times a rebuild re-admitted this request (each re-admission prefills prompt +
    #: emitted tokens).
    recoveries: int = 0
    #: Recovery context: prompt + emitted tokens, set when a rebuild requeues the
    #: request; the next admission prefills it instead of the prompt (and clears it).
    _recover_ctx: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    def _sample(self, logits_row: torch.Tensor) -> int:
        """This request's next token from a logits row [V] (first maximum when
        greedy; else the draw of emission ``len(tokens)``)."""
        if self.gen.temperature <= 0.0:
            return int(torch.argmax(logits_row))
        g = emission_generator(self.seed, len(self.tokens))
        return int(sampling_core(logits_row[None], g, self.gen.temperature,
                                 self.gen.top_p, self.gen.top_k)[0])


def _decode_step(params, cache, tokens, positions, cfg):
    """Advance every slot one token: (greedy [B], logits [B, V] fp32, cache)."""
    logits, cache = llama.forward_slots(params, tokens[:, None], cache, positions, cfg)
    logits = logits[:, -1, :]
    return torch.argmax(logits, dim=-1), logits, cache


def _decode_step_paged(params, cache, tables, tokens, positions, cfg, page_size: int):
    """:func:`_decode_step` over the PAGED cache: K/V writes route through each lane's
    block-table row into pool pages, attention reads through the paged dispatch (the
    CUDA kernel on the card, gather + the dense math on the CPU)."""
    logits, cache = llama.forward_slots_paged(
        params, tokens[:, None], cache, tables, positions, cfg, page_size
    )
    logits = logits[:, -1, :]
    return torch.argmax(logits, dim=-1), logits, cache


def _insert_row(cache, row_cache, slot: int):
    """Copy a single-row prefill cache into engine lane ``slot`` (in place)."""
    for planes, row in zip(cache["layers"], row_cache["layers"]):
        for key, plane in planes.items():
            plane[slot] = row[key][0]
    cache["valid"][slot] = row_cache["valid"][0]
    return cache


def _insert_row_paged(cache, row_cache, write_ids: np.ndarray, slot: int, page_size: int):
    """Copy a single-row prefill cache into pool pages (in place). ``write_ids`` [MP]
    maps the row's logical pages to physical pages; SENTINEL entries (pages past the
    row) are dropped — a lane never writes a page it does not own. ``slot`` clamps
    into range like ``dynamic_update_slice``."""
    valid = cache["valid"]
    num_pages = cache["layers"][0]["k"].shape[0]
    keep = write_ids < num_pages
    dev = valid.device
    dst = torch.as_tensor(write_ids[keep], dtype=torch.long, device=dev)
    src = torch.as_tensor(np.flatnonzero(keep), dtype=torch.long, device=dev)
    MP = write_ids.shape[0]
    for planes, row in zip(cache["layers"], row_cache["layers"]):
        for key, pool in planes.items():
            r = row[key][0]                                      # [C, ...]
            pad = MP * page_size - r.shape[0]
            if pad:
                r = torch.cat([r, r.new_zeros((pad, *r.shape[1:]))])
            pool[dst] = r.reshape(MP, page_size, *r.shape[1:])[src].to(pool.dtype)
    valid[min(max(slot, 0), valid.shape[0] - 1)] = row_cache["valid"][0]
    return cache


def _multi_select(sample: bool, noise, temps, top_ps, top_ks):
    """(select_token, xs) for the super-step's steps.

    ``sample=False`` (every live lane greedy) is the argmax ``_decode_step`` returns.
    ``sample=True`` takes each step's noise from ``noise`` [B, N, V] (xs: step j reads
    ``noise[:, j]``, lane b's Gumbel noise for its emission ``len(tokens) + j``, the
    noise :meth:`Request._sample` would draw at that emission) and draws every lane
    through ``sampling_core_dyn_k`` with its own temperature, top-p and top-k, bitwise
    the N = 1 draw. Greedy lanes ride along with a safe temperature of 1.0 and their
    draw discarded for the argmax."""
    if not sample:
        return (lambda logits, _: torch.argmax(logits, dim=-1)), None
    safe_temps = torch.where(temps > 0.0, temps, 1.0)

    def select_token(logits, step_noise):
        greedy = torch.argmax(logits, dim=-1)
        drawn = sampling_core_dyn_k(logits, step_noise, safe_temps, top_ps, top_ks)
        return torch.where(temps > 0.0, drawn, greedy)

    return select_token, noise.transpose(0, 1)


def _decode_multi_step(params, cache, tokens, positions, active, budgets, eos_ids, noise,
                       temps, top_ps, top_ks, cfg, n_steps: int, sample: bool):
    """``n_steps`` decode steps as one super-step → (tok_buf [N, B] int32, counts [B]
    int32, last step's logits [B, V], cache): sampling, EOS/budget masking and lane
    freezing happen inside (``llama.forward_slots_multi``); the host drains the token
    buffer once per super-step instead of once per token."""
    select_token, xs = _multi_select(sample, noise, temps, top_ps, top_ks)
    cache, tok_buf, counts, logits = llama.forward_slots_multi(
        params, cache, tokens, positions, active, budgets, eos_ids, select_token, xs,
        n_steps, cfg)
    return tok_buf, counts, logits, cache


def _decode_multi_step_paged(params, cache, tables, tokens, positions, active, budgets,
                             eos_ids, noise, temps, top_ps, top_ks, cfg, n_steps: int,
                             sample: bool, page_size: int):
    """:func:`_decode_multi_step` over the PAGED cache: every step's K/V writes route
    through the block tables uploaded once per super-step (admission reserves each
    lane's whole budget of pages, so no table entry appears mid-super-step; frozen and
    past-budget positions route to the sentinel and drop)."""
    select_token, xs = _multi_select(sample, noise, temps, top_ps, top_ks)
    cache, tok_buf, counts, logits = llama.forward_slots_multi(
        params, cache, tokens, positions, active, budgets, eos_ids, select_token, xs,
        n_steps, cfg, tables=tables, page_size=page_size)
    return tok_buf, counts, logits, cache


def _spec_verify_step(params, cache, tokens, positions, cfg):
    """Batched speculative VERIFY: score ``tokens`` [B, k+1] (each lane's pending token
    and its k proposals) in ONE target forward → (greedy [B, k+1], logits [B, k+1, V]
    fp32, cache). Column j is the target's next-token distribution after input j, what
    j sequential one-token steps would give, which makes prefix acceptance lossless."""
    logits, cache = llama.forward_slots(params, tokens, cache, positions, cfg)
    return torch.argmax(logits, dim=-1), logits, cache


def _spec_verify_step_paged(params, cache, tables, tokens, positions, cfg, page_size: int):
    """:func:`_spec_verify_step` over the paged cache: attention through kernel #1 at
    T = k+1 query rows a lane on the card; draft writes past a lane's allocated pages
    route through the sentinel table entry and drop."""
    logits, cache = llama.forward_slots_paged(params, tokens, cache, tables, positions, cfg,
                                              page_size)
    return torch.argmax(logits, dim=-1), logits, cache


def _replay_draws(logits_rows, noise, temperature, top_p, top_k: int) -> torch.Tensor:
    """The plain sampler replayed at every verify position of ONE sampled lane:
    ``logits_rows`` [T, V] with each position's Gumbel noise row ``noise`` [T, V] → the
    tokens [T] that ``spec_k=0`` decode draws at those emissions (the same filtered
    draw as :meth:`Request._sample`, row for row)."""
    filt = filtered_logits(logits_rows, temperature, top_p, top_k)
    return torch.argmax(filt + noise, dim=-1)


def _spec_residual(logits_rows, drafts, generators, temperature, top_p, top_k: int):
    """Leviathan accept/reject for ONE sampled lane's round → (emitted [k+1] int32,
    count): the accepted draft prefix, then the residual draw at the first rejection
    (or, when all k are accepted, a bonus draw from position k's distribution).

    The target probabilities come from the same ``filtered_logits`` as the plain draw;
    the drafter's q is a point mass on its proposal. Position j draws from
    ``generators[j]``, its emission's: a uniform for the accept test, then the Gumbel
    noise of the residual (the bonus takes position k's noise). Tests after the first
    rejection are computed and discarded."""
    k = drafts.shape[0]
    V = logits_rows.shape[-1]
    p = torch.softmax(filtered_logits(logits_rows, temperature, top_p, top_k), dim=-1)
    q = torch.nn.functional.one_hot(drafts.long(), V).float()
    acc, toks = speculative_accept_batch(p[:-1], q, drafts, generators[:-1])
    _, bonus_noise = accept_draws(generators[-1:], 1, V, p.device)
    bonus = torch.argmax(torch.log(torch.clamp(p[-1], min=1e-30)) + bonus_noise[0])
    n = torch.cumprod(acc.to(torch.int32), dim=0).sum()
    correction = torch.where(n == k, bonus, toks[torch.clamp(n, max=k - 1)].long())
    pos = torch.arange(k + 1, device=p.device)
    emitted = torch.where(pos < n, torch.cat([drafts.long(), drafts.new_zeros(1).long()]), 0)
    emitted = torch.where(pos == n, correction, emitted)
    return emitted.to(torch.int32), n + 1


def _spec_multi_select(sample: bool, temps, top_ps, top_ks) -> Callable:
    """``select_ref(logits [B, k+1, V], noise [B, k+1, V] or None) -> [B, k+1]`` for the
    fused speculative rounds: the reference tokens the accept walk compares proposals
    with. ``sample=False`` is the argmax the host loop's verify returns; ``sample=True``
    draws every (lane, position) through ``sampling_core_dyn_k`` with that lane's
    knobs and the noise rows its cursor selected, bitwise :func:`_replay_draws`; greedy
    lanes ride along with a safe temperature of 1.0 and take the argmax."""
    if not sample:
        return lambda logits, _: torch.argmax(logits, dim=-1)
    safe_temps = torch.where(temps > 0.0, temps, 1.0)

    def select_ref(logits, noise):
        B, T, V = logits.shape
        greedy = torch.argmax(logits, dim=-1)
        drawn = sampling_core_dyn_k(
            logits.reshape(B * T, V), noise.reshape(B * T, V),
            safe_temps.repeat_interleave(T), top_ps.repeat_interleave(T),
            top_ks.repeat_interleave(T)).reshape(B, T)
        return torch.where(temps[:, None] > 0.0, drawn, greedy)

    return select_ref


def _spec_multi_step(params, cache, tables, tokens, positions, active, budgets, eos_ids,
                     noise, temps, top_ps, top_ks, history, hist_lens, cfg, n_steps: int,
                     spec_k: int, max_ngram: int, sample: bool, page_size: int = 0):
    """``n_steps`` speculative draft → verify → accept rounds as one super-step, dense
    (``tables`` None) or paged → (the drained int32 vector: ``tok_buf`` [N, B, k+1],
    ``emits`` [N, B], ``counts`` [B], ``proposed`` [B] and ``accepted`` [B] flattened and
    concatenated, so one host read takes them all; the last round's position-0 logits
    [B, V]). Drafting is the resident n-gram gather over the carried history; the
    verify, accept and noise cursor are ``llama.forward_slots_spec_multi``'s."""
    select_ref = _spec_multi_select(sample, temps, top_ps, top_ks)
    _, tok_buf, emits, counts, proposed, accepted, logits = llama.forward_slots_spec_multi(
        params, cache, tokens, positions, active, budgets, eos_ids,
        lambda hist, lens: ngram_propose_resident(hist, lens, spec_k, max_ngram),
        select_ref, noise if sample else None, history, hist_lens, n_steps, spec_k, cfg,
        tables=tables, page_size=page_size)
    host = torch.cat([tok_buf.reshape(-1), emits.reshape(-1), counts, proposed, accepted])
    return host, logits[:, 0, :]


@dataclasses.dataclass
class _PagedPrefix:
    """One paged prefix-registry entry: the physical pages covering the registered
    prefix (full shared pages, plus — when the boundary cuts a page — an immutable
    registry-owned copy of the partial page). The prefix length itself is derived
    from the registry key at lookup; the entry holds one refcount on every id in
    ``pages``, and eviction releases them."""
    pages: np.ndarray  # [n] int32 physical page ids


def _gather_row_paged(cache, row_cache, read_ids: np.ndarray, prefix_len: int,
                      page_size: int):
    """Reassemble the single-row dense cache ``row_cache`` (in place) from pool pages
    (paged prefix-cache resume): pages ``read_ids`` [MP] (sentinel entries clamp) laid
    out as the ``[1, max_len]`` row the chunk programs read, slots past
    ``prefix_len`` invalid and the row's write index (a device tensor) at
    ``prefix_len``. The pool is only read: the registered pages stay live for other
    adopters."""
    MP = read_ids.shape[0]
    valid = row_cache["valid"]
    max_len, dev = valid.shape[1], valid.device
    num_pages = cache["layers"][0]["k"].shape[0]
    ids = torch.as_tensor(np.minimum(read_ids, num_pages - 1), dtype=torch.long, device=dev)
    for planes, row in zip(cache["layers"], row_cache["layers"]):
        for key, pool in planes.items():
            pages = pool.index_select(0, ids)                     # [MP, ps, ...]
            row[key][0].copy_(pages.reshape(MP * page_size, *pages.shape[2:])[:max_len])
    valid.copy_((torch.arange(max_len, device=dev) < prefix_len)[None])
    row_cache["index"].fill_(prefix_len)
    return row_cache


def _copy_page(cache, src: int, dst: int):
    """Copy pool page ``src`` → ``dst`` in every plane, int8 KV's scale planes
    included (the registry-side COW: an immutable snapshot of a partial boundary page
    whose owning lane keeps writing its own copy)."""
    for planes in cache["layers"]:
        for pool in planes.values():
            pool[dst].copy_(pool[src])
    return cache


def _export_pages(cache, ids: torch.Tensor) -> list:
    """Gather pool pages ``ids`` [n] from every plane (int8 KV's scale planes
    included) into a transferable page block: per layer, ``{plane: [n, ps, ...]}``.
    The source pages stay live: the handoff record holds them until the request is
    terminal."""
    return [{key: pool.index_select(0, ids) for key, pool in planes.items()}
            for planes in cache["layers"]]


def _import_pages(cache, block: list, ids: torch.Tensor):
    """Scatter a transferred page block into this pool's pages ``ids`` [n] (in place),
    plane by plane: the destination half of a handoff."""
    for planes, got in zip(cache["layers"], block, strict=True):
        for key, pool in planes.items():
            pool.index_copy_(0, ids, got[key].to(pool.dtype))
    return cache


def _set_lane_valid(cache, slot: int, valid_row: torch.Tensor):
    """Install lane ``slot``'s valid mask (in place): an adopted lane has no prefill
    row to carry it, so the host builds it from the handoff's valid range."""
    cache["valid"][slot].copy_(valid_row)
    return cache


def _snapshot_row(row_cache) -> dict:
    """A dense prefix-registry entry: a clone of the row cache (the prefill programs
    write one static row cache in place, so the registry keeps copies)."""
    return {"layers": [{k: t.clone() for k, t in planes.items()}
                       for planes in row_cache["layers"]],
            "valid": row_cache["valid"].clone(), "index": row_cache["index"].clone()}


def _restore_row(row_cache, snap: dict) -> None:
    """Copy a registry snapshot back into the row cache (in place)."""
    for planes, saved in zip(row_cache["layers"], snap["layers"]):
        for key, t in planes.items():
            t.copy_(saved[key])
    row_cache["valid"].copy_(snap["valid"])
    row_cache["index"].copy_(snap["index"])


def _prefill_append(params, row, mask, cache, cfg, last_only: bool):
    """One prefill chunk appended to the row cache at its device write index (in
    place; the index advances by the chunk's width) → ``(greedy [1], last logits
    [1, V])`` with ``last_only``, else the per-position logits ``[1, T, V]`` (the
    right-aligned prefix layout indexes its real last token, which may sit before
    trailing pads). Nothing here waits on the host: a CUDA graph holds it."""
    logits, new = llama.forward_cached(params, row, cache, cfg, token_mask=mask,
                                       last_only=last_only)
    cache["index"].copy_(new["index"])
    if not last_only:
        return logits
    last = logits[:, -1, :]
    return torch.argmax(last, dim=-1), last


def _prefill_fresh(params, row, mask, cache, cfg, last_only: bool):
    """:func:`_prefill_append` into the row cache emptied first (zero planes, no
    valid slot, index 0: ``init_cache``'s state): a bucket rung's single dispatch, the
    first chunk of a chunked prefill, the first chunk of the prefix layout."""
    for planes in cache["layers"]:
        for t in planes.values():
            t.zero_()
    cache["valid"].zero_()
    cache["index"].zero_()
    return _prefill_append(params, row, mask, cache, cfg, last_only)


#: The prefill programs, by name → (function, last_only, the JAX program's name).
_PREFILL_PROGRAMS = {
    "prefill": (_prefill_fresh, True, "serving.prefill"),
    "chunk": (_prefill_append, True, "serving.prefill_chunk"),
    "full_logits": (_prefill_fresh, False, "serving.prefill_full_logits"),
    "keep": (_prefill_append, False, "serving.prefill_chunk_keep"),
}


class ContinuousBatcher:
    """Continuous-batching decode over ``max_slots`` shared lanes (greedy or sampled
    per request).

    ``submit()`` queues requests; ``step()`` admits queued requests into free lanes
    (prefill + row insert), advances every active lane one token with ONE batched
    forward (or up to ``decode_steps`` tokens in one super-step), and returns the
    requests finished this step. ``run()`` drains everything. The engine runs on the
    device its params live on.

    ``prompt_buckets`` pads each prompt to the smallest rung that fits it and its
    budget (one prefill dispatch; otherwise chunks of ``prompt_bucket``);
    ``prefix_cache`` keeps up to that many full-chunk prefixes for reuse and takes
    precedence over ``prompt_buckets``, as in the JAX engine. ``role`` splits the two
    phases over two engines (see the module docstring): ``prefill`` exports handoffs
    (``take_handoffs``), ``decode`` adopts them (``adopt_handoff``).
    """

    def __init__(self, params, cfg, max_slots: int = 8, max_len: int = 512,
                 prompt_bucket: int = 64, prefix_cache: int = 0, prompt_buckets=None,
                 page_size: int = 0, kv_pages: Optional[int] = None,
                 decode_steps: int = 1, spec_k: int = 0, drafter=None,
                 spec_accept: str = "replay", role: str = "mixed", telemetry=None,
                 tracer=None, faults=None, step_timeout_s: Optional[float] = None,
                 recover: Optional[bool] = None):
        llama.check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_slots = max_slots
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        # Shape-bucketed prefill: one program (on the card one graph) per rung instead
        # of per chunk count; the prefix cache keeps its right-aligned chunk layout
        # (snapshots must align across prompt lengths), so it takes precedence.
        if prompt_buckets is not None:
            self.prompt_buckets = tuple(sorted({int(b) for b in prompt_buckets}))
            if any(b < 1 or b > max_len for b in self.prompt_buckets):
                raise ValueError(
                    f"prompt_buckets={self.prompt_buckets} must lie in [1, max_len={max_len}]")
        else:
            self.prompt_buckets = None
        self.bucket_hits = 0    # prompt admitted into a bucket already dispatched
        self.bucket_misses = 0  # first prompt of a bucket
        self._buckets_seen: set = set()
        if not isinstance(prefix_cache, (int, np.integer)) or isinstance(prefix_cache, bool):
            raise TypeError(f"prefix_cache must be an int, got {type(prefix_cache).__name__}")
        if prefix_cache < 0:
            raise ValueError(f"prefix_cache={prefix_cache} must be >= 0 (0 = off)")
        #: Prefix registry: full-chunk prompt prefix bytes → a row-cache clone (dense)
        #: or a ``_PagedPrefix`` (paged), least recently used first.
        self.prefix_cache_size = int(prefix_cache)
        self._prefix_reg: OrderedDict = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        # Misses split into capacity misses (the key was registered and evicted —
        # remembered in a bounded key set) and key misses (never seen).
        self.prefix_capacity_misses = 0
        self.prefix_key_misses = 0
        self._evicted_keys: OrderedDict = OrderedDict()
        self._evicted_keys_cap = max(64, 8 * self.prefix_cache_size)
        if not isinstance(page_size, (int, np.integer)) or isinstance(page_size, bool):
            raise TypeError(f"page_size must be an int, got {type(page_size).__name__}")
        if page_size < 0:
            raise ValueError(f"page_size={page_size} must be >= 0 (0 = dense cache)")
        self.page_size = int(page_size)
        self.paged = self.page_size > 0
        # Roles: the handoff unit is the page, so a role engine is paged; a prefill
        # engine never decodes (no speculation, no super-step) and a decode engine
        # never prefills (no prefix registry to fill).
        if role not in ENGINE_ROLES:
            raise ValueError(f"role={role!r} must be one of {ENGINE_ROLES}")
        if role != "mixed" and not self.paged:
            raise ValueError(
                f"role={role!r} needs the paged KV cache (page_size >= 1): the "
                "cross-engine handoff unit is the page")
        if role == "prefill" and spec_k:
            raise ValueError(
                "spec_k was given on a prefill-role engine: it never dispatches decode, so "
                "the verify/draft programs would be dead weight")
        if role == "decode" and prefix_cache:
            raise ValueError(
                "prefix_cache was given on a decode-role engine: it never runs prefill, "
                "so the registry could never be populated")
        self.role = role
        #: Prefill role: handoffs built the step their prefill landed (``take_handoffs``).
        self.handoffs: deque = deque()
        self.handoffs_exported = 0
        self.handoffs_adopted = 0
        #: Per-lane (v0, v1) valid ranges recorded at paged admission: the layout fact a
        #: handoff carries (a decode engine has no row cache to read it from).
        self._lane_valid: list = [(0, 0)] * max_slots
        #: Set by ``FleetRouter.kill`` or an injected ``crash``: the engine is abandoned,
        #: its pool with it.
        self.crashed = False
        self.adopt_s = 0.0  # host-clock seconds in adopt_handoff
        if kv_pages is not None and not self.paged:
            raise ValueError(
                "kv_pages was given but page_size=0: the pool size would be silently "
                "ignored — pass page_size>=1 to enable the paged KV cache"
            )
        if not isinstance(decode_steps, (int, np.integer)) or isinstance(decode_steps, bool):
            raise TypeError(f"decode_steps must be an int, got {type(decode_steps).__name__}")
        if decode_steps < 1:
            raise ValueError(
                f"decode_steps={decode_steps} must be >= 1 (1 = the classic one-token step)")
        if role == "prefill" and decode_steps > 1:
            raise ValueError(
                "decode_steps>1 was given on a prefill-role engine: it never dispatches "
                "decode, so the super-step program would be dead weight")
        #: Decode steps per dispatch (``decode_steps``; the JAX engine's name).
        self.multi_step = int(decode_steps)
        # Speculative decoding: ``spec_k`` proposals a lane a step, verified by ONE
        # [B, spec_k+1] forward; ``drafter`` a ``spec_decode.DraftSource`` (default:
        # NgramDrafter); ``spec_accept`` the sampled lanes' test: "replay" (bitwise the
        # spec_k=0 tokens) or "residual" (Leviathan accept/reject).
        if not isinstance(spec_k, (int, np.integer)) or isinstance(spec_k, bool):
            raise TypeError(f"spec_k must be an int, got {type(spec_k).__name__}")
        if spec_k < 0:
            raise ValueError(f"spec_k={spec_k} must be >= 0 (0 disables speculation)")
        if spec_accept not in ("replay", "residual"):
            raise ValueError(f"spec_accept={spec_accept!r}: expected 'replay' or 'residual'")
        self.spec_k = int(spec_k)
        self.spec_accept = spec_accept
        if drafter is not None and not self.spec_k:
            raise ValueError(
                "a drafter was given but spec_k=0: it would be silently ignored — "
                "pass spec_k>=1 to enable speculative decoding"
            )
        if self.spec_k and drafter is None:
            drafter = NgramDrafter()
        self.drafter = drafter
        #: The speculative master switch (``set_spec_enabled``).
        self.spec_enabled = True
        self.spec_proposed = 0  # draft tokens proposed (spec_k a live lane a round)
        self.spec_accepted = 0  # proposed tokens that were emitted
        if self.paged:
            if kv_pages is None:
                kv_pages = max_slots * pages_for(max_len, self.page_size)
            self.block_mgr = BlockManager(int(kv_pages), self.page_size, max_slots, max_len)
            self.cache = llama.init_paged_cache(
                cfg, max_slots, max_len, int(kv_pages), self.page_size, device=self.device
            )
            self.kv_page_bytes = self.cache_bytes() // int(kv_pages)
        else:
            self.block_mgr = None
            self.kv_page_bytes = 0
            self.cache = llama.init_cache(cfg, max_slots, max_len, device=self.device)
        self.tokens = np.zeros((max_slots,), np.int32)     # pending token per lane
        self.positions = np.zeros((max_slots,), np.int32)  # next write slot per lane
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.queue: deque[Request] = deque()
        self._uid = 0
        self.peak_active_slots = 0
        self.admitted = 0          # requests that entered a lane (prefill ran)
        self.evicted = 0           # lane frees of finished requests
        self.evicted_external = 0  # lane frees forced by evict_slot()/cancel()
        self.decode_steps = 0      # decode dispatches (admission prefills excluded)
        self.decode_tokens = 0     # tokens emitted by those dispatches
        self.prefill_s = 0.0       # host-clock seconds in admission prefills + inserts
        self.decode_s = 0.0        # host-clock seconds in decode dispatches
        self.dispatch_s = 0.0      # ... of which before the host read (host work)
        self.noise_s = 0.0         # host-clock seconds drawing super-steps' sampled noise
        self.noise_ahead_s = 0.0   # ... drawn ahead, while the device runs a super-step
        self._noise_ahead: dict = {}  # uid -> {emission: noise row} drawn ahead
        #: fp32 logits [max_slots, V] of the most recent decode step (of a super-step,
        #: its last step's; on the card a graph output that the next replay overwrites).
        self.last_logits: Optional[torch.Tensor] = None
        #: Super-step runners by (n_steps, sampled, paged): a ``CapturedStep`` on the
        #: card (its graph's kernel nodes, capture time, pool bytes and replays), the
        #: plain function on the CPU.
        self.graphs: dict = {}
        self._mbuf: Optional[dict] = None  # the super-step's static inputs
        #: Prefill runners by (program, width), as ``graphs``; on the card their graphs
        #: share one memory pool (``prefill_pool_bytes``).
        self.prefill_graphs: dict = {}
        self._prefill_pool = None
        # Fault boundary: ``faults`` (a ``resilience.FaultPlan``) fires at the serving
        # sites; ``step_timeout_s`` arms a watchdog over each dispatch; ``recover`` turns
        # the boundary on (default: exactly when faults or a watchdog are armed).
        self.telemetry = telemetry
        self.tracer = tracer
        self.faults = faults
        self._watchdog = StepWatchdog(step_timeout_s) if step_timeout_s else None
        self.recover = bool(recover if recover is not None
                            else (faults is not None or self._watchdog is not None))
        self._kv_pages_total = int(kv_pages) if self.paged else 0
        self.step_failures = 0        # dispatches the fault boundary caught
        self.quarantined = 0          # requests terminally failed by recovery
        self.recovered_admissions = 0  # survivor re-admissions (prefill replays)
        self.bisect_rounds = 0        # ambiguous-attribution probe rounds
        self.recovered_uids: set = set()   # engine uids that survived a rebuild
        self._suspects: Optional[set] = None  # narrowed poison candidates (uids)
        self._bisect_hold: list = []   # suspects held out of admission
        self.rebuild_s = 0.0          # host-clock seconds in in-place rebuilds
        #: Queue waits measured at admission (submit → lane), the bare engine's latency.
        self.queue_waits: deque = deque(maxlen=1024)
        #: End of the previous decode dispatch on the tracer's clock (tracing only).
        self._last_dispatch_end: Optional[float] = None
        # The prefill programs' static buffers: the row cache they write (its write
        # index a device tensor) and, per width, the token row and its mask. A decode
        # engine never prefills and holds no row cache, unless recovery from a non-crash
        # fault is armed: survivors are then re-admitted through prefill, as in JAX.
        needs_row = role != "decode" or (self.recover and (
            self._watchdog is not None or recover is True or faults is None
            or any(s.kind != "crash" for s in faults.specs)))
        self._row = (llama.init_cache(cfg, 1, max_len, device=self.device, device_index=True)
                     if needs_row else None)
        self._pbuf: dict = {}
        #: Fused speculative super-step runners by (N, k, max_ngram, sampled, paged), as
        #: ``graphs``.
        self.spec_graphs: dict = {}
        if self.drafter is not None:
            self.drafter.bind(self)

    # ------------------------------------------------------------------ user API
    def stats(self) -> dict:
        """Engine counters: queue depth, busy lanes, admission/eviction totals, the
        prefix cache's entries, hits, misses (capacity against key) and evictions, the
        bucket ladder's hits and misses, decode throughput and host-clock time in
        prefill and decode, and the fault boundary's counters; paged engines add the page
        pool's occupancy, sharing (``kv_shared_pages``) and churn
        (alloc/free/COW/adopt/defer). ``queue_wait`` summarizes the waits measured at
        admission; ``queue_wait_s`` is the oldest queued request's age."""
        active = sum(r is not None for r in self.slot_req)
        queue_wait_s = 0.0
        if self.queue:
            queue_wait_s = max(0.0, time.monotonic() - min(r.enqueued_at for r in self.queue))
        kv = {"paged": self.paged}
        if self.paged:
            ms = self.block_mgr.stats()
            kv.update({
                "page_size": self.page_size,
                "pages_total": ms["pages_total"],
                "pages_free": ms["pages_free"],
                "pages_in_use": ms["pages_in_use"],
                "page_occupancy": ms["page_occupancy"],
                "kv_page_bytes": self.kv_page_bytes,
                "kv_bytes_in_use": ms["pages_in_use"] * self.kv_page_bytes,
                "kv_bytes_total": ms["pages_total"] * self.kv_page_bytes,
                "kv_shared_pages": ms["shared_pages"],
                "kv_alloc_count": ms["alloc_count"],
                "kv_free_count": ms["free_count"],
                "kv_cow_count": ms["cow_count"],
                "kv_adopt_count": ms["adopt_count"],
                "kv_defer_count": ms["defer_count"],
            })
        return {
            **kv,
            "role": self.role,
            "handoffs_pending": len(self.handoffs),
            "handoffs_exported": self.handoffs_exported,
            "handoffs_adopted": self.handoffs_adopted,
            "adopt_s": self.adopt_s,
            "peak_active_slots": self.peak_active_slots,
            "prefix_entries": len(self._prefix_reg),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_evictions": self.prefix_evictions,
            "prefix_capacity_misses": self.prefix_capacity_misses,
            "prefix_key_misses": self.prefix_key_misses,
            "bucket_hits": self.bucket_hits,
            "bucket_misses": self.bucket_misses,
            "queued": len(self.queue),
            "queue_wait_s": queue_wait_s,
            "queue_wait": latency_summary(self.queue_waits),
            "active_slots": active,
            "max_slots": self.max_slots,
            "slot_occupancy": active / self.max_slots,
            "admitted": self.admitted,
            "evicted": self.evicted,
            "evicted_external": self.evicted_external,
            "spec_k": self.spec_k,
            "multi_step": self.multi_step,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "tokens_per_step": (
                round(self.decode_tokens / self.decode_steps, 4)
                if self.decode_steps else None
            ),
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": (
                round(self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else None
            ),
            "spec_enabled": self.spec_enabled,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "dispatch_s": self.dispatch_s,
            "noise_s": self.noise_s,
            "noise_ahead_s": self.noise_ahead_s,
            "step_failures": self.step_failures,
            "quarantined": self.quarantined,
            "recovered_admissions": self.recovered_admissions,
            "bisect_rounds": self.bisect_rounds,
            "bisect_held": len(self._bisect_hold),
            "watchdog_timeouts": (self._watchdog.timeouts
                                  if self._watchdog is not None else 0),
            "rebuild_s": self.rebuild_s,
        }

    def _emit_telemetry(self, extra: Optional[dict] = None) -> None:
        """Push a ``serving/v1`` counter record (and, paged, a ``serving.kv/v1`` record)
        through the telemetry; no-op without an enabled one (two attribute reads)."""
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        record = {"schema": SERVING_SCHEMA, "telemetry_rev": TELEMETRY_REV, **self.stats()}
        if extra:
            record.update(extra)
        tel.emit(record)
        if self.paged:
            ms = self.block_mgr.stats()
            tel.emit({
                "schema": SERVING_KV_SCHEMA,
                "telemetry_rev": TELEMETRY_REV,
                # The causality key trace.span/v1 decode spans of the same step carry.
                "step": self.decode_steps,
                "page_size": self.page_size,
                "pages_total": ms["pages_total"],
                "pages_in_use": ms["pages_in_use"],
                "page_occupancy": ms["page_occupancy"],
                "kv_bytes_in_use": ms["pages_in_use"] * self.kv_page_bytes,
                "kv_bytes_total": ms["pages_total"] * self.kv_page_bytes,
                "kv_shared_pages": ms["shared_pages"],
                "kv_alloc_count": ms["alloc_count"],
                "kv_free_count": ms["free_count"],
                "kv_cow_count": ms["cow_count"],
                "kv_adopt_count": ms["adopt_count"],
                "kv_defer_count": ms["defer_count"],
                "prefix_entries": len(self._prefix_reg),
                "prefix_evictions": self.prefix_evictions,
            })

    def _emit_spec(self, rounds: int, active: int, proposed: int, accepted: int,
                   tokens: int) -> None:
        """One ``serving.spec/v1`` record for a speculative dispatch of ``rounds``
        rounds (no-op without an enabled telemetry)."""
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return
        tel.emit({
            "schema": SERVING_SPEC_SCHEMA,
            "telemetry_rev": TELEMETRY_REV,
            "step": self.decode_steps,
            "spec_k": self.spec_k,
            "rounds": rounds,
            "active_slots": active,
            "step_proposed": proposed,
            "step_accepted": accepted,
            "step_tokens": tokens,
            "proposed_total": self.spec_proposed,
            "accepted_total": self.spec_accepted,
            "spec_accept_rate": (round(self.spec_accepted / self.spec_proposed, 4)
                                 if self.spec_proposed else None),
            "tokens_per_step": (round(self.decode_tokens / self.decode_steps, 4)
                                if self.decode_steps else None),
        })

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               gen: Optional[GenerationConfig] = None,
               seed: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None) -> Request:
        """Queue a request: ``max_new_tokens``/``eos_token_id`` (greedy) or a full
        ``gen`` — not both. Temperature sampling needs an integer ``seed``. Raises for
        a request the cache (or page pool) could never hold. A decode-role engine takes
        no submissions: its work arrives as handoffs (``adopt_handoff``)."""
        if self.role == "decode":
            raise RuntimeError(
                "decode-role engine takes no direct submissions: work arrives as KV "
                "handoffs (adopt_handoff) from a prefill-role replica — route through "
                "serving_gateway.DisaggRouter")
        prompt, gen = normalize_submit(prompt, max_new_tokens, eos_token_id, gen, seed)
        self.kv_demand(len(prompt), gen.max_new_tokens)
        req = Request(self._uid, prompt, gen, seed, on_token=on_token,
                      enqueued_at=time.monotonic())
        self._uid += 1
        self.queue.append(req)
        return req

    def kv_demand(self, prompt_len: int, max_new: int) -> int:
        """Cache-token cost of one request under this engine's layout: the padded
        prefill width (its bucket rung, or whole chunks: the prefix layout's too) plus
        the budget (dense), or the page-granular worst case (paged). Raises
        ``ValueError`` for unservable geometry and :class:`KVBudgetError` when the
        demand exceeds the whole page pool.

        By role: a prefill engine holds the prompt's context pages only (its lanes
        never decode; the decode replica charges the budget); a decode engine prices
        the adoption: context + budget, plus one page for the boundary page's
        transient import."""
        _, total = self._plan_prefill(prompt_len, max_new)
        if self.paged:
            if self.role == "prefill":
                return self.block_mgr.demand(total) * self.page_size
            if self.role == "decode":
                need = self.block_mgr.demand(total + max_new) + 1
                if need > self.block_mgr.num_pages:
                    raise KVBudgetError(
                        f"adoption needs {need} pages ({total + max_new} cache tokens + the "
                        f"transient boundary-page import at page_size={self.page_size}) but "
                        f"the pool only has {self.block_mgr.num_pages} — it can never be "
                        "adopted")
                return need * self.page_size
            return self.block_mgr.demand(total + max_new) * self.page_size
        return total + max_new

    def cache_bytes(self) -> int:
        """Total bytes of the KV cache planes (scale planes included)."""
        return sum(t.numel() * t.element_size()
                   for planes in self.cache["layers"] for t in planes.values())

    def cancel(self, uid: int) -> bool:
        """Withdraw a request by uid wherever it is: the queue, the bisection hold, or
        a lane (freed now). Returns False when the uid is unknown or already
        finished."""
        for req in self.queue:
            if req.uid == uid:
                self.queue.remove(req)
                return True
        for req in self._bisect_hold:
            if req.uid == uid:
                self._bisect_hold.remove(req)
                self._suspects = None if not self._bisect_hold else self._suspects
                return True
        return self.evict_slot(uid)

    def evict_slot(self, uid: int) -> bool:
        """Free the lane holding request ``uid``; the request keeps its partial
        ``tokens`` and is NOT marked done."""
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.uid == uid:
                self.slot_req[slot] = None
                self._release_lane(slot)
                self.evicted_external += 1
                return True
        return False

    def set_spec_enabled(self, enabled: bool) -> None:
        """Turn speculative decoding on or off at run time. Output-safe either way:
        speculation never changes emitted tokens, only how many a dispatch produces.
        Off, decode takes this engine's plain path for its ``decode_steps`` (the
        one-token step, or the plain super-step when ``decode_steps > 1``, never
        N = 1); ``warm_programs`` captures both. Back on, a ``ModelDrafter``'s stale
        lanes only lower acceptance until they cycle."""
        if self.spec_k:
            self.spec_enabled = bool(enabled)

    def _spec_fused(self) -> bool:
        """Whether speculation dispatches as the FUSED super-step instead of the host
        loop: it needs ``decode_steps > 1``, replay acceptance (the residual test draws
        on the host per emission) and a drafter with a device twin
        (``DraftSource.resident``: the NgramDrafter)."""
        return (self.multi_step > 1 and self.spec_accept == "replay"
                and getattr(self.drafter, "resident", False))

    def _release_lane(self, slot: int) -> None:
        """Return a freed lane's pages to the pool (paged); a dense lane's row is
        simply overwritten at the next admission."""
        if self.paged:
            self.block_mgr.release_slot(slot)

    # ------------------------------------------------------------ fault boundary
    def _pre_dispatch(self, site: str, active: list[int]) -> float:
        """Before a decode/verify dispatch: open the watchdog window and fire any
        injected fault due at ``site`` (on the host, before any launch: ``hang``
        sleeps, ``crash`` raises ``EngineCrashed``, other kinds raise their
        ``InjectedFault``). Disarmed, two attribute reads."""
        wd = self._watchdog
        t0 = wd.open() if wd is not None else 0.0
        fp = self.faults
        if fp is not None:
            uids = [self.slot_req[i].uid for i in active if self.slot_req[i] is not None]
            spec = fp.draw(site, uids=uids)
            if spec is not None:
                if spec.kind == "hang":
                    time.sleep(spec.hang_s)
                elif spec.kind == "crash":
                    self.crashed = True
                    raise EngineCrashed(site)
                else:
                    raise fp.fault_for(spec, site)
        return t0

    def _post_dispatch(self, t0: float, site: str = "serving.decode") -> None:
        """After the dispatch's one host read (where the host first waits for the
        device), before any token lands: the watchdog's check."""
        if self._watchdog is not None:
            self._watchdog.check(t0, site)

    def _emit_fault(self, site: str, kind: str, uid, reason: str) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit({"schema": FAULT_SCHEMA, "site": site, "kind": kind, "uid": uid,
                      "reason": reason, "step": self.decode_steps})

    def _emit_recovery(self, action: str, **cols) -> None:
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.emit({"schema": RECOVERY_SCHEMA, "action": action,
                      "step": self.decode_steps, **cols})

    def _quarantine(self, req: Request, reason: str) -> Request:
        """Fail one request terminally: ``failed`` reason, lane and pages released,
        the tokens it streamed kept. Returned to the caller like a finished request."""
        req.failed = reason
        req.done = True
        self.quarantined += 1
        for slot, r in enumerate(self.slot_req):
            if r is req:
                self.slot_req[slot] = None
                self._release_lane(slot)
                break
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.event(tracer.handle_for(req.uid), "fault", step=self.decode_steps,
                         reason=reason)
        self._emit_recovery("quarantine", uid=req.uid, reason=reason)
        return req

    def _detach_for_requeue(self, req: Request) -> None:
        """Take a live request off its lane (if any) and arm its recovery context:
        the next admission prefills prompt + emitted tokens. The noise rows drawn
        ahead for it are dropped (its next window is drawn from its record)."""
        for slot, r in enumerate(self.slot_req):
            if r is req:
                self.slot_req[slot] = None
                self._release_lane(slot)
                break
        self._noise_ahead.pop(req.uid, None)
        req._recover_ctx = (np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
                            if req.tokens else req.prompt)

    def _reset_cache(self) -> None:
        """Reset the engine cache IN PLACE to ``init_cache``/``init_paged_cache``'s
        state (zero planes, no valid slot): every captured graph reads these tensors
        at fixed addresses, so they are never reallocated."""
        for planes in self.cache["layers"]:
            for t in planes.values():
                t.zero_()
        self.cache["valid"].zero_()

    def _rebuild_survivors(self) -> None:
        """Reset the device-side engine state (a failed dispatch may have written the
        cache) and requeue every surviving lane at the FRONT of the queue for
        re-admission from its host record. Paged: the prefix registry is drained
        against the OLD manager first (its entries hold old page ids), then a new
        ``BlockManager`` takes the pool. Dense prefix snapshots survive."""
        t0 = time.perf_counter()
        survivors = [r for r in self.slot_req if r is not None]
        if self.paged:
            while self._evict_prefix_lru():
                pass
            self.block_mgr = BlockManager(self._kv_pages_total, self.page_size,
                                          self.max_slots, self.max_len)
        self._reset_cache()
        self.slot_req = [None] * self.max_slots
        self.positions[:] = 0
        self.tokens[:] = 0
        for req in sorted(survivors, key=lambda r: r.uid, reverse=True):
            self._detach_for_requeue(req)
            self.queue.appendleft(req)
        self.rebuild_s += time.perf_counter() - t0
        self._emit_recovery("rebuild", survivors=len(survivors))

    def _recover_step_failure(self, error: Exception,
                              active_reqs: list[Request]) -> list[Request]:
        """A failed decode dispatch: attribute the poison (directly when the error
        names a uid, else by bisection over the active set), quarantine it, and rebuild
        the survivors unless the fault fired before the dispatch touched the device.

        Bisection: a poison request fails every dispatch it rides. The probe half keeps
        running; the held half waits out one clean dispatch and is then requeued as the
        sole suspects, halving the candidates each failing round."""
        self.step_failures += 1
        site = getattr(error, "site", "serving.decode")
        kind = getattr(error, "kind", type(error).__name__)
        uid = getattr(error, "uid", None)
        self._emit_fault(site, kind, uid, reason=str(error))
        live = [r for r in active_reqs if not r.done]
        failed: list[Request] = []
        if uid is not None and any(r.uid == uid for r in live):
            victim = next(r for r in live if r.uid == uid)
            failed.append(self._quarantine(victim, f"step_fault:{kind}"))
            self._suspects = None
        else:
            cands = [r for r in live if self._suspects is None or r.uid in self._suspects]
            if not cands:
                cands = live
            if len(cands) == 1:
                failed.append(self._quarantine(cands[0], f"step_fault:{kind}"))
                self._suspects = None
            elif cands:
                half = max(1, len(cands) // 2)
                probe, hold = cands[:half], cands[half:]
                for req in hold:
                    self._detach_for_requeue(req)
                    self._bisect_hold.append(req)
                self._suspects = {r.uid for r in probe}
                self.bisect_rounds += 1
                self._emit_recovery("bisect", candidates=len(cands), probing=len(probe),
                                    held=len(hold))
        if not getattr(error, "pre_dispatch", False):
            self._rebuild_survivors()
        return failed

    def _release_bisect_hold(self) -> None:
        """Requeue the held suspects (FRONT, uid order) as the only candidates left."""
        self._suspects = {r.uid for r in self._bisect_hold}
        for req in sorted(self._bisect_hold, key=lambda r: r.uid, reverse=True):
            self.queue.appendleft(req)
        self._bisect_hold = []

    def _after_clean_step(self, active_reqs: list[Request]) -> None:
        """After a clean dispatch: a clean probe releases the held half as the
        remaining suspects; a clean dispatch covering every suspect clears the
        suspicion (the fault was transient)."""
        if self._bisect_hold:
            self._release_bisect_hold()
        elif self._suspects is not None:
            uids = {r.uid for r in active_reqs}
            if self._suspects <= uids:
                self._suspects = None

    @torch.no_grad()
    def step(self) -> list[Request]:
        """Admit queued requests, then advance every active lane one token (or a
        super-step's, or a speculative round's). Returns the requests finished this
        step, in submission order. A prefill-role engine exports its admitted lanes
        instead of decoding them.

        With recovery armed a failed dispatch does not end the engine: the poison
        request is quarantined and returned, and the survivors continue from their
        host records (see the module docstring); a ``crash`` propagates."""
        if self.role == "prefill":
            return self._prefill_role_step()
        finished_at_admit = self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        self.peak_active_slots = max(self.peak_active_slots, len(active))
        if not active:
            if self._bisect_hold:
                # No probe can run: the held suspects are the only work left and
                # nothing else can clear them.
                self._release_bisect_hold()
            if finished_at_admit:
                self._emit_telemetry()
            return finished_at_admit
        # Speculation wins while enabled; with it off, a decode_steps > 1 engine takes
        # the plain super-step, never N = 1.
        use_spec = self.spec_k and self.spec_enabled
        if use_spec and self._spec_fused():
            decode = self._spec_multi
        elif use_spec:
            decode = self._spec_step
        elif self.multi_step > 1:
            decode = self._multi_step
        else:
            decode = self._plain_step
        if not self.recover:
            finished = decode(active)
        else:
            active_reqs = [self.slot_req[i] for i in active]
            try:
                finished = decode(active)
            except EngineCrashed:
                raise  # the death of the engine: the replica's owner fails over
            except Exception as e:  # the fault boundary: quarantine + rebuild
                finished = self._recover_step_failure(e, active_reqs)
            else:
                self._after_clean_step(active_reqs)
        self.evicted += len(finished)
        self._emit_telemetry()
        return sorted(finished_at_admit + finished, key=lambda r: r.uid)

    # ------------------------------------------------------- disaggregated roles
    def _prefill_role_step(self) -> list[Request]:
        """Prefill-role ``step()``: admit queued requests (the normal admission path),
        then export every admitted lane as a :class:`KVHandoff` and free it. Returns
        only the requests that finished at admission (EOS or a one-token budget: they
        need no handoff)."""
        finished = self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        self.peak_active_slots = max(self.peak_active_slots, len(active))
        for slot in active:
            self._export_lane(slot)
        if finished or active:
            self._emit_telemetry()
        return sorted(finished, key=lambda r: r.uid)

    def _export_lane(self, slot: int) -> None:
        """Detach lane ``slot`` into a handoff: the pages covering the prefill context
        keep their refcounts (the record owns them until ``release_handoff``), pages
        past the context (a prefix-layout row's invalid tail) are released now, and the
        lane frees for the next admission."""
        req = self.slot_req[slot]
        pages = self.block_mgr.detach_slot(slot)
        n_ctx = int(self.positions[slot])
        keep = pages_for(n_ctx, self.page_size)
        if len(pages) > keep:
            self.block_mgr.release(pages[keep:])
        self.handoffs.append(KVHandoff(
            uid=req.uid, prompt=req.prompt, gen=req.gen, seed=req.seed,
            tokens=list(req.tokens), pages=pages[:keep], prefill_len=n_ctx,
            valid_range=self._lane_valid[slot]))
        self.handoffs_exported += 1
        self.slot_req[slot] = None

    def take_handoffs(self) -> list:
        """Drain the export queue: every handoff built since the last call, in
        admission order."""
        out = list(self.handoffs)
        self.handoffs.clear()
        return out

    def export_page_block(self, h: KVHandoff) -> list:
        """Gather handoff ``h``'s source pages from every plane into the page block
        ``adopt_handoff`` scatters: per layer ``{plane: [len(h.pages), ps, ...]}``, on
        this engine's device. Only the real pages are gathered (the JAX block is
        table-width)."""
        ids = torch.as_tensor(np.asarray(h.pages, np.int64), device=self.device)
        return _export_pages(self.cache, ids)

    def release_handoff(self, h: KVHandoff) -> int:
        """Drop a handoff's page references on this (source) engine → pages freed."""
        return self.block_mgr.release(h.pages)

    def can_adopt_handoff(self, h: KVHandoff) -> bool:
        """Would :meth:`adopt_handoff` land now (a free lane, and the pool covering the
        transient import peak)? The router asks BEFORE gathering and transferring the
        block, so a deferred adoption pays for no copy."""
        if self.role == "prefill" or not self.paged:
            return False
        if not any(r is None for r in self.slot_req):
            return False
        mgr = self.block_mgr
        n_full = h.prefill_len // self.page_size
        remaining = h.gen.max_new_tokens - len(h.tokens)
        n_lane_pages = mgr.demand(h.prefill_len + remaining + 1)
        return len(h.pages) + (n_lane_pages - n_full) <= mgr.free_pages

    @torch.no_grad()
    def adopt_handoff(self, h: KVHandoff, block: list, on_token=None,
                      replay_tokens: bool = False) -> Optional[Request]:
        """Start a decode lane exactly where the prefill replica left off, from a
        transferred page block (on this engine's device): no prefill runs here.

        In order: the block is scattered into pages owned by the import; the lane
        adopts the full context pages read-only and reserves fresh pages for the rest
        of its budget (``BlockManager.admit``); a boundary page cut mid-way is copied
        on write into the lane's first own page; the import's references drop (full
        pages then belong to the lane, the boundary original frees); the lane's valid
        range, position and pending token are set. A captured super-step reads the
        lane through the host tables and positions uploaded before each replay.

        Returns the engine :class:`Request` in the lane, or None when the adoption must
        DEFER (no free lane, or pool pressure; ``kv_defer_count`` moves; nothing is
        consumed). ``replay_tokens`` delivers the handoff's tokens again through
        ``on_token`` (a re-adoption after a decode replica died)."""
        if self.role == "prefill":
            raise RuntimeError("a prefill-role engine cannot adopt handoffs")
        if not self.paged:
            raise RuntimeError("handoff adoption needs the paged KV cache")
        slot = next((i for i, r in enumerate(self.slot_req) if r is None), None)
        if slot is None:
            return None
        t0 = time.perf_counter()
        mgr = self.block_mgr
        ps = self.page_size
        n_src = len(h.pages)
        n_full = h.prefill_len // ps
        partial = h.prefill_len % ps != 0
        remaining = h.gen.max_new_tokens - len(h.tokens)
        if remaining <= 0 or not h.tokens:
            raise ValueError(
                f"handoff uid={h.uid} has no decode work (emitted {len(h.tokens)}/"
                f"{h.gen.max_new_tokens}) — it should have finished on the prefill replica")
        n_block = block[0]["k"].shape[0]
        if n_block != n_src:
            raise ValueError(f"page block holds {n_block} pages, handoff uid={h.uid} {n_src}")
        # The lane reserves context + the whole residual budget (no mid-decode
        # allocation); the import peak adds the boundary page's short-lived original.
        n_lane_tokens = h.prefill_len + remaining + 1
        n_lane_pages = mgr.demand(n_lane_tokens)
        if n_src + (n_lane_pages - n_full) > mgr.free_pages:
            mgr.defer_count += 1
            return None
        import_ids = mgr.import_pages(n_src)
        dev = self.device
        self.cache = _import_pages(self.cache, block,
                                   torch.as_tensor(import_ids, dtype=torch.long, device=dev))
        lane_ids = mgr.admit(slot, n_lane_tokens, adopted=import_ids[:n_full],
                             cow_partial=partial)
        if partial:
            # COW: the lane's first writable page starts as a copy of the boundary page.
            self.cache = _copy_page(self.cache, int(import_ids[n_full]), int(lane_ids[n_full]))
        mgr.release(import_ids)
        v0, v1 = h.valid_range
        valid_row = np.zeros((self.max_len,), bool)
        valid_row[v0:v1] = True
        self.cache = _set_lane_valid(self.cache, slot, torch.from_numpy(valid_row).to(dev))
        req = Request(self._uid, h.prompt, h.gen, h.seed, on_token=on_token,
                      enqueued_at=time.monotonic())
        self._uid += 1
        req.tokens = list(h.tokens)
        self.slot_req[slot] = req
        self.positions[slot] = h.prefill_len
        self.tokens[slot] = int(h.tokens[-1])
        self.admitted += 1
        self.handoffs_adopted += 1
        self._lane_valid[slot] = (v0, v1)
        if self.drafter is not None:
            # Every handoff layout is "context left-padded to width prefill_len" (bucket
            # and chunk: pad = total - len(prompt); prefix: pad = 0), so one synthesized
            # bucket plan reproduces it on the draft cache.
            self.drafter.admit(slot, np.asarray(h.prompt, np.int32), ("bucket", h.prefill_len))
        self.adopt_s += time.perf_counter() - t0
        if replay_tokens and on_token is not None:
            for tok in h.tokens:
                on_token(int(tok))
        return req

    def _plain_step(self, active: list[int]) -> list[Request]:
        """ONE batched forward advances every lane one token."""
        tracer = self.tracer
        tracing = tracer is not None and tracer.enabled  # the two-attribute-read contract
        ts0 = tracer._clock() if tracing else 0.0
        traced = [self.slot_req[i] for i in active] if tracing else ()
        t0 = time.perf_counter()
        t_guard = self._pre_dispatch("serving.decode", active)
        dev = self.device
        tokens = torch.tensor(self.tokens, device=dev)
        positions = torch.tensor(self.positions, device=dev)
        if self.paged:
            with compile_label("serving.decode_paged"):
                greedy, logits, self.cache = _decode_step_paged(
                    self.params, self.cache, torch.tensor(self.block_mgr.tables, device=dev),
                    tokens, positions, self.cfg, self.page_size,
                )
        else:
            with compile_label("serving.decode"):
                greedy, logits, self.cache = _decode_step(
                    self.params, self.cache, tokens, positions, self.cfg
                )
        self.dispatch_s += time.perf_counter() - t0
        greedy_host = greedy.cpu().numpy()
        self._post_dispatch(t_guard)  # the watchdog, before any token lands
        self.last_logits = logits
        finished = []
        # Every lane wrote one slot (idle lanes too); clamp so an idle lane's position
        # never runs past the cache (it is re-initialized at its next admission).
        self.positions = np.minimum(self.positions + 1, self.max_len - 1)
        for i in active:
            req = self.slot_req[i]
            tok = (int(greedy_host[i]) if req.gen.temperature <= 0.0
                   else req._sample(logits[i]))
            self.tokens[i] = tok
            req.tokens.append(tok)
            if req.on_token is not None:
                req.on_token(tok)
            hit_eos = req.gen.eos_token_id is not None and tok == req.gen.eos_token_id
            if hit_eos or len(req.tokens) >= req.gen.max_new_tokens:
                req.done = True
                finished.append(req)
                self.slot_req[i] = None
                self._release_lane(i)
        self.decode_steps += 1
        self.decode_tokens += len(active)
        self.decode_s += time.perf_counter() - t0
        if tracing:
            # One span per traced lane, sharing this dispatch's [t0, t1] and step index
            # (the join key into the serving/kv records of the same step).
            t1 = tracer._clock()
            host_s = self._host_gap(ts0, t1)
            for req in traced:
                tracer.span(tracer.handle_for(req.uid), "decode", ts0, t1,
                            step=self.decode_steps, occupancy=len(active), tokens=1,
                            host_s=host_s)
        return finished

    def _host_gap(self, t0: float, t1: float) -> float:
        """The measured gap from the previous dispatch's end to this one's start on the
        tracer's clock (0.0 for a trace's first dispatch, clamped at 0); tracing only."""
        prev = self._last_dispatch_end
        self._last_dispatch_end = t1
        return round(max(0.0, t0 - prev), 9) if prev is not None else 0.0

    def _multi_buffers(self) -> dict:
        """The super-step's static inputs on the engine's device (made once: a captured
        graph reads them where they are; the host fills them before each super-step)."""
        if self._mbuf is None:
            B, N, dev = self.max_slots, self.multi_step, self.device

            def zeros(shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=dev)

            # The fused speculative super-step reads N·(k+1) noise rows a lane and the
            # drafting history; the plain super-step the first N rows of the same table.
            rows = N * (self.spec_k + 1) if self._spec_fused() else N
            self._mbuf = {
                "tokens": zeros((B,), torch.int32), "positions": zeros((B,), torch.int32),
                "active": zeros((B,), torch.bool), "budgets": zeros((B,), torch.int32),
                "eos_ids": zeros((B,), torch.int32), "temps": zeros((B,), torch.float32),
                "top_ps": zeros((B,), torch.float32), "top_ks": zeros((B,), torch.int32),
                "noise": zeros((B, rows, self.cfg.vocab_size), torch.float32),
            }
            if self.paged:
                self._mbuf["tables"] = zeros(self.block_mgr.tables.shape, torch.int32)
            if self._spec_fused():
                self._mbuf["history"] = zeros((B, self.max_len), torch.int32)
                self._mbuf["hist_lens"] = zeros((B,), torch.int32)
        return self._mbuf

    def _super_step(self, sample: bool):
        """One super-step over the static inputs → (tok_buf, counts, last logits)."""
        b, N = self._mbuf, self.multi_step
        lanes = (b["tokens"], b["positions"], b["active"], b["budgets"], b["eos_ids"],
                 b["noise"][:, :N], b["temps"], b["top_ps"], b["top_ks"])
        if self.paged:
            out = _decode_multi_step_paged(self.params, self.cache, b["tables"], *lanes,
                                           self.cfg, N, sample, self.page_size)
        else:
            out = _decode_multi_step(self.params, self.cache, *lanes, self.cfg, N, sample)
        return out[:3]

    def _graph(self, fn: Callable, pool=None):
        """The runner of ``fn``: a ``CapturedStep`` on the card (run eagerly once,
        captured, then replayed), ``fn`` itself on the CPU."""
        if self.device.type == "cuda":
            return CapturedStep(fn, self.device, pool=pool)
        return fn

    def _super_runner(self, sampled: bool):
        """The super-step runner of key ``(N, sampled, paged)``, made at first use."""
        key = (self.multi_step, sampled, self.paged)
        run = self.graphs.get(key)
        if run is None:
            run = self.graphs[key] = self._graph(functools.partial(self._super_step, sampled))
        return run

    def _load_super_step(self, active: list[int], rows: Optional[int] = None) -> bool:
        """Fill the super-step's static inputs for lanes ``active`` (the other lanes
        idle: frozen at step 0, they write nothing) → whether a live lane samples. A
        sampled lane's first ``rows`` noise rows (default N) are its next emissions'."""
        rows = rows or self.multi_step
        B = self.max_slots
        active_mask = np.zeros((B,), bool)
        budgets = np.ones((B,), np.int32)  # idle lanes: frozen at step 0, never read
        eos_ids = np.full((B,), -1, np.int32)
        temps = np.zeros((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        buf = self._multi_buffers()
        sampled = False
        for i in active:
            req = self.slot_req[i]
            active_mask[i] = True
            budgets[i] = req.gen.max_new_tokens - len(req.tokens)
            if req.gen.eos_token_id is not None:
                eos_ids[i] = req.gen.eos_token_id
            if req.gen.temperature > 0.0:
                sampled = True
                temps[i] = req.gen.temperature
                top_ps[i] = req.gen.top_p
                top_ks[i] = req.gen.top_k
                ts = time.perf_counter()
                buf["noise"][i, :rows].copy_(self._noise_window(req, len(req.tokens), rows))
                self.noise_s += time.perf_counter() - ts
        for name, arr in (("tokens", self.tokens), ("positions", self.positions),
                          ("active", active_mask), ("budgets", budgets),
                          ("eos_ids", eos_ids), ("temps", temps), ("top_ps", top_ps),
                          ("top_ks", top_ks)):
            buf[name].copy_(torch.from_numpy(arr))
        if self.paged:
            buf["tables"].copy_(torch.from_numpy(self.block_mgr.tables))
        return sampled

    def _multi_step(self, active: list[int]) -> list[Request]:
        """Super-step: ``decode_steps=N`` decode steps in one dispatch (on the card one
        CUDA graph replay), then ONE read of the ``[N, B]`` token buffer and the counts.

        Finishing lanes freeze inside (EOS / remaining-budget masking; a frozen lane's
        writes drop, so its last token is never written, as in the N = 1 loop), which
        makes the streams the N = 1 engine's: greedy lanes take the argmax, sampled lanes
        the same filter and the noise their emissions would draw. The drain is
        step-major, lane-minor — generation order, so ``on_token`` transcripts equal the
        token lists — and clamps each lane to its budget. Admission and eviction act
        between super-steps; the fault boundary and the watchdog wrap the whole
        super-step."""
        tracer = self.tracer
        tracing = tracer is not None and tracer.enabled  # the two-attribute-read contract
        ts0 = tracer._clock() if tracing else 0.0
        traced = [(i, self.slot_req[i]) for i in active] if tracing else ()
        t0 = time.perf_counter()
        N = self.multi_step
        t_guard = self._pre_dispatch("serving.decode", active)
        sampled = self._load_super_step(active)
        with compile_label("serving.decode_multi" + ("_paged" if self.paged else "")):
            tok_buf, counts, logits = self._super_runner(sampled)()
        self.dispatch_s += time.perf_counter() - t0
        host = torch.cat([tok_buf, counts[None]])
        # While the device runs the super-step, draw the next window's noise of each
        # sampled lane, as if it emits N tokens (a lane that finishes needs none).
        ts = time.perf_counter()
        self._noise_ahead = {
            req.uid: self._noise_rows(req, len(req.tokens) + N)
            for req in (self.slot_req[i] for i in active) if req.gen.temperature > 0.0
            and len(req.tokens) + N < req.gen.max_new_tokens}
        self.noise_ahead_s += time.perf_counter() - ts
        host = host.cpu().numpy()  # the one host read
        self._post_dispatch(t_guard)  # the watchdog, before any token lands
        tok_host, counts_host = host[:N], host[N]
        self.last_logits = logits
        for j in range(N):
            for i in active:
                req = self.slot_req[i]
                if j >= counts_host[i] or len(req.tokens) >= req.gen.max_new_tokens:
                    continue
                tok = int(tok_host[j, i])
                req.tokens.append(tok)
                if req.on_token is not None:
                    req.on_token(tok)
        finished = []
        step_tokens = 0
        for i in active:
            req = self.slot_req[i]
            c = int(counts_host[i])
            step_tokens += c
            self.tokens[i] = int(tok_host[c - 1, i])  # the new pending token
            self.positions[i] += c
            eos = req.gen.eos_token_id
            hit_eos = eos is not None and req.tokens and req.tokens[-1] == eos
            if hit_eos or len(req.tokens) >= req.gen.max_new_tokens:
                req.done = True
                finished.append(req)
                self.slot_req[i] = None
                self._release_lane(i)
        self.positions = np.minimum(self.positions, self.max_len - 1)
        self.decode_steps += 1
        self.decode_tokens += step_tokens
        self.decode_s += time.perf_counter() - t0
        if tracing:
            # One span per traced lane for the whole super-step: its own emissions, the
            # fused depth, and ONE inter-dispatch gap for N tokens.
            t1 = tracer._clock()
            host_s = self._host_gap(ts0, t1)
            for i, req in traced:
                tracer.span(tracer.handle_for(req.uid), "decode", ts0, t1,
                            step=self.decode_steps, occupancy=len(active),
                            tokens=int(counts_host[i]), n_steps=N, host_s=host_s)
        return finished

    def _noise_rows(self, req: Request, start: int, n: Optional[int] = None) -> dict:
        """{emission: Gumbel noise row [V]} of ``req``'s emissions ``start ..
        start + n - 1`` (default n: N) up to its budget's last: each the noise
        :meth:`Request._sample` draws at that emission (rows drawn ahead are taken, not
        drawn again)."""
        ahead = self._noise_ahead.get(req.uid, {})
        stop = min(start + (n or self.multi_step), req.gen.max_new_tokens)
        return {e: ahead[e] if e in ahead else
                gumbel_noise((1, self.cfg.vocab_size), emission_generator(req.seed, e))[0]
                for e in range(start, stop)}

    def _noise_window(self, req: Request, start: int, n: Optional[int] = None) -> torch.Tensor:
        """[n, V] noise (default n: N): row j is emission ``start + j``'s, clamped at
        the budget's last emission (the lane freezes there; later rows are never
        read). The window's rows are kept as drawn ahead: a speculative step emits
        fewer than n tokens, and the next window reads the rest again."""
        n = n or self.multi_step
        rows = self._noise_ahead[req.uid] = self._noise_rows(req, start, n)
        last = max(rows)
        return torch.stack([rows[min(start + j, last)] for j in range(n)])

    # ------------------------------------------------------------------ speculation
    def _spec_step(self, active: list[int]) -> list[Request]:
        """Host-loop speculative step: propose → ONE verify over ``[B, k+1]`` → per-lane
        prefix acceptance. A lane emits the first ``n_emit`` tokens of its reference row
        (the verify's argmax when greedy, the replayed draws or the Leviathan round when
        sampled): accepted proposals equal their reference tokens and the first
        mismatch already holds the correction; the budget caps the emissions and an EOS
        ends them. On the card the step runs eagerly."""
        tracer = self.tracer
        tracing = tracer is not None and tracer.enabled  # the two-attribute-read contract
        ts0 = tracer._clock() if tracing else 0.0
        traced: list = []
        t0 = time.perf_counter()
        k, T, dev = self.spec_k, self.spec_k + 1, self.device
        live = {r.uid for r in self.slot_req if r is not None}
        self._noise_ahead = {u: v for u, v in self._noise_ahead.items() if u in live}
        proposals = np.asarray(
            self.drafter.propose(self.slot_req, self.tokens, self.positions, k), np.int32)
        seq = np.zeros((self.max_slots, T), np.int32)
        seq[:, 0] = self.tokens  # the pending token: emitted last step, not yet written
        seq[:, 1:] = proposals
        t_guard = self._pre_dispatch("serving.decode", active)
        seq_t, pos_t = torch.from_numpy(seq).to(dev), torch.from_numpy(self.positions).to(dev)
        if self.paged:
            with compile_label("serving.spec_verify_paged"):
                greedy, logits, self.cache = _spec_verify_step_paged(
                    self.params, self.cache, torch.from_numpy(self.block_mgr.tables).to(dev),
                    seq_t, pos_t, self.cfg, self.page_size)
        else:
            with compile_label("serving.spec_verify"):
                greedy, logits, self.cache = _spec_verify_step(self.params, self.cache,
                                                               seq_t, pos_t, self.cfg)
        self.dispatch_s += time.perf_counter() - t0
        greedy_host = greedy.cpu().numpy()  # [B, k+1]
        self._post_dispatch(t_guard)  # the watchdog, before any token lands
        self.last_logits = logits[:, 0, :]
        finished = []
        step_tokens = step_accepted = 0
        for i in active:
            req = self.slot_req[i]
            limit = min(T, req.gen.max_new_tokens - len(req.tokens))  # the budget cap
            if req.gen.temperature > 0.0 and self.spec_accept == "residual":
                emitted_vec, count = self._residual_round(req, logits[i], proposals[i])
                emitted = [int(t) for t in emitted_vec[:min(count, limit)]]
            else:
                ref = (greedy_host[i] if req.gen.temperature <= 0.0
                       else self._replay_round(req, logits[i]))
                n = 0
                while n < k and proposals[i, n] == ref[n]:
                    n += 1
                emitted = [int(t) for t in ref[:min(n + 1, limit)]]
            eos = req.gen.eos_token_id
            if eos is not None and eos in emitted:
                emitted = emitted[:emitted.index(eos) + 1]
            # Accepted: emitted tokens that were proposals (the trailing correction or
            # bonus is the target's own).
            accepted_i = sum(1 for j, t in enumerate(emitted)
                             if j < k and t == int(proposals[i, j]))
            if tracing:
                traced.append((req, len(emitted), accepted_i))
            step_accepted += accepted_i
            step_tokens += len(emitted)
            self.tokens[i] = emitted[-1]
            self.positions[i] += len(emitted)
            for tok in emitted:
                req.tokens.append(tok)
                if req.on_token is not None:
                    req.on_token(tok)
            hit_eos = eos is not None and emitted[-1] == eos
            if hit_eos or len(req.tokens) >= req.gen.max_new_tokens:
                req.done = True
                finished.append(req)
                self.slot_req[i] = None
                self._release_lane(i)
        self.positions = np.minimum(self.positions, self.max_len - 1)
        self.decode_steps += 1
        self.decode_tokens += step_tokens
        self.spec_proposed += k * len(active)
        self.spec_accepted += step_accepted
        self.decode_s += time.perf_counter() - t0
        if tracing:
            t1 = tracer._clock()
            host_s = self._host_gap(ts0, t1)
            for req, n_emitted, n_accepted in traced:
                tracer.span(tracer.handle_for(req.uid), "decode", ts0, t1,
                            step=self.decode_steps, occupancy=len(active),
                            tokens=n_emitted, proposed=k, accepted=n_accepted,
                            host_s=host_s)
        self._emit_spec(1, len(active), k * len(active), step_accepted, step_tokens)
        return finished

    def _replay_round(self, req: Request, logits_rows: torch.Tensor) -> np.ndarray:
        """A sampled lane's REPLAY reference row: the tokens ``spec_k=0`` decode draws
        at each verify position, position j with the noise row of emission
        ``len(tokens) + j`` (clamped at the budget's last), bitwise
        :meth:`Request._sample` at that emission."""
        ts = time.perf_counter()
        noise = self._noise_window(req, len(req.tokens), self.spec_k + 1)
        self.noise_s += time.perf_counter() - ts
        return _replay_draws(logits_rows, noise.to(logits_rows.device), req.gen.temperature,
                             req.gen.top_p, req.gen.top_k).cpu().numpy()

    def _residual_round(self, req: Request, logits_rows: torch.Tensor, drafts: np.ndarray):
        """A sampled lane's Leviathan round (``spec_accept="residual"``) → (emitted row,
        count): emission m (clamped at the budget's last) draws its accept uniform and
        its residual noise from ``emission_generator(seed, m)``. Lossless in
        distribution, not bitwise the plain draw."""
        start, last = len(req.tokens), req.gen.max_new_tokens - 1
        gens = [emission_generator(req.seed, min(start + j, last))
                for j in range(self.spec_k + 1)]
        emitted, count = _spec_residual(
            logits_rows, torch.from_numpy(drafts).to(logits_rows.device), gens,
            req.gen.temperature, req.gen.top_p, req.gen.top_k)
        host = torch.cat([emitted, count.reshape(1).to(torch.int32)]).cpu().numpy()
        return host[:-1], int(host[-1])

    def _spec_super_step(self, sample: bool):
        """One fused speculative super-step over the static inputs → (drained int32
        vector, last round's position-0 logits)."""
        b = self._mbuf
        return _spec_multi_step(
            self.params, self.cache, b.get("tables"), b["tokens"], b["positions"],
            b["active"], b["budgets"], b["eos_ids"], b["noise"], b["temps"], b["top_ps"],
            b["top_ks"], b["history"], b["hist_lens"], self.cfg, self.multi_step,
            self.spec_k, int(self.drafter.max_ngram), sample, self.page_size)

    def _spec_key(self, sampled: bool) -> tuple:
        return (self.multi_step, self.spec_k, int(self.drafter.max_ngram), sampled,
                self.paged)

    def _spec_runner(self, sampled: bool):
        """The fused speculative runner of key ``(N, k, max_ngram, sampled, paged)``."""
        key = self._spec_key(sampled)
        run = self.spec_graphs.get(key)
        if run is None:
            run = self.spec_graphs[key] = self._graph(
                functools.partial(self._spec_super_step, sampled))
        return run

    def _load_spec_step(self, active: list[int]) -> bool:
        """:meth:`_load_super_step` with N·(k+1) noise rows a sampled lane, plus each
        lane's drafting history: prompt + generated tokens packed from column 0 (the
        last ``max_len``)."""
        sampled = self._load_super_step(active, self.multi_step * (self.spec_k + 1))
        history = np.zeros((self.max_slots, self.max_len), np.int32)
        hist_lens = np.zeros((self.max_slots,), np.int32)
        for i in active:
            req = self.slot_req[i]
            ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.tokens, np.int32)])[-self.max_len:]
            history[i, :len(ctx)] = ctx
            hist_lens[i] = len(ctx)
        self._mbuf["history"].copy_(torch.from_numpy(history))
        self._mbuf["hist_lens"].copy_(torch.from_numpy(hist_lens))
        return sampled

    def _spec_multi(self, active: list[int]) -> list[Request]:
        """Fused speculative super-step: ``decode_steps=N`` draft → verify → accept
        rounds in one dispatch (on the card one CUDA graph replay), then ONE read of
        the round buffers. Each lane's noise cursor advances by its own emissions, so
        its tokens are the host loop's, bitwise. The drain is round-major, lane-minor
        (the order N host-loop steps append), clamped to each lane's budget."""
        tracer = self.tracer
        tracing = tracer is not None and tracer.enabled  # the two-attribute-read contract
        ts0 = tracer._clock() if tracing else 0.0
        traced = [(i, self.slot_req[i]) for i in active] if tracing else ()
        t0 = time.perf_counter()
        N, k, B = self.multi_step, self.spec_k, self.max_slots
        T = k + 1
        t_guard = self._pre_dispatch("serving.decode", active)
        sampled = self._load_spec_step(active)
        with compile_label("serving.spec_multi" + ("_paged" if self.paged else "")):
            vec, logits = self._spec_runner(sampled)()
        self.dispatch_s += time.perf_counter() - t0
        # While the device runs, draw each sampled lane's noise rows up to two windows
        # ahead (the next window starts at most N·(k+1) emissions later); the rows of
        # this window are taken, not drawn again.
        ts = time.perf_counter()
        self._noise_ahead = {
            req.uid: self._noise_rows(req, len(req.tokens), 2 * N * T)
            for req in (self.slot_req[i] for i in active) if req.gen.temperature > 0.0
            and len(req.tokens) + N < req.gen.max_new_tokens}
        self.noise_ahead_s += time.perf_counter() - ts
        host = vec.cpu().numpy()  # the one host read
        self._post_dispatch(t_guard)  # the watchdog, before any token lands
        o = N * B * T
        ref_host = host[:o].reshape(N, B, T)
        emits_host = host[o:o + N * B].reshape(N, B)
        counts_host, prop_host, acc_host = host[o + N * B:].reshape(3, B)
        self.last_logits = logits
        last_tok = [0] * B
        for r in range(N):
            for i in active:
                req = self.slot_req[i]
                for j in range(int(emits_host[r, i])):
                    if len(req.tokens) >= req.gen.max_new_tokens:
                        break
                    tok = int(ref_host[r, i, j])
                    last_tok[i] = tok
                    req.tokens.append(tok)
                    if req.on_token is not None:
                        req.on_token(tok)
        finished = []
        step_tokens = 0
        for i in active:
            req = self.slot_req[i]
            c = int(counts_host[i])
            step_tokens += c
            self.tokens[i] = last_tok[i]  # the new pending token (c >= 1)
            self.positions[i] += c
            eos = req.gen.eos_token_id
            hit_eos = eos is not None and req.tokens and req.tokens[-1] == eos
            if hit_eos or len(req.tokens) >= req.gen.max_new_tokens:
                req.done = True
                finished.append(req)
                self.slot_req[i] = None
                self._release_lane(i)
        self.positions = np.minimum(self.positions, self.max_len - 1)
        step_proposed, step_accepted = int(prop_host.sum()), int(acc_host.sum())
        self.decode_steps += 1
        self.decode_tokens += step_tokens
        self.spec_proposed += step_proposed
        self.spec_accepted += step_accepted
        self.decode_s += time.perf_counter() - t0
        if tracing:
            t1 = tracer._clock()
            host_s = self._host_gap(ts0, t1)
            for i, req in traced:
                tracer.span(tracer.handle_for(req.uid), "decode", ts0, t1,
                            step=self.decode_steps, occupancy=len(active),
                            tokens=int(counts_host[i]), n_steps=N,
                            proposed=int(prop_host[i]), accepted=int(acc_host[i]),
                            host_s=host_s)
        self._emit_spec(N, len(active), step_proposed, step_accepted, step_tokens)
        return finished

    def run(self, report_throughput: bool = False):
        """Drain the queue, the bisection hold and the lanes; returns the finished
        requests (and tokens/s over the drain when ``report_throughput``, also emitted
        as a ``serving.throughput/v1`` record with a telemetry attached)."""
        out = []
        t0 = time.perf_counter()
        while self.queue or self._bisect_hold or any(r is not None for r in self.slot_req):
            out.extend(self.step())
        dt = time.perf_counter() - t0
        if report_throughput:
            n_tokens = sum(len(r.tokens) for r in out)
            tokens_per_sec = n_tokens / dt if dt > 0 else float("inf")
            self._emit_telemetry({
                "schema": SERVING_THROUGHPUT_SCHEMA, "wall_s": round(dt, 6),
                "tokens_generated": n_tokens, "requests_finished": len(out),
                "tokens_per_sec": (round(tokens_per_sec, 3)
                                   if tokens_per_sec != float("inf") else None)})
            return out, tokens_per_sec
        return out

    def warm_programs(self, max_new_tokens: int = 32) -> list:
        """Capture, ahead of traffic, every CUDA graph this engine can dispatch for
        requests of up to ``max_new_tokens`` new tokens, so that traffic captures none
        (the JAX engine compiles the same surface into its AOT cache):

        - the super-step of each ``(N, sampled, paged)`` key when ``decode_steps > 1``
          (both ``sampled`` variants: a mixed workload alternates them; a speculative
          engine dispatches it while speculation is off);
        - the fused speculative super-step of each ``(N, k, max_ngram, sampled, paged)``
          key when speculation runs fused;
        - the drafter's own graphs (``drafter.warm_programs``: a ``ModelDrafter``'s
          draft round);
        - one prefill per bucket that ``_plan_prefill`` can route such a request to,
          and the first-chunk + chunk-append pair when one chunk plus the budget fits
          ``max_len`` (the fall-back of prompts no bucket fits);
        - with ``prefix_cache``, the prefix layout's full-logits and keep programs
          instead of the buckets and the pair.

        By role: a decode engine's surface holds no prefill program (adoption's page
        import, boundary copy and valid-row write run eagerly); a prefill engine's
        holds no decode, super-step or verify graph (it has none to dispatch).

        The host-loop speculative step (``decode_steps=1``) runs eagerly and has no
        graph. Each graph's eager first call runs on idle inputs: every lane frozen
        (a super-step writes nothing), every draft position at the cache end (its
        writes drop) and all-pad rows into the prefill row cache (a scratch buffer).
        The cache, valid rows, pages, block manager and counters are left as they were.
        Returns one entry per program: its JAX name, key, capture seconds and pool
        bytes (graphs already captured report their numbers again); on the CPU, where
        nothing is captured, the entries only enumerate the surface (``capture_s`` and
        ``pool_bytes`` None)."""
        entries = []
        paged = "_paged" if self.paged else ""
        for key in self._program_surface(max_new_tokens):
            if key[0] == "draft":
                entries.extend(self.drafter.warm_programs(self, max_new_tokens))
                continue
            if isinstance(key[0], int):
                runners, name = self.graphs, "serving.decode_multi" + paged
            elif key[0] == "spec":
                runners, name = self.spec_graphs, "serving.spec_multi" + paged
            else:
                runners, name = self.prefill_graphs, _PREFILL_PROGRAMS[key[0]][2]
            rkey = key[1:] if key[0] == "spec" else key
            if self.device.type == "cuda" and rkey not in runners:
                self._warm_one(key)
            run = runners.get(rkey)
            entries.append({"name": name, "key": list(key),
                            "capture_s": getattr(run, "capture_s", None),
                            "pool_bytes": getattr(run, "pool_bytes", None)})
        return entries

    def _program_surface(self, max_new_tokens: int) -> list:
        """The graph keys ``warm_programs`` covers: ``(N, sampled, paged)`` super-steps,
        ``("spec", N, k, max_ngram, sampled, paged)`` fused speculative super-steps,
        ``("draft", k)`` for the drafter's graphs, then ``(program, width)`` prefills."""
        keys = []
        if self.multi_step > 1:
            keys += [(self.multi_step, sampled, self.paged) for sampled in (False, True)]
        if self.spec_k and self._spec_fused():
            keys += [("spec", *self._spec_key(sampled)) for sampled in (False, True)]
        if isinstance(self.drafter, ModelDrafter):
            keys.append(("draft", self.spec_k))
        if self.role == "decode":
            return keys  # a decode engine never prefills
        if self.prefix_cache_size:
            keys += [("full_logits", self.prompt_bucket), ("keep", self.prompt_bucket)]
        else:
            # Only buckets a request with this budget can land in.
            keys += [("prefill", b) for b in self.prompt_buckets or ()
                     if b + max_new_tokens <= self.max_len]
            if self.prompt_bucket + max_new_tokens <= self.max_len:
                keys += [("prefill", self.prompt_bucket), ("chunk", self.prompt_bucket)]
        return list(dict.fromkeys(keys))  # a rung may equal the chunk width

    def _warm_one(self, key: tuple) -> None:
        """Run the program of graph ``key`` once on idle inputs (on the card its first
        call: eager, then captured): a super-step (plain or speculative) with every lane
        frozen, which writes nothing; the draft round with every position at the cache
        end; a prefill program on an all-pad row into the row cache."""
        if isinstance(key[0], int):
            self._load_super_step([])
            self._super_runner(key[1])()
        elif key[0] == "spec":
            self._load_spec_step([])
            self._spec_runner(key[4])()
        elif key[0] == "draft":
            self.drafter.warm_one(key[1])
        else:
            pad = np.zeros((1, key[1]), np.int32)
            self._run_prefill(*key, pad, pad.astype(bool))

    @property
    def prefill_pool_bytes(self) -> int:
        """Device bytes of the prefill graphs' shared memory pool (0 on the CPU)."""
        return sum(getattr(run, "pool_bytes", None) or 0
                   for run in self.prefill_graphs.values())

    # ------------------------------------------------------------------ admission
    def _plan_prefill(self, prompt_len: int, max_new: int):
        """Prefill layout for one prompt: ``("bucket", width)`` when the bucket ladder
        is on (and no prefix cache) and a rung fits prompt + budget, else
        ``("chunk", total)``: the prompt padded to a whole number of ``prompt_bucket``
        chunks; raises when that plus the budget does not fit ``max_len``. Prompts no
        bucket fits fall back to chunks: bucketing never shrinks the admissible set."""
        if self.prompt_buckets is not None and not self.prefix_cache_size:
            bucket = pick_bucket(prompt_len, self.prompt_buckets)
            if bucket is not None and bucket + max_new <= self.max_len:
                return "bucket", bucket
        n_chunks = max(1, -(-prompt_len // self.prompt_bucket))
        total = n_chunks * self.prompt_bucket
        if total + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len} tokens → {n_chunks} chunks of "
                f"{self.prompt_bucket}) + max_new_tokens={max_new} exceeds "
                f"max_len={self.max_len}"
            )
        return "chunk", total

    def _admit(self) -> list[Request]:
        """Fill free lanes from the queue head (FIFO). A paged admission that does not
        fit the free pool defers: the head keeps its place and admission stops. A
        recovery re-admission prefills the request's context (prompt + emitted tokens)
        for its remaining budget; with recovery armed, a prefill fault quarantines the
        admitting request (``prefill_fault:<kind>``)."""
        finished = []
        for slot in range(self.max_slots):
            # A request can finish AT admission (EOS or max_new_tokens == 1), freeing
            # the lane for the next queued request — hence the inner loop.
            while self.slot_req[slot] is None and self.queue:
                req = self.queue[0]
                ctx = req._recover_ctx if req._recover_ctx is not None else req.prompt
                remaining = req.gen.max_new_tokens - len(req.tokens)
                try:
                    if self.prefix_cache_size and req._recover_ctx is not None:
                        chunks = max(1, -(-len(ctx) // self.prompt_bucket))
                        if chunks * self.prompt_bucket + remaining > self.max_len:
                            raise ValueError(
                                f"recovery context ({len(ctx)} tokens → "
                                f"{chunks * self.prompt_bucket} padded) + remaining budget "
                                f"{remaining} exceeds max_len={self.max_len}")
                    plan = self._plan_prefill(len(ctx), remaining)
                except ValueError as e:
                    if req._recover_ctx is None or not self.recover:
                        raise
                    # The grown context can overflow where the prompt fit: fail this
                    # request machine-readably and keep serving the rest.
                    self.queue.popleft()
                    finished.append(self._quarantine(req, f"recovery_unservable:{e}"))
                    continue
                fp = self.faults
                if fp is not None and self.recover:
                    spec = fp.draw("serving.prefill", uid=req.uid)
                    if spec is not None and spec.kind == "crash":
                        self.crashed = True
                        raise EngineCrashed("serving.prefill", uid=req.uid)
                    if spec is not None:
                        # Always attributable, and nothing was launched: quarantine.
                        self.queue.popleft()
                        self.step_failures += 1
                        self._emit_fault("serving.prefill", spec.kind, req.uid,
                                         reason=f"injected:{spec.kind}")
                        finished.append(self._quarantine(req, f"prefill_fault:{spec.kind}"))
                        continue
                tracer = self.tracer
                tracing = tracer is not None and tracer.enabled
                if tracing:
                    t_pf0 = tracer._clock()
                    hits0 = self.prefix_hits
                    cow0 = self.block_mgr.cow_count if self.paged else 0
                    adopt0 = self.block_mgr.adopt_count if self.paged else 0
                t0 = time.perf_counter()
                try:
                    prefilled = self._prefill_into_slot(slot, req, plan, ctx, remaining)
                except EngineCrashed:
                    raise
                except Exception as e:
                    if not self.recover:
                        raise
                    # The admitting request is certainly the one; the row copy into the
                    # engine cache may have run, so survivors rebuild unless the fault
                    # fired before any launch.
                    self.queue.popleft()
                    self.step_failures += 1
                    kind = getattr(e, "kind", type(e).__name__)
                    self._emit_fault(getattr(e, "site", "serving.prefill"), kind, req.uid,
                                     reason=str(e))
                    finished.append(self._quarantine(req, f"prefill_fault:{kind}"))
                    if not getattr(e, "pre_dispatch", False):
                        self._rebuild_survivors()
                    return finished
                if prefilled is None:
                    if tracing:
                        tracer.count_defer(req.uid)
                    return finished
                self.queue.popleft()
                if req._recover_ctx is None:
                    self.queue_waits.append(max(0.0, time.monotonic() - req.enqueued_at))
                # The first token is read before any other prefill replays (the greedy
                # token and logits may be a graph's outputs).
                greedy, logits, prefill_len = prefilled
                first = (int(greedy[0]) if req.gen.temperature <= 0.0
                         else req._sample(logits[0]))
                if self.drafter is not None:
                    # The same lane and padded layout: engine positions index both.
                    self.drafter.admit(slot, ctx, plan)
                self.prefill_s += time.perf_counter() - t0
                self.admitted += 1
                if req._recover_ctx is not None:
                    # The prefill replayed prompt + emitted tokens: ``first`` is the
                    # next emission.
                    req._recover_ctx = None
                    req.recoveries += 1
                    self.recovered_admissions += 1
                    self.recovered_uids.add(req.uid)
                    self._emit_recovery("readmit", uid=req.uid, tokens_kept=len(req.tokens))
                self.slot_req[slot] = req
                self.positions[slot] = prefill_len  # next write = first decode slot
                self.tokens[slot] = first
                req.tokens.append(first)
                if req.on_token is not None:
                    req.on_token(first)
                if tracing:
                    # Closes after the first token is read and streamed, so queue +
                    # prefill reconstructs TTFT.
                    handle = tracer.handle_for(req.uid)
                    t_pf1 = tracer._clock()
                    hit = self.prefix_hits > hits0
                    mode, width = plan
                    if self.prefix_cache_size:
                        mode = "prefix" if hit else "chunk"
                    tracer.event(handle, "admit", t=t_pf0, lane=slot,
                                 kv_defer_retries=handle.kv_defers if handle else 0)
                    tracer.span(handle, "prefill", t_pf0, t_pf1, mode=mode,
                                width=int(width), prompt_len=len(ctx), prefix_hit=hit,
                                cow=(self.block_mgr.cow_count - cow0) if self.paged else 0,
                                adopted_pages=((self.block_mgr.adopt_count - adopt0)
                                               if self.paged else 0))
                hit_eos = req.gen.eos_token_id is not None and first == req.gen.eos_token_id
                if hit_eos or len(req.tokens) >= req.gen.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self.slot_req[slot] = None
                    self._release_lane(slot)
                    self.evicted += 1
        return finished

    def _prefill_into_slot(self, slot: int, req: Request, plan, ctx: np.ndarray,
                           remaining: int):
        """Prefill one request's context ``ctx`` (its prompt, or on a recovery
        re-admission prompt + emitted tokens, for ``remaining`` new tokens) and land
        its KV in lane ``slot`` → ``(greedy, logits, prefill_len)``, or None when a
        paged admission must defer on pool pressure (nothing consumed; the request
        stays queued). Dense: the row (left-padded, or right-aligned with the prefix
        cache) is copied into the lane's row; paged: see
        :meth:`_prefill_into_slot_paged`."""
        if self.paged:
            return self._prefill_into_slot_paged(slot, req, plan, ctx, remaining)
        if self.prefix_cache_size:
            out = self._prefill_prefix_cached(ctx)
        else:
            out = self._prefill(ctx, plan)
        self.cache = _insert_row(self.cache, self._row, slot)
        return out

    def _prefill_into_slot_paged(self, slot: int, req: Request, plan, ctx: np.ndarray,
                                 remaining: int):
        """Paged admission: allocate the lane's pages (adopting a registered prefix's
        full pages read-only on a hit, with the divergent partial page re-materialized
        as an owned one: copy-on-write), prefill the same dense row as the dense
        engine, scatter it into the owned pages through the write-id map, then
        register the prompt's prefixes as page lists."""
        mgr = self.block_mgr
        ps = self.page_size
        prompt, max_new = ctx, remaining
        hit_len, entry, lookup_chunks = 0, None, 0
        if self.prefix_cache_size:
            n_chunks = max(1, -(-len(prompt) // self.prompt_bucket))
            total = n_chunks * self.prompt_bucket
            hit_len, entry, lookup_chunks = self._lookup_prefix_paged(prompt, n_chunks)
        else:
            _, total = plan
        adopted = [] if entry is None else list(entry.pages[: hit_len // ps])
        cow_partial = hit_len > 0 and hit_len % ps != 0
        # A prefill-role lane holds the context pages only (the decode replica charges
        # the budget's at adoption).
        n_tokens = total if self.role == "prefill" else total + max_new
        # Pool pressure: the registry is a cache and yields to live traffic — evict
        # LRU entries (releasing their pages) before deferring, then the adopted entry
        # itself (the request retries as a miss); submit's KVBudgetError bound makes
        # the bare request fit an otherwise empty pool, so registry pages never starve
        # an admission once every lane has drained.
        while not mgr.can_admit(n_tokens, n_adopted=len(adopted)):
            if self._evict_prefix_lru(keep=entry):
                continue
            if entry is not None:
                hit_len, entry, adopted, cow_partial = 0, None, [], False
                self._evict_prefix_lru()
                continue
            mgr.defer_count += 1
            return None
        # Counted only now, when the admission proceeds: a deferred request repeats
        # the lookup every step, and an adoption dropped above is served as a miss.
        if lookup_chunks:
            if entry is not None:
                self.prefix_hits += 1
                self._prefix_reg.move_to_end(prompt[:hit_len].tobytes())
            else:
                self._classify_prefix_miss(prompt, lookup_chunks)
        if self.prefix_cache_size:
            out = self._prefill_prefix_paged(prompt, hit_len, entry, n_chunks, total)
        else:
            out = self._prefill(prompt, plan)
        fp = self.faults
        if fp is not None and self.recover:
            spec = fp.draw("serving.kv_admit", uid=req.uid)
            if spec is not None:
                # An injected page-pool allocation failure, raised before the manager
                # is touched: nothing leaks, and the admission boundary quarantines
                # this request.
                raise fp.fault_for(spec, "serving.kv_admit", uid=req.uid)
        ids = mgr.admit(slot, n_tokens, adopted=adopted, cow_partial=cow_partial)
        # The lane's valid layout, which a handoff carries: the prefix layout is
        # left-aligned ([0, len)), bucket and chunk layouts are left-padded
        # ([pad, total)).
        self._lane_valid[slot] = ((0, len(prompt)) if self.prefix_cache_size
                                  else (total - len(prompt), total))
        # Row scatter: the adopted pages (never written: the last chunk is always
        # recomputed past them) and everything past the row route to the sentinel;
        # decode writes continue directly into the lane's remaining pages.
        n_row_pages = pages_for(total, ps)
        write_ids = np.full((mgr.max_pages,), mgr.SENTINEL, np.int32)
        write_ids[len(adopted):n_row_pages] = ids[len(adopted):n_row_pages]
        written = write_ids[write_ids != mgr.SENTINEL]
        assert (mgr.refcount[written] == 1).all(), "a row scatter would write a shared page"
        self.cache = _insert_row_paged(self.cache, self._row, write_ids, slot, ps)
        if self.prefix_cache_size:
            self._register_prefixes_paged(slot, prompt)
        return out

    def _lookup_prefix_paged(self, prompt: np.ndarray, n_chunks: int):
        """Longest registered full-chunk prefix of ``prompt`` → ``(hit length, entry,
        lookup_chunks)``, capped at ``n_chunks - 1`` chunks (the last chunk is always
        recomputed, for its logits). Counter-free and LRU-neutral: a deferred
        admission repeats it every step; ``lookup_chunks > 0`` tells the caller a
        countable lookup happened."""
        bucket = self.prompt_bucket
        full_chunks = min(len(prompt) // bucket, n_chunks - 1)
        for k in range(full_chunks, 0, -1):
            hit = self._prefix_reg.get(prompt[: k * bucket].tobytes())
            if hit is not None:
                return k * bucket, hit, full_chunks
        return 0, None, full_chunks

    def _classify_prefix_miss(self, prompt: np.ndarray, full_chunks: int) -> None:
        """Count one prefix miss, split capacity (key was evicted) vs cold key."""
        self.prefix_misses += 1
        bucket = self.prompt_bucket
        if any(prompt[: k * bucket].tobytes() in self._evicted_keys
               for k in range(full_chunks, 0, -1)):
            self.prefix_capacity_misses += 1
        else:
            self.prefix_key_misses += 1

    def _prefill_prefix_paged(self, prompt: np.ndarray, hit_len: int, entry,
                              n_chunks: int, total: int):
        """Right-aligned chunked prefill resuming from a page-list entry: on a hit the
        entry's pages are gathered back into the row cache (a copy that skips the
        prefix's prefill FLOPs) and the remaining chunks run the keep program; on a
        miss (``entry`` None) the first chunk runs the full-logits program. The
        caller scatters the row into the lane's own pages."""
        bucket = self.prompt_bucket
        row, mask = self._right_aligned(prompt, total)
        start = hit_len // bucket
        if entry is not None:
            read_ids = np.full((self.block_mgr.max_pages,), self.block_mgr.SENTINEL, np.int32)
            read_ids[: len(entry.pages)] = entry.pages
            _gather_row_paged(self.cache, self._row, read_ids, hit_len, self.page_size)
        logits = None
        for c in range(start, n_chunks):
            sl = slice(c * bucket, (c + 1) * bucket)
            name = "keep" if entry is not None or c > start else "full_logits"
            logits = self._run_prefill(name, bucket, row[:, sl], mask[:, sl])
        return self._last_of(logits, prompt)

    def _register_prefixes_paged(self, slot: int, prompt: np.ndarray) -> None:
        """Register every full-chunk prefix of ``prompt`` as a refcounted page list:
        full pages shared with the lane by refcount and, when the boundary cuts a page,
        an immutable copy of that page (the lane keeps writing its own) — N entries
        over one system prompt cost its pages once plus at most one page each."""
        mgr = self.block_mgr
        ps = self.page_size
        bucket = self.prompt_bucket
        lane_ids = mgr.lane_pages(slot)
        for c in range(1, len(prompt) // bucket + 1):
            key = prompt[: c * bucket].tobytes()
            if key in self._prefix_reg:
                self._prefix_reg.move_to_end(key)
                continue
            p_len = c * bucket
            n_full = p_len // ps
            pages = [int(p) for p in lane_ids[:n_full]]
            if p_len % ps:
                dst = mgr.take_copy_page()
                if dst is None:
                    continue  # pool too tight for a registry copy: skip, not fail
                self.cache = _copy_page(self.cache, int(lane_ids[n_full]), dst)
                mgr.retain(pages)
                pages = pages + [dst]
            else:
                mgr.retain(pages)
            self._register_prefix(key, _PagedPrefix(np.asarray(pages, np.int32)))

    def _run_prefill(self, name: str, width: int, row: np.ndarray, mask: np.ndarray):
        """Prefill program ``name`` on one ``[1, width]`` token row and its mask,
        written into the static buffers first; the row cache is ``self._row``. On the
        card the program replays its graph (captured at its first call), whose
        outputs the next replay of any prefill graph overwrites."""
        buf = self._pbuf.get(width)
        if buf is None:
            dev = self.device
            buf = self._pbuf[width] = (torch.zeros((1, width), dtype=torch.int32, device=dev),
                                       torch.zeros((1, width), dtype=torch.bool, device=dev))
        buf[0].copy_(torch.from_numpy(row))
        buf[1].copy_(torch.from_numpy(mask))
        run = self.prefill_graphs.get((name, width))
        if run is None:
            run = self.prefill_graphs[(name, width)] = self._prefill_runner(name, width)
        return run()

    def _prefill_runner(self, name: str, width: int):
        """The runner of prefill program ``name`` at ``width``: its graph on the card
        (all prefill graphs in one shared pool), the plain call on the CPU."""
        if self.device.type == "cuda" and self._prefill_pool is None:
            self._prefill_pool = torch.cuda.graph_pool_handle()
        return self._graph(self._prefill_call(name, width), pool=self._prefill_pool)

    def _prefill_call(self, name: str, width: int) -> Callable:
        """Prefill program ``name`` at ``width`` as a plain call over the static
        buffers."""
        fn, last_only, _ = _PREFILL_PROGRAMS[name]
        row, mask = self._pbuf[width]
        return functools.partial(fn, self.params, row, mask, self._row, self.cfg, last_only)

    def _prefill(self, prompt: np.ndarray, plan):
        """Left-padded single-row prefill into ``self._row`` → (greedy [1], last
        logits [1, V], decode start position): one dispatch at the bucket's width, or
        the first chunk then the chunk append over whole ``prompt_bucket`` chunks."""
        mode, total = plan
        pad = total - len(prompt)
        row = np.zeros((1, total), np.int32)
        row[0, pad:] = prompt
        mask = np.zeros((1, total), bool)
        mask[0, pad:] = True
        if mode == "bucket":
            if total in self._buckets_seen:
                self.bucket_hits += 1
            else:
                self.bucket_misses += 1
                self._buckets_seen.add(total)
            greedy, last = self._run_prefill("prefill", total, row, mask)
            return greedy, last, total
        bucket = self.prompt_bucket
        greedy, last = self._run_prefill("prefill", bucket, row[:, :bucket], mask[:, :bucket])
        for c in range(1, total // bucket):
            sl = slice(c * bucket, (c + 1) * bucket)
            greedy, last = self._run_prefill("chunk", bucket, row[:, sl], mask[:, sl])
        return greedy, last, total

    def _right_aligned(self, prompt: np.ndarray, total: int):
        """The prefix layout's row and mask: the prompt at positions [0, len), its last
        chunk padded at the end (the first decode write lands on the first pad)."""
        row = np.zeros((1, total), np.int32)
        row[0, :len(prompt)] = prompt
        mask = np.zeros((1, total), bool)
        mask[0, :len(prompt)] = True
        return row, mask

    def _last_of(self, logits: torch.Tensor, prompt: np.ndarray):
        """(greedy [1], logits [1, V], decode start) of the prompt's real last token,
        from a right-aligned chunk's per-position logits."""
        last = logits[:, (len(prompt) - 1) % self.prompt_bucket, :]
        return torch.argmax(last, dim=-1), last, len(prompt)

    def _prefill_prefix_cached(self, prompt: np.ndarray):
        """Dense right-aligned chunked prefill with prefix-snapshot reuse → (greedy,
        last logits, decode start). After each fully real chunk the row cache is
        cloned into the LRU registry under the prefix's bytes; a later prompt starting
        with the same chunks restores the longest registered snapshot and runs only
        the chunks after it."""
        bucket = self.prompt_bucket
        n_chunks = max(1, -(-len(prompt) // bucket))
        row, mask = self._right_aligned(prompt, n_chunks * bucket)
        full_chunks = len(prompt) // bucket  # only fully real chunks are cacheable
        hit, start = None, 0
        for k in range(full_chunks, 0, -1):
            key = prompt[: k * bucket].tobytes()
            hit = self._prefix_reg.get(key)
            if hit is not None:
                self._prefix_reg.move_to_end(key)
                start = k
                self.prefix_hits += 1
                _restore_row(self._row, hit)
                break
        if hit is None and full_chunks:
            self._classify_prefix_miss(prompt, full_chunks)
        logits = None
        for c in range(start, n_chunks):
            sl = slice(c * bucket, (c + 1) * bucket)
            name = "keep" if hit is not None or c > 0 else "full_logits"
            logits = self._run_prefill(name, bucket, row[:, sl], mask[:, sl])
            if c + 1 <= full_chunks:
                key = prompt[: (c + 1) * bucket].tobytes()
                if key in self._prefix_reg:
                    self._prefix_reg.move_to_end(key)
                else:
                    self._register_prefix(key, _snapshot_row(self._row))
        if logits is None:
            # The whole prompt is a registered prefix with no partial tail: run its
            # last chunk again for the logits, from the shorter snapshot (the rewrite
            # is idempotent), or from scratch when that one was evicted.
            sl = slice((start - 1) * bucket, start * bucket)
            prev = (self._prefix_reg.get(prompt[: (start - 1) * bucket].tobytes())
                    if start > 1 else None)
            if prev is not None:
                _restore_row(self._row, prev)
                logits = self._run_prefill("keep", bucket, row[:, sl], mask[:, sl])
            elif start == 1:
                logits = self._run_prefill("full_logits", bucket, row[:, sl], mask[:, sl])
            else:
                logits = self._recompute_all(row, mask, n_chunks)
        return self._last_of(logits, prompt)

    def _recompute_all(self, row: np.ndarray, mask: np.ndarray, n_chunks: int):
        bucket = self.prompt_bucket
        logits = self._run_prefill("full_logits", bucket, row[:, :bucket], mask[:, :bucket])
        for c in range(1, n_chunks):
            sl = slice(c * bucket, (c + 1) * bucket)
            logits = self._run_prefill("keep", bucket, row[:, sl], mask[:, sl])
        return logits

    def _register_prefix(self, key: bytes, value) -> None:
        """Insert one prefix entry (a row-cache clone, or a ``_PagedPrefix``) as the
        most recently used and enforce the LRU capacity."""
        self._prefix_reg[key] = value
        self._prefix_reg.move_to_end(key)
        while len(self._prefix_reg) > self.prefix_cache_size:
            self._evict_prefix_lru()

    def _evict_prefix_lru(self, keep=None) -> bool:
        """Evict the least recently used prefix entry (skipping ``keep``, the entry an
        admission in progress is adopting): counted in ``prefix_evictions``, its key
        remembered in the bounded evicted-key set (later misses on it are capacity
        misses), a paged entry's page references released. Returns False when nothing
        evictable remains."""
        victim = next((k for k, v in self._prefix_reg.items() if v is not keep), None)
        if victim is None:
            return False
        old = self._prefix_reg.pop(victim)
        self.prefix_evictions += 1
        self._evicted_keys[victim] = True
        self._evicted_keys.move_to_end(victim)
        while len(self._evicted_keys) > self._evicted_keys_cap:
            self._evicted_keys.popitem(last=False)
        if isinstance(old, _PagedPrefix):
            self.block_mgr.release(old.pages)
        return True
