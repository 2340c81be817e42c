"""Continuous-batching inference engine (slot-based KV cache, per-slot positions).

Counterpart of ``accelerate_tpu/serving.py``'s ``ContinuousBatcher`` for the plain
decode path, dense (``page_size=0``) and paged (``page_size > 0``):

- ``max_slots`` decode lanes share one cache; each lane has its own write position.
- Admission runs a chunked single-row prefill (``llama.forward_cached`` over a dense
  ``[1, max_len]`` row cache, the prompt left-padded to a whole number of
  ``prompt_bucket`` chunks) and copies the row into the engine cache: into the lane's
  row (dense), or through the lane's block table into pool pages (paged).
- Each ``step()`` advances every lane one token with ONE batched forward
  (``llama.forward_slots`` / ``forward_slots_paged``); paged decode attention runs in
  the CUDA kernel ``ops/paged_attention.py`` on the card.
- Paged admission allocates the lane's pages for prompt + budget up front
  (``paged_kv.BlockManager``) and DEFERS in FIFO order when the pool is short, so no
  table entry appears during a multi-step super-step.
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
CPU. Sampled requests take an integer ``seed``: emission ``i`` draws from a generator
seeded from ``(seed, i)`` (``generation.emission_generator``), so a request's tokens do
not depend on what else is in the batch.

Not in this slice (the constructor does not take them): prefix caching, speculative
decoding, disaggregated roles, fault injection and recovery, telemetry and tracing,
the compile cache and bucket ladders.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .generation import (GenerationConfig, emission_generator, gumbel_noise, sampling_core,
                         sampling_core_dyn_k)
from .models import llama
from .paged_kv import BlockManager, KVBudgetError, pages_for
from .utils.cuda_graph import CapturedStep

__all__ = ["ContinuousBatcher", "KVBudgetError", "Request", "normalize_submit"]


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


def _prefill_first_chunk(params, row, mask, cfg, max_len: int):
    """First prefill chunk into a fresh single-row cache → (greedy [1], last logits
    [1, V], row cache)."""
    cache = llama.init_cache(cfg, 1, max_len, device=row.device)
    logits, cache = llama.forward_cached(params, row, cache, cfg, token_mask=mask,
                                         last_only=True)
    last = logits[:, -1, :]
    return torch.argmax(last, dim=-1), last, cache


def _prefill_next_chunk(params, row, mask, cache, cfg):
    """Chunked prefill continuation: append one chunk to an existing row cache."""
    logits, cache = llama.forward_cached(params, row, cache, cfg, token_mask=mask,
                                         last_only=True)
    last = logits[:, -1, :]
    return torch.argmax(last, dim=-1), last, cache


class ContinuousBatcher:
    """Continuous-batching decode over ``max_slots`` shared lanes (greedy or sampled
    per request).

    ``submit()`` queues requests; ``step()`` admits queued requests into free lanes
    (prefill + row insert), advances every active lane one token with ONE batched
    forward (or up to ``decode_steps`` tokens in one super-step), and returns the
    requests finished this step. ``run()`` drains everything. The engine runs on the
    device its params live on.
    """

    def __init__(self, params, cfg, max_slots: int = 8, max_len: int = 512,
                 prompt_bucket: int = 64, page_size: int = 0,
                 kv_pages: Optional[int] = None, decode_steps: int = 1):
        llama.check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_slots = max_slots
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        if not isinstance(page_size, (int, np.integer)) or isinstance(page_size, bool):
            raise TypeError(f"page_size must be an int, got {type(page_size).__name__}")
        if page_size < 0:
            raise ValueError(f"page_size={page_size} must be >= 0 (0 = dense cache)")
        self.page_size = int(page_size)
        self.paged = self.page_size > 0
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
        #: Decode steps per dispatch (``decode_steps``; the JAX engine's name).
        self.multi_step = int(decode_steps)
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

    # ------------------------------------------------------------------ user API
    def stats(self) -> dict:
        """Engine counters: queue depth, busy lanes, admission/eviction totals, decode
        throughput and host-clock time in prefill and decode; paged engines add the
        page pool's occupancy and churn."""
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
                "kv_alloc_count": ms["alloc_count"],
                "kv_free_count": ms["free_count"],
                "kv_defer_count": ms["defer_count"],
            })
        return {
            **kv,
            "peak_active_slots": self.peak_active_slots,
            "queued": len(self.queue),
            "queue_wait_s": queue_wait_s,
            "active_slots": active,
            "max_slots": self.max_slots,
            "slot_occupancy": active / self.max_slots,
            "admitted": self.admitted,
            "evicted": self.evicted,
            "evicted_external": self.evicted_external,
            "multi_step": self.multi_step,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "tokens_per_step": (
                round(self.decode_tokens / self.decode_steps, 4)
                if self.decode_steps else None
            ),
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "dispatch_s": self.dispatch_s,
            "noise_s": self.noise_s,
            "noise_ahead_s": self.noise_ahead_s,
        }

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               gen: Optional[GenerationConfig] = None,
               seed: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None) -> Request:
        """Queue a request: ``max_new_tokens``/``eos_token_id`` (greedy) or a full
        ``gen`` — not both. Temperature sampling needs an integer ``seed``. Raises for
        a request the cache (or page pool) could never hold."""
        prompt, gen = normalize_submit(prompt, max_new_tokens, eos_token_id, gen, seed)
        self.kv_demand(len(prompt), gen.max_new_tokens)
        req = Request(self._uid, prompt, gen, seed, on_token=on_token,
                      enqueued_at=time.monotonic())
        self._uid += 1
        self.queue.append(req)
        return req

    def kv_demand(self, prompt_len: int, max_new: int) -> int:
        """Cache-token cost of one request under this engine's layout: the padded
        prefill width plus the budget (dense), or the page-granular worst case
        (paged). Raises ``ValueError`` for unservable geometry and
        :class:`KVBudgetError` when the demand exceeds the whole page pool."""
        _, total = self._plan_prefill(prompt_len, max_new)
        if self.paged:
            return self.block_mgr.demand(total + max_new) * self.page_size
        return total + max_new

    def cache_bytes(self) -> int:
        """Total bytes of the KV cache planes (scale planes included)."""
        return sum(t.numel() * t.element_size()
                   for planes in self.cache["layers"] for t in planes.values())

    def cancel(self, uid: int) -> bool:
        """Withdraw a request by uid: removed from the queue, or its lane freed now.
        Returns False when the uid is unknown or already finished."""
        for req in self.queue:
            if req.uid == uid:
                self.queue.remove(req)
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

    def _release_lane(self, slot: int) -> None:
        """Return a freed lane's pages to the pool (paged); a dense lane's row is
        simply overwritten at the next admission."""
        if self.paged:
            self.block_mgr.release_slot(slot)

    @torch.no_grad()
    def step(self) -> list[Request]:
        """Admit queued requests, then advance every active lane one token. Returns
        the requests finished this step, in submission order."""
        finished_at_admit = self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        self.peak_active_slots = max(self.peak_active_slots, len(active))
        if not active:
            return finished_at_admit
        decode = self._multi_step if self.multi_step > 1 else self._plain_step
        finished = decode(active)
        self.evicted += len(finished)
        return sorted(finished_at_admit + finished, key=lambda r: r.uid)

    def _plain_step(self, active: list[int]) -> list[Request]:
        """ONE batched forward advances every lane one token."""
        t0 = time.perf_counter()
        dev = self.device
        tokens = torch.tensor(self.tokens, device=dev)
        positions = torch.tensor(self.positions, device=dev)
        if self.paged:
            greedy, logits, self.cache = _decode_step_paged(
                self.params, self.cache, torch.tensor(self.block_mgr.tables, device=dev),
                tokens, positions, self.cfg, self.page_size,
            )
        else:
            greedy, logits, self.cache = _decode_step(
                self.params, self.cache, tokens, positions, self.cfg
            )
        self.dispatch_s += time.perf_counter() - t0
        greedy_host = greedy.cpu().numpy()
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
        return finished

    def _multi_buffers(self) -> dict:
        """The super-step's static inputs on the engine's device (made once: a captured
        graph reads them where they are; the host fills them before each super-step)."""
        if self._mbuf is None:
            B, N, dev = self.max_slots, self.multi_step, self.device

            def zeros(shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=dev)

            self._mbuf = {
                "tokens": zeros((B,), torch.int32), "positions": zeros((B,), torch.int32),
                "active": zeros((B,), torch.bool), "budgets": zeros((B,), torch.int32),
                "eos_ids": zeros((B,), torch.int32), "temps": zeros((B,), torch.float32),
                "top_ps": zeros((B,), torch.float32), "top_ks": zeros((B,), torch.int32),
                "noise": zeros((B, N, self.cfg.vocab_size), torch.float32),
            }
            if self.paged:
                self._mbuf["tables"] = zeros(self.block_mgr.tables.shape, torch.int32)
        return self._mbuf

    def _super_step(self, sample: bool):
        """One super-step over the static inputs → (tok_buf, counts, last logits)."""
        b, N = self._mbuf, self.multi_step
        lanes = (b["tokens"], b["positions"], b["active"], b["budgets"], b["eos_ids"],
                 b["noise"], b["temps"], b["top_ps"], b["top_ks"])
        if self.paged:
            out = _decode_multi_step_paged(self.params, self.cache, b["tables"], *lanes,
                                           self.cfg, N, sample, self.page_size)
        else:
            out = _decode_multi_step(self.params, self.cache, *lanes, self.cfg, N, sample)
        return out[:3]

    def _multi_step(self, active: list[int]) -> list[Request]:
        """Super-step: ``decode_steps=N`` decode steps in one dispatch (on the card one
        CUDA graph replay), then ONE read of the ``[N, B]`` token buffer and the counts.

        Finishing lanes freeze inside (EOS / remaining-budget masking; a frozen lane's
        writes drop, so its last token is never written, as in the N = 1 loop), which
        makes the streams the N = 1 engine's: greedy lanes take the argmax, sampled lanes
        the same filter and the noise their emissions would draw. The drain is
        step-major, lane-minor — generation order, so ``on_token`` transcripts equal the
        token lists — and clamps each lane to its budget. Admission and eviction act
        between super-steps."""
        t0 = time.perf_counter()
        N, B = self.multi_step, self.max_slots
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
                buf["noise"][i].copy_(self._noise_window(req, len(req.tokens)))
                self.noise_s += time.perf_counter() - ts
        for name, arr in (("tokens", self.tokens), ("positions", self.positions),
                          ("active", active_mask), ("budgets", budgets),
                          ("eos_ids", eos_ids), ("temps", temps), ("top_ps", top_ps),
                          ("top_ks", top_ks)):
            buf[name].copy_(torch.from_numpy(arr))
        if self.paged:
            buf["tables"].copy_(torch.from_numpy(self.block_mgr.tables))
        key = (N, sampled, self.paged)
        run = self.graphs.get(key)
        if run is None:
            run = functools.partial(self._super_step, sampled)
            if self.device.type == "cuda":
                run = CapturedStep(run, self.device)
            self.graphs[key] = run
        tok_buf, counts, logits = run()
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
        return finished

    def _noise_rows(self, req: Request, start: int) -> dict:
        """{emission: Gumbel noise row [V]} of ``req``'s emissions ``start ..
        start + N - 1`` up to its budget's last: each the noise :meth:`Request._sample`
        draws at that emission (rows drawn ahead are taken, not drawn again)."""
        ahead = self._noise_ahead.get(req.uid, {})
        stop = min(start + self.multi_step, req.gen.max_new_tokens)
        return {e: ahead[e] if e in ahead else
                gumbel_noise((1, self.cfg.vocab_size), emission_generator(req.seed, e))[0]
                for e in range(start, stop)}

    def _noise_window(self, req: Request, start: int) -> torch.Tensor:
        """[N, V] noise of a super-step's steps: step j draws emission ``start + j``,
        clamped at the budget's last emission (the lane freezes there; later rows are
        never read)."""
        rows = self._noise_rows(req, start)
        last = max(rows)
        return torch.stack([rows[min(start + j, last)] for j in range(self.multi_step)])

    def run(self, report_throughput: bool = False):
        """Drain queue + active lanes; returns the finished requests (and tokens/s
        over the drain when ``report_throughput``)."""
        out = []
        t0 = time.perf_counter()
        while self.queue or any(r is not None for r in self.slot_req):
            out.extend(self.step())
        dt = time.perf_counter() - t0
        if report_throughput:
            n_tokens = sum(len(r.tokens) for r in out)
            return out, (n_tokens / dt if dt > 0 else float("inf"))
        return out

    # ------------------------------------------------------------------ admission
    def _plan_prefill(self, prompt_len: int, max_new: int):
        """Chunked prefill layout for one prompt → ``("chunk", total)``: the prompt
        left-padded to a whole number of ``prompt_bucket`` chunks; raises when that
        plus the budget does not fit ``max_len``."""
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
        fit the free pool defers: the head keeps its place and admission stops."""
        finished = []
        for slot in range(self.max_slots):
            # A request can finish AT admission (EOS or max_new_tokens == 1), freeing
            # the lane for the next queued request — hence the inner loop.
            while self.slot_req[slot] is None and self.queue:
                req = self.queue[0]
                plan = self._plan_prefill(len(req.prompt), req.gen.max_new_tokens)
                t0 = time.perf_counter()
                prefilled = self._prefill_into_slot(slot, req, plan)
                if prefilled is None:
                    return finished
                self.queue.popleft()
                greedy, logits, prefill_len = prefilled
                first = (int(greedy[0]) if req.gen.temperature <= 0.0
                         else req._sample(logits[0]))
                self.prefill_s += time.perf_counter() - t0
                self.admitted += 1
                self.slot_req[slot] = req
                self.positions[slot] = prefill_len  # next write = first decode slot
                self.tokens[slot] = first
                req.tokens.append(first)
                if req.on_token is not None:
                    req.on_token(first)
                hit_eos = req.gen.eos_token_id is not None and first == req.gen.eos_token_id
                if hit_eos or len(req.tokens) >= req.gen.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self.slot_req[slot] = None
                    self._release_lane(slot)
                    self.evicted += 1
        return finished

    def _prefill_into_slot(self, slot: int, req: Request, plan):
        """Prefill one request and land its KV in lane ``slot`` →
        ``(greedy, logits, prefill_len)``, or None when a paged admission must defer
        on pool pressure (nothing consumed; the request stays queued)."""
        if not self.paged:
            row_cache, greedy, logits, prefill_len = self._prefill(req.prompt, plan)
            self.cache = _insert_row(self.cache, row_cache, slot)
            return greedy, logits, prefill_len
        return self._prefill_into_slot_paged(slot, req, plan)

    def _prefill_into_slot_paged(self, slot: int, req: Request, plan):
        mgr = self.block_mgr
        _, total = plan
        n_tokens = total + req.gen.max_new_tokens
        if not mgr.can_admit(n_tokens):
            mgr.defer_count += 1
            return None
        row_cache, greedy, logits, prefill_len = self._prefill(req.prompt, plan)
        ids = mgr.admit(slot, n_tokens)
        # Row copy: only the pages the prefilled row covers; decode writes continue
        # directly into the lane's remaining pages.
        n_row_pages = pages_for(total, self.page_size)
        write_ids = np.full((mgr.max_pages,), mgr.SENTINEL, np.int32)
        write_ids[:n_row_pages] = ids[:n_row_pages]
        self.cache = _insert_row_paged(self.cache, row_cache, write_ids, slot,
                                       self.page_size)
        return greedy, logits, prefill_len

    def _prefill(self, prompt: np.ndarray, plan):
        """Chunked single-row prefill → (row cache, greedy [1], logits [1, V],
        decode start position)."""
        _, total = plan
        pad = total - len(prompt)
        row = np.zeros((1, total), np.int32)
        row[0, pad:] = prompt
        mask = np.zeros((1, total), bool)
        mask[0, pad:] = True
        row_t = torch.tensor(row, device=self.device)
        mask_t = torch.tensor(mask, device=self.device)
        bucket = self.prompt_bucket
        greedy, logits, cache = _prefill_first_chunk(
            self.params, row_t[:, :bucket], mask_t[:, :bucket], self.cfg, self.max_len
        )
        for c in range(1, total // bucket):
            sl = slice(c * bucket, (c + 1) * bucket)
            greedy, logits, cache = _prefill_next_chunk(
                self.params, row_t[:, sl], mask_t[:, sl], cache, self.cfg
            )
        return cache, greedy, logits, total
