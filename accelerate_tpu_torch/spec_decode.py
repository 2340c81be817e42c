"""Draft sources for batched speculative serving (``serving.ContinuousBatcher``).

Counterpart of ``accelerate_tpu/spec_decode.py``. Speculative decoding splits a decode
step into PROPOSE (cheap, per lane, k tokens) and VERIFY (one target forward over
``[B, k+1]``, ``models.llama.forward_slots``). This module owns the propose side:

- :class:`DraftSource` — the interface the engine drives (``bind``, ``admit``,
  ``propose``, ``warm_programs``; ``resident`` marks a drafter whose proposals can run
  inside the fused speculative super-step).
- :class:`NgramDrafter` — model-free prompt-lookup drafting: a copy of the JAX
  package's numpy code (the port imports nothing of it). :func:`ngram_propose_resident`
  is its device twin in fixed-shape tensor ops (``torch.where``, ``amax``, ``gather``;
  no host read, no boolean-mask indexing, no data-dependent shape), which the fused
  super-step runs inside its CUDA graph.
- :class:`ModelDrafter` — a llama-family draft model with its own dense per-lane cache
  that mirrors the engine's padded lane layout (the engine's ``_plan_prefill`` decision
  is handed to ``admit``), so engine positions index both caches. Per spec step it runs
  k+1 batched T = 1 draft steps (k greedy proposals and one catch-up write); on the
  card the k+1 steps are ONE CUDA graph (``utils/cuda_graph.CapturedStep``) over static
  pending-token and position buffers, whose output is the ``[B, k]`` proposals.

The draft never changes emitted tokens (greedy lanes accept by exact match, sampled
lanes replay the target's own draws or run the Leviathan accept/reject), only how
many target forwards a sequence costs.

Deviations from the JAX module: the draft prefill runs eagerly (one ``forward_cached``
call per chunk, no graph) and the draft's row insert is a plain in-place copy; against
a paged engine the draft reads its dense cache through the paged attention (identity
block tables over the same storage), as the target's decode reads its pool, where JAX's
draft attends densely; a ``ModelDrafter`` takes llama-family drafts only (the
cross-family GPT draft waits for ``models/gpt.py``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .models import llama
from .utils.cuda_graph import CapturedStep

__all__ = ["DraftSource", "NgramDrafter", "ModelDrafter", "ngram_propose_resident"]


class DraftSource:
    """Interface the serving engine drives (one instance per engine; ``bind`` first).

    ``bind(engine)`` once at engine construction; ``admit(slot, prompt, plan)`` when a
    request enters a lane (``plan`` is the engine's ``_plan_prefill`` result: a draft
    with a cache reproduces the same padded layout); ``propose(lanes, pending,
    positions, k)`` once per host-loop spec step, before the verify;
    ``warm_programs(engine)`` captures the drafter's own graphs ahead of traffic and
    returns one entry per program.

    Proposals must be deterministic given the lane context (the residual accept takes
    the draft distribution as a point mass on the proposal). ``resident = True`` marks
    a drafter with a device twin (:func:`ngram_propose_resident`) that the fused
    super-step runs instead of :meth:`propose`; greedy and replayed emissions do not
    depend on proposals, so the twin need not match the host drafter token for token.
    """

    resident = False

    def bind(self, engine) -> None:  # noqa: B027 - optional hook
        pass

    def admit(self, slot: int, prompt: np.ndarray, plan) -> None:  # noqa: B027
        pass

    def propose(self, lanes: Sequence, pending: np.ndarray, positions: np.ndarray,
                k: int) -> np.ndarray:
        """→ proposals int32 [len(lanes), k]; rows of idle lanes (``lanes[i] is None``)
        are don't-care."""
        raise NotImplementedError

    def warm_programs(self, engine, max_new_tokens: int = 32) -> list:
        return []


class NgramDrafter(DraftSource):
    """Prompt-lookup self-drafting: for each active lane, find the most recent earlier
    occurrence of the longest suffix n-gram (n from ``max_ngram`` down to 1) of
    ``prompt + generated`` and propose the tokens that followed it; when the copied
    continuation runs short, match again against the extended context; when nothing
    matches, repeat the last token. Host-side numpy: no params, no cache, no graphs."""

    resident = True  # device twin: ngram_propose_resident

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram={max_ngram} must be >= 1")
        self.max_ngram = max_ngram

    def propose(self, lanes, pending, positions, k):
        out = np.zeros((len(lanes), k), np.int32)
        for i, req in enumerate(lanes):
            if req is None:
                continue
            ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.tokens, np.int32)])
            out[i] = self._propose_one(ctx, k)
        return out

    def _propose_one(self, ctx: np.ndarray, k: int) -> np.ndarray:
        out = np.empty((k,), np.int32)
        filled = 0
        while filled < k:
            cont = self._lookup(ctx, k - filled)
            if cont is None:
                out[filled:] = ctx[-1]  # deterministic fallback: repeat the last token
                break
            take = min(len(cont), k - filled)
            out[filled:filled + take] = cont[:take]
            ctx = np.concatenate([ctx, cont[:take]])
            filled += take
        return out

    def _lookup(self, ctx: np.ndarray, want: int) -> Optional[np.ndarray]:
        """Continuation after the most recent earlier match of the longest suffix
        n-gram, or None: the longest n wins, and among equal n the latest occurrence."""
        L = len(ctx)
        if L < 2:
            return None
        from numpy.lib.stride_tricks import sliding_window_view

        for n in range(min(self.max_ngram, L - 1), 0, -1):
            pat = ctx[L - n:]
            # Windows over ctx[:L-1]: starts 0..L-1-n, so the suffix never matches itself.
            win = sliding_window_view(ctx[:L - 1], n)
            hits = np.flatnonzero((win == pat[None, :]).all(axis=1))
            if hits.size:
                h = int(hits[-1])
                cont = ctx[h + n:h + n + want]
                if cont.size:
                    return cont
        return None


def ngram_propose_resident(history: torch.Tensor, lengths: torch.Tensor, k: int,
                           max_ngram: int) -> torch.Tensor:
    """:class:`NgramDrafter`'s propose step in fixed-shape tensor ops, run inside the
    fused speculative super-step (a CUDA graph holds it).

    ``history`` [B, S] int32 — each lane's prompt + generated tokens packed from column
    0; ``lengths`` [B] — valid tokens per lane. Returns proposals [B, k] int32. Per lane
    the longest suffix n-gram (n from ``max_ngram`` down to 1) is matched against every
    earlier window of ``history[:length-1]``; the latest hit wins and the k tokens after
    it are proposed, clamped at the context end (positions past the last valid token
    repeat it); no hit repeats the last token. The host drafter's re-match when a
    continuation runs short is left out, as in JAX."""
    B, S = history.shape
    dev = history.device
    L = lengths.long()[:, None]
    starts = torch.arange(S, device=dev)[None, :]
    best_n = torch.zeros((B,), dtype=torch.long, device=dev)
    best_h = torch.zeros((B,), dtype=torch.long, device=dev)
    for n in range(max_ngram, 0, -1):
        # The suffix pattern: the last n valid tokens (the clamp keeps short lanes in
        # range; the validity mask below drops their matches).
        pat_idx = torch.clamp(L - n + torch.arange(n, device=dev)[None, :], 0, S - 1)
        pat = torch.gather(history, 1, pat_idx)
        match = torch.ones((B, S), dtype=torch.bool, device=dev)
        for j in range(n):
            shifted = torch.cat([history[:, j:], history.new_zeros((B, j))], dim=1)
            match &= shifted == pat[:, j:j + 1]
        # Windows over ctx[:L-1] with starts 0..L-1-n: the suffix never matches itself,
        # and n > L-1 finds nothing.
        valid = (starts + n <= L - 1) & (L - 1 >= n)
        h = torch.where(match & valid, starts, -1).amax(dim=1)
        take = (h >= 0) & (best_n == 0)  # the largest n wins; the latest start within n
        best_n = torch.where(take, n, best_n)
        best_h = torch.where(take, h, best_h)
    hit = best_n > 0
    src = torch.where(hit, best_h + best_n, L[:, 0] - 1)
    idx = src[:, None] + torch.arange(k, device=dev)[None, :] * hit.long()[:, None]
    idx = torch.clamp(torch.minimum(idx, L - 1), 0, S - 1)
    return torch.gather(history, 1, idx).to(torch.int32)


def _paged_view(cache: dict, page_size: int):
    """``cache`` (dense ``[B, C, ...]`` planes, C a multiple of ``page_size``) viewed as a
    paged pool of ``B·C/page_size`` pages that share its storage, and the identity block
    tables ``[B, C/page_size]`` that map lane b's logical page i to page ``b·C/ps + i``."""
    B, C = cache["valid"].shape
    MP = C // page_size
    layers = [{key: t.view(B * MP, page_size, *t.shape[2:]) for key, t in planes.items()}
              for planes in cache["layers"]]
    tables = torch.arange(B * MP, dtype=torch.int32, device=cache["valid"].device)
    return {"layers": layers, "valid": cache["valid"]}, tables.view(B, MP)


def _draft_round(params, cache, tokens, positions, cfg, k: int, tables=None,
                 page_size: int = 0) -> torch.Tensor:
    """k+1 batched T = 1 draft steps over every lane (in place on ``cache``): k greedy
    proposals and one catch-up step that writes the last proposal, so the draft covers
    the slots the target's verify writes → proposals [B, k] int32. Writes at or past
    the cache end drop. ``tables``/``page_size``: the cache is read as a paged pool
    (:func:`_paged_view`). Nothing here waits on the host: a CUDA graph holds it."""
    tok, pos, out = tokens, positions, []
    for j in range(k + 1):
        logits, _ = llama.forward_slots(params, tok[:, None], cache, pos, cfg, tables=tables,
                                        page_size=page_size)
        if j < k:
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)


class ModelDrafter(DraftSource):
    """A llama-family draft model with its own dense per-lane cache, lane-aligned with
    the engine: the draft row of lane s holds exactly the slots the engine row holds
    (the same padded prefill from the engine's plan, the same advance per step), so
    ``engine.positions`` drives both and rejected drafts need no rewind (the next
    step's writes overwrite them; the causal mask hides them meanwhile).

    Per spec step: k+1 batched T = 1 draft steps (:func:`_draft_round`); on the card one
    CUDA graph per k (``graphs``), its inputs in static pending-token and position
    buffers. The draft prefill at admission runs eagerly.

    The draft attends as the target's decode does: against a paged engine (whose
    ``max_len`` is a multiple of its page size) it reads its dense cache through the
    paged dispatch (kernel #1 on the card) over identity block tables, a view of the
    same storage (:func:`_paged_view`), so a draft over the target's own params proposes
    what the target's one-token decode emits; against a dense engine, the dense cached
    attention."""

    def __init__(self, params: dict, cfg):
        llama.check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self._lanes = None  # the bound engine's (device, max_len, prompt_bucket)
        self.cache = None
        self._buf = None  # static (pending tokens [B], positions [B]) of the draft graph
        self._paged = None  # (paged view of the cache, identity tables, page size) or None
        #: Draft-round runners by k: a ``CapturedStep`` on the card, the plain call on
        #: the CPU.
        self.graphs: dict = {}

    def bind(self, engine) -> None:
        if self.cfg.vocab_size != engine.cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size={self.cfg.vocab_size} != target "
                f"vocab_size={engine.cfg.vocab_size}: speculative acceptance needs "
                "one shared token space"
            )
        if engine.prefix_cache_size:
            raise ValueError(
                "ModelDrafter does not support prefix-cached engines (the registry's "
                "right-aligned layout has no draft-side counterpart); use NgramDrafter"
            )
        # The engine's geometry, not the engine: a drafter that held its engine would
        # make a reference cycle, freed only by the cyclic collector at any later point.
        self._lanes = (engine.device, engine.max_len, engine.prompt_bucket)
        dev = engine.device
        self.cache = llama.init_cache(self.cfg, engine.max_slots, engine.max_len, device=dev)
        if engine.paged and engine.max_len % engine.page_size == 0:
            self._paged = (*_paged_view(self.cache, engine.page_size), engine.page_size)
        self._buf = tuple(torch.zeros((engine.max_slots,), dtype=torch.int32, device=dev)
                          for _ in range(2))

    def admit(self, slot: int, prompt: np.ndarray, plan) -> None:
        """Prefill ``prompt`` into draft lane ``slot`` with the ENGINE's padded layout
        (``plan``: its ``("bucket", width)`` or ``("chunk", total)``), then copy the
        row into the draft cache."""
        from .serving import _insert_row

        dev, max_len, prompt_bucket = self._lanes
        mode, total = plan
        pad = total - len(prompt)
        row = np.zeros((1, total), np.int32)
        row[0, pad:] = prompt
        mask = np.zeros((1, total), bool)
        mask[0, pad:] = True
        width = total if mode == "bucket" else prompt_bucket
        row_cache = llama.init_cache(self.cfg, 1, max_len, device=dev)
        for c in range(total // width):
            sl = slice(c * width, (c + 1) * width)
            _, row_cache = llama.forward_cached(
                self.params, torch.as_tensor(row[:, sl], device=dev), row_cache,
                self.cfg, token_mask=torch.as_tensor(mask[:, sl], device=dev),
                last_only=True)
        _insert_row(self.cache, row_cache, slot)

    def _runner(self, k: int):
        run = self.graphs.get(k)
        if run is None:
            cache, tables, ps = self._paged or (self.cache, None, 0)
            fn = functools.partial(_draft_round, self.params, cache, *self._buf, self.cfg, k,
                                   tables=tables, page_size=ps)
            dev = self._lanes[0]
            run = self.graphs[k] = CapturedStep(fn, dev) if dev.type == "cuda" else fn
        return run

    def propose(self, lanes, pending, positions, k):
        self._buf[0].copy_(torch.from_numpy(np.asarray(pending, np.int32)))
        self._buf[1].copy_(torch.from_numpy(np.asarray(positions, np.int32)))
        return self._runner(k)().cpu().numpy()

    def warm_one(self, k: int) -> None:
        """Run the draft round of ``k`` once on idle inputs (on the card its first
        call: eager, then captured): every position at the cache end, so every write
        drops and the draft cache is left as it was."""
        self._buf[0].zero_()
        self._buf[1].fill_(self._lanes[1])
        self._runner(k)()

    def warm_programs(self, engine, max_new_tokens: int = 32) -> list:
        """Capture the draft round's graph (of ``engine.spec_k``) ahead of traffic → one
        entry: its JAX name, key, capture seconds and pool bytes (None on the CPU,
        where nothing is captured)."""
        k = engine.spec_k
        if engine.device.type == "cuda" and k not in self.graphs:
            self.warm_one(k)
        run = self.graphs.get(k)
        return [{"name": "serving.draft.decode", "key": ["draft", k],
                 "capture_s": getattr(run, "capture_s", None),
                 "pool_bytes": getattr(run, "pool_bytes", None)}]
