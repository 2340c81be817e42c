"""Paged KV-cache block manager: fixed-size pages, free-list allocation, COW prefix sharing.

A copy of ``accelerate_tpu/paged_kv.py`` (pure numpy, no device code): the port keeps
its own so it imports nothing of the JAX package.

K/V lives in a shared pool of ``num_pages`` fixed-size pages
(``models.common.paged_kv_planes``); each lane owns an int32 **block table** row
mapping its logical pages to physical pool pages, and this manager runs the free list,
per-page refcounts and page sharing on the host.

- A lane's own pages have refcount 1 and are the only pages the device ever WRITES
  (decode writes and the admission row-scatter are masked to owned pages through the
  ``SENTINEL`` page id, which the port's paged writes drop).
- Sharing a prefix increfs the fully-covered pages; a boundary cutting a page mid-way
  is re-materialized as an owned copy (copy-on-write), counted in ``cow_count``.
- Pages free when their refcount returns to zero (lane finish/evict, entry release).

``BlockManager`` knows nothing about models or devices: the engine asks it for page
ids and mirrors them into the device block table it uploads per step.
"""


from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["BlockManager", "KVBudgetError", "PagePoolExhausted", "pages_for"]


class KVBudgetError(ValueError):
    """A single request's worst-case page demand exceeds the whole pool — it could
    never be admitted, no matter how long it waits (the gateway maps this to the
    machine-readable ``kv_budget`` reject reason)."""


class PagePoolExhausted(RuntimeError):
    """Allocation asked for more pages than the free list holds. The engine treats
    admission-time exhaustion as *deferral* (the request waits for pages to free),
    so this escaping to a caller means an accounting bug, not load."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache slots (ceil division)."""
    return -(-int(n_tokens) // int(page_size))


class BlockManager:
    """Free-list + refcount allocator over a pool of ``num_pages`` KV pages.

    ``tables`` is the authoritative host copy of the device block table
    ``[max_slots, max_pages]`` int32 — unallocated logical pages hold ``SENTINEL``
    (== ``num_pages``), which is out of bounds for the pool's page axis, so device
    scatters through stale entries drop instead of corrupting another lane's pages.
    """

    def __init__(self, num_pages: int, page_size: int, max_slots: int, max_len: int):
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1")
        if num_pages < 1:
            raise ValueError(f"num_pages={num_pages} must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.max_pages = pages_for(max_len, page_size)  # table width per lane
        self.SENTINEL = self.num_pages
        self.tables = np.full((max_slots, self.max_pages), self.SENTINEL, np.int32)
        self.refcount = np.zeros(self.num_pages, np.int32)
        # LIFO free list: recently-freed pages are reused first (warm in HBM).
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        # Per-lane page ids in logical order (owned AND adopted) — every table
        # entry the lane holds a reference to; None = lane empty.
        self._lanes: list[Optional[list]] = [None] * max_slots
        # Counters (stats()/telemetry): page-pool churn is the serving memory story.
        self.alloc_count = 0      # pages handed out (lanes + registry copies)
        self.free_count = 0       # pages returned to the free list
        self.cow_count = 0        # partial-page copies (register + adopt divergence)
        self.adopt_count = 0      # shared prefix pages adopted by lanes (incref'd)
        self.defer_count = 0      # admissions deferred on pool pressure
        self.detach_count = 0     # pages detached from lanes into handoff records

    # ------------------------------------------------------------------ queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    def shared_pages(self) -> int:
        """Pages referenced more than once — the prefix-sharing win, measured."""
        return int((self.refcount > 1).sum())

    def demand(self, n_tokens: int) -> int:
        """Worst-case page demand for a request occupying ``n_tokens`` cache slots;
        raises :class:`KVBudgetError` when the whole pool could never satisfy it."""
        need = self.pages_for(n_tokens)
        if need > self.num_pages:
            raise KVBudgetError(
                f"request needs {need} pages ({n_tokens} cache tokens at "
                f"page_size={self.page_size}) but the pool only has "
                f"{self.num_pages} — it can never be admitted"
            )
        return need

    # ------------------------------------------------------------------ allocation
    def _take(self, n: int) -> list[int]:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"asked for {n} pages with {len(self._free)} free "
                f"(pool {self.num_pages}, in use {self.pages_in_use})"
            )
        ids = [self._free.pop() for _ in range(n)]
        for p in ids:
            assert self.refcount[p] == 0, (p, self.refcount[p])
            self.refcount[p] = 1
        self.alloc_count += n
        return ids

    def _drop(self, page: int) -> None:
        self.refcount[page] -= 1
        assert self.refcount[page] >= 0, page
        if self.refcount[page] == 0:
            self._free.append(page)
            self.free_count += 1

    def admit(self, slot: int, n_tokens: int,
              adopted: Optional[list] = None, cow_partial: bool = False) -> np.ndarray:
        """Give lane ``slot`` pages covering cache slots ``[0, n_tokens)``.

        ``adopted`` — physical ids of fully-shared prefix pages (incref'd, read-only
        for this lane; they become logical pages ``0..len(adopted)``). ``cow_partial``
        marks that the prefix boundary cut a page mid-way: the divergent partial page
        is re-materialized as an owned fresh page (counted as a COW copy — the
        admission row-scatter fills it with the full content, so no device copy op
        is needed on this direction). Returns the lane's full logical page-id vector.
        Raises :class:`PagePoolExhausted` if the free list can't cover the owned
        part — call :meth:`can_admit` first; the engine defers instead of raising.
        """
        if self._lanes[slot] is not None:
            raise RuntimeError(f"slot {slot} still holds pages; release it first")
        adopted = list(adopted or [])
        total = self.demand(n_tokens)
        n_owned = total - len(adopted)
        assert n_owned >= 0, (total, len(adopted))
        owned = self._take(n_owned)
        for p in adopted:
            self.refcount[p] += 1
        self.adopt_count += len(adopted)
        if cow_partial:
            self.cow_count += 1
        ids = adopted + owned
        self._lanes[slot] = ids
        self.tables[slot, :] = self.SENTINEL
        self.tables[slot, : len(ids)] = ids
        return np.asarray(ids, np.int32)

    def can_admit(self, n_tokens: int, n_adopted: int = 0) -> bool:
        """Would :meth:`admit` succeed right now? (Also validates the pool could
        EVER serve it — raises :class:`KVBudgetError` when not.)"""
        need = self.demand(n_tokens) - n_adopted
        return need <= len(self._free)

    def release_slot(self, slot: int) -> int:
        """Drop every reference lane ``slot`` holds (finish/evict/cancel); pages whose
        refcount reaches zero return to the free list. Returns pages freed."""
        lane = self._lanes[slot]
        if lane is None:
            return 0
        before = len(self._free)
        for p in lane:
            self._drop(p)
        self._lanes[slot] = None
        self.tables[slot, :] = self.SENTINEL
        return len(self._free) - before

    def lane_pages(self, slot: int) -> Optional[np.ndarray]:
        lane = self._lanes[slot]
        return None if lane is None else np.asarray(lane, np.int32)

    def detach_slot(self, slot: int) -> np.ndarray:
        """Transfer lane ``slot``'s page references OUT of the lane without
        dropping them: the lane empties (table row → SENTINEL) but every page
        keeps its refcount — ownership moves to the caller (in the JAX engine, a
        KV handoff record shipping the prefix KV to a decode-role engine). The
        caller MUST eventually :meth:`release` the returned ids or the pages
        leak. Returns the detached page ids in logical order."""
        lane = self._lanes[slot]
        if lane is None:
            return np.zeros((0,), np.int32)
        self._lanes[slot] = None
        self.tables[slot, :] = self.SENTINEL
        self.detach_count += len(lane)
        return np.asarray(lane, np.int32)

    def import_pages(self, n: int) -> list:
        """``n`` fresh pages (refcount 1 each) owned by a handoff IMPORT — the
        destination-side staging of a cross-engine page transfer, before a lane
        adopts the full pages read-only and re-materializes the partial
        boundary page (COW). The importer releases its references after
        adoption; pages nobody adopted then free. Raises
        :class:`PagePoolExhausted` when the free list can't cover it — the
        engine checks first and defers instead."""
        return self._take(n)

    # ------------------------------------------------------------------ prefix sharing
    def retain(self, page_ids) -> None:
        """Registry-side incref (a prefix entry now references these pages)."""
        for p in np.asarray(page_ids).tolist():
            assert self.refcount[p] > 0, p
            self.refcount[p] += 1

    def release(self, page_ids) -> int:
        """Registry-side decref (entry evicted); returns pages freed."""
        before = len(self._free)
        for p in np.asarray(page_ids).tolist():
            self._drop(p)
        return len(self._free) - before

    def take_copy_page(self) -> Optional[int]:
        """One fresh page for an immutable registry copy of a partial boundary page
        (refcount 1, owned by the registry entry). None when the pool is empty —
        the registry is an optimization, so callers skip registering instead of
        failing. Counted as a COW copy."""
        if not self._free:
            return None
        (page,) = self._take(1)
        self.cow_count += 1
        return page

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "pages_total": self.num_pages,
            "page_size": self.page_size,
            "pages_free": len(self._free),
            "pages_in_use": self.pages_in_use,
            "page_occupancy": round(self.pages_in_use / self.num_pages, 4),
            "shared_pages": self.shared_pages(),
            "alloc_count": self.alloc_count,
            "free_count": self.free_count,
            "cow_count": self.cow_count,
            "adopt_count": self.adopt_count,
            "defer_count": self.defer_count,
            "detach_count": self.detach_count,
        }
