"""LRU page cache + the store's IO / serving-metric counters.

Port of ``repro/storage/cache.py``.

The cache emulates the bounded buffer pool of a disk-based index: pages
enter on miss, recency-ordered, evicting the coldest once over capacity.
Pages are keyed by ``(pages file, page id)``: within one file page ids
are append-only and their content immutable, so the cache is never
invalidated — not across manifest swaps (a refreshed generation
references *new* page ids for rewritten clusters) and not across
compactions (a compacted generation lives in a *new* file, so its
restarted page ids can never collide with a pinned view's old ones).

Schedule-aware eviction (the reference's DESIGN.md §9): a query batch's ``CandidatePlan``
knows every page its remaining rounds will touch, so the paged backend
*pins* them for the batch's duration — ``pin``/``unpin`` hold a
per-page count, and capacity eviction skips pinned pages (the coldest
*unpinned* page goes instead).  Blind LRU would evict a round's pages
between its fetch and its gather under a squeezed capacity, or drop
earlier rounds' pages a later round is guaranteed to re-demand; pinning
replaces that with the plan's own schedule.  Pinning never blocks an
insert — when every resident page is pinned the cache briefly overflows
capacity (bounded by one batch's working set) rather than corrupt a
planned fetch.  ``unpin`` restores plain LRU: the page keeps the
recency position its accesses earned and becomes evictable again.
``REPRO_CACHE_PIN=off`` disables plan pinning process-wide (the
blind-LRU baseline).

The victims are the reference's, in its order: the coldest unpinned
page, found by the same front-to-back walk.  The port also keeps a count
of resident unpinned pages, so an insert past capacity while every
resident page is pinned ends at once instead of walking them all (the
reference's walk is O(pinned) per insert there, O(pinned²) per batch).

``CacheStats`` carries two families of counters:

  * cache-level IO: requests / hits / misses (= actual page reads) /
    evictions / rows gathered — the buffer-pool story;
  * per-query serving metrics recorded by the executor: unique pages
    touched and candidate rows refined per query — the paper's headline
    cost model (page accesses per query).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from .. import env

DEFAULT_CACHE_PAGES = 4096


def cache_pin_mode() -> bool:
    """Whether planned batches pin their scheduled pages (default on).
    ``REPRO_CACHE_PIN=off`` reverts to blind LRU — the baseline
    (validated by ``repro_torch.env``)."""
    return env.get("REPRO_CACHE_PIN") not in ("off", "0", "no")


@dataclass
class CacheStats:
    # buffer-pool counters
    requests: int = 0
    hits: int = 0
    misses: int = 0             # demand page reads
    evictions: int = 0
    rows_gathered: int = 0
    # speculative page reads issued by the async prefetcher
    # (``fetch_pages(record=False)``): real file IO that is not a demand
    # miss.  Total page reads = misses + prefetch_reads — the invariant
    # that makes buffer-pool stats + prefetch stats sum to all IO
    # (asserted in tests); before this counter that IO was invisible.
    prefetch_reads: int = 0
    # per-query serving metrics (executor-recorded)
    batches: int = 0
    queries: int = 0
    pages_touched: int = 0      # Σ over queries of unique pages accessed
    candidates: int = 0         # Σ over queries of rows fetched for refine

    def record_queries(self, pages_per_query, cand_per_query) -> None:
        self.batches += 1
        self.queries += len(pages_per_query)
        self.pages_touched += int(np.sum(pages_per_query))
        self.candidates += int(np.sum(cand_per_query))

    def snapshot(self) -> dict:
        q = max(self.queries, 1)
        return {
            "requests": self.requests, "hits": self.hits,
            "misses": self.misses, "evictions": self.evictions,
            "rows_gathered": self.rows_gathered,
            "prefetch_reads": self.prefetch_reads,
            "page_reads": self.misses + self.prefetch_reads,
            "hit_rate": round(self.hits / max(self.requests, 1), 4),
            "batches": self.batches, "queries": self.queries,
            "pages_per_query": round(self.pages_touched / q, 2),
            "candidates_per_query": round(self.candidates / q, 2),
        }

    def reset(self) -> None:
        for f in ("requests", "hits", "misses", "evictions",
                  "rows_gathered", "prefetch_reads", "batches", "queries",
                  "pages_touched", "candidates"):
            setattr(self, f, 0)


@dataclass
class LRUPageCache:
    """(file, page id) → (rows_per_page, d) f64 block, recency-ordered.

    ``capacity_pages=None`` means unbounded (useful for warm replicas
    that are expected to fault the whole working set in once).
    ``access`` keeps a per-page hit counter — the store's "access
    counters", e.g. for spotting hot extents.
    """

    capacity_pages: int | None = DEFAULT_CACHE_PAGES
    _pages: OrderedDict = field(default_factory=OrderedDict)
    access: dict = field(default_factory=dict)
    _pins: dict = field(default_factory=dict)   # pid → pin count
    _unpinned: int = 0          # resident pages that are not pinned

    def __len__(self) -> int:
        return len(self._pages)

    def touch(self, pid: int) -> bool:
        """Mark ``pid`` accessed; True when resident (LRU bump)."""
        self.access[pid] = self.access.get(pid, 0) + 1
        if pid in self._pages:
            self._pages.move_to_end(pid)
            return True
        return False

    def peek(self, pid: int) -> np.ndarray | None:
        """Resident page block without recency/counter side effects."""
        return self._pages.get(pid)

    def put(self, pid: int, block: np.ndarray) -> int:
        """Insert a page; returns how many pages were evicted.

        Eviction is pin-aware: the coldest *unpinned* page goes first;
        when every resident page is pinned the cache overflows capacity
        rather than break a planned fetch (bounded by one batch's
        pinned working set)."""
        if pid not in self._pages and pid not in self._pins:
            self._unpinned += 1
        self._pages[pid] = block
        self._pages.move_to_end(pid)
        return self._shrink()

    def _shrink(self) -> int:
        """Evict coldest unpinned pages until back under capacity; an
        all-pinned cache stays overflowed (bounded by one batch's
        working set) until its pins release."""
        evicted = 0
        if self.capacity_pages is not None:
            while (len(self._pages) > self.capacity_pages
                   and self._unpinned):     # all pinned → allow overflow
                victim = next(k for k in self._pages if k not in self._pins)
                del self._pages[victim]
                self._unpinned -= 1
                evicted += 1
        return evicted

    def pin(self, pids) -> None:
        """Hold the given pages against capacity eviction (refcounted).
        Pinning a non-resident page is allowed: the hold applies the
        moment the page is inserted."""
        for pid in pids:
            c = self._pins.get(pid, 0)
            if not c and pid in self._pages:
                self._unpinned -= 1
            self._pins[pid] = c + 1

    def unpin(self, pids) -> int:
        """Release one hold per page; at zero the page rejoins plain LRU
        at whatever recency position its accesses earned.  Unknown pids
        are ignored (a pinned page may have been cleared meanwhile).
        Returns pages evicted clearing any pin-era overflow."""
        for pid in pids:
            c = self._pins.get(pid, 0) - 1
            if c > 0:
                self._pins[pid] = c
            elif self._pins.pop(pid, None) is not None \
                    and pid in self._pages:
                self._unpinned += 1
        return self._shrink()

    @property
    def pinned(self) -> int:
        """Number of distinct pages currently held."""
        return len(self._pins)

    def clear(self) -> None:
        """Drop every resident page (access counters are kept — they
        describe the workload, not the residency; pins are dropped with
        the pages they guarded)."""
        self._pages.clear()
        self._pins.clear()
        self._unpinned = 0

    def hottest(self, n: int = 10) -> list:
        """(page id, access count) for the n most-accessed pages."""
        return sorted(self.access.items(), key=lambda kv: -kv[1])[:n]


__all__ = ["LRUPageCache", "CacheStats", "DEFAULT_CACHE_PAGES",
           "cache_pin_mode"]
