"""IO-batch scheduler: certified candidate sets → deduplicated page runs.

Port of ``repro/storage/scheduler.py``.

The executor's device pipeline certifies, per query, a candidate slot
set (the error-widened ring box ``[lo-E, hi+E]`` ∧ TriPrune ∧ validity).
Refinement needs those rows.  Fetching them per query would re-read
shared pages B times; this module plans the IO for the *whole batch*
instead:

  1. union the candidate slots over the batch (dedup across queries),
  2. map slots to pages through the learned-position layout,
  3. coalesce the deduped page list into contiguous runs, so the store
     reads each run with one sequential mmap slice.

Because the layout is cluster-major in mapped-value order, a query's
candidates inside one cluster cover few pages and adjacent queries share
them — exactly the access pattern the paper's learned positions exist to
produce.  The plan also carries the per-query unique-page and candidate
counts: the paper's IO cost metric, recorded into the store's cache
stats.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .layout import PageLayout


def page_runs(pages: np.ndarray) -> tuple:
    """Coalesce a sorted unique page-id array into [start, stop) runs."""
    if len(pages) == 0:
        return ()
    breaks = np.nonzero(np.diff(pages) > 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks, [len(pages) - 1]])
    return tuple((int(pages[a]), int(pages[b]) + 1)
                 for a, b in zip(starts, stops))


@dataclass(frozen=True)
class IOPlan:
    """One query batch's IO: what to read, and what each query touched."""

    slots: np.ndarray            # unique sorted candidate slot ids
    pages: np.ndarray            # unique sorted page ids covering them
    runs: tuple                  # coalesced [start, stop) page runs
    pages_per_query: np.ndarray  # (B,) unique pages per query
    cand_per_query: np.ndarray   # (B,) candidate slots per query

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def summary(self) -> dict:
        return {
            "pages": int(self.n_pages),
            "runs": len(self.runs),
            "candidates": int(len(self.slots)),
            "pages_per_query": [int(p) for p in self.pages_per_query],
            "candidates_per_query": [int(c) for c in self.cand_per_query],
        }


def plan_batch(cand: np.ndarray, layout: PageLayout,
               per_query: bool = True,
               exclude: np.ndarray | None = None) -> IOPlan:
    """Plan the page fetch for a (B, P) bool candidate mask.

    Every page is listed once no matter how many queries (or how many
    slots within a query) need it; runs are maximal contiguous spans so
    the store turns them into sequential reads.  ``per_query=False``
    skips the per-query unique-page accounting (a caller that tracks
    pages across rounds itself — the kNN driver — avoids paying the
    slot→page mapping twice per round).  ``exclude`` (a (P,) bool mask)
    drops slots whose rows the caller already holds — the speculative
    prefetch plan for round t+1 covers only IO round t hasn't done.
    """
    cand = np.asarray(cand, dtype=bool)
    if exclude is not None:
        cand = cand & ~np.asarray(exclude, dtype=bool)[None]
    B = cand.shape[0]
    slots = np.nonzero(cand.any(axis=0))[0].astype(np.int64)
    pages = np.unique(layout.slot_pages(slots)) if len(slots) \
        else np.empty(0, np.int64)
    ppq = np.zeros(B, np.int64)
    cpq = cand.sum(axis=1).astype(np.int64)
    if per_query and len(slots):
        # one vectorized pass: dedupe (query, page) pairs via a packed
        # key, then count pages per query — no per-query Python loop
        qi, si = np.nonzero(cand)
        pg = layout.slot_pages(si)
        span = int(pages[-1]) + 1
        uq = np.unique(qi.astype(np.int64) * span + pg)
        ppq = np.bincount(uq // span, minlength=B).astype(np.int64)
    return IOPlan(slots=slots, pages=pages, runs=page_runs(pages),
                  pages_per_query=ppq, cand_per_query=cpq)


__all__ = ["IOPlan", "plan_batch", "page_runs"]
