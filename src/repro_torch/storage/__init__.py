"""Paged storage tier: learned-position disk layout for LIMS snapshots.

Port of ``repro/storage``: the same modules, numpy only, with their
``env`` and ``obs`` imports pointing at the port's own.  The on-disk
format (manifest JSON, metadata arrays, ``pages.bin``) is the
reference's, so either package serves a store the other spilled.

The paper's rank models approximate where each record sits **on disk**;
this package is the disk.  A spilled snapshot directory holds an
append-only page file (cluster-major extents, rows in mapped-value
order — ``layout``), an atomic JSON manifest (``manifest``), and the
snapshot's non-row arrays; serving reads it through a ``PagedStore``
(mmap + LRU page cache with access counters — ``cache``/``store``)
driven by the IO-batch scheduler (``scheduler``), which turns the
executor's certified candidate plans into deduplicated sequential page
runs fetched once per query batch, and — under ``REPRO_PREFETCH=async``
— by the background prefetcher (``prefetch``), which overlaps upcoming
kNN rounds' page IO with kernel refinement.  ``PagedStore.compact()``
reclaims the garbage extents append-only writebacks leave behind.
The reference's DESIGN.md §7–§8 are the full story, including why
store-backed results stay bit-identical to the resident path.

``REPRO_STORAGE=paged`` flips the default serving surface
(``ServingEngine``) to spill-and-serve through this tier.
"""
from __future__ import annotations

from .. import env

from .cache import (DEFAULT_CACHE_PAGES, CacheStats, LRUPageCache,
                    cache_pin_mode)
from .layout import DEFAULT_PAGE_BYTES, PageLayout, rows_per_page
from .manifest import Manifest, write_atomic
from .prefetch import (PagePrefetcher, PrefetchTicket, drain_queue,
                       prefetch_mode, shutdown_prefetch)
from .scheduler import IOPlan, page_runs, plan_batch
from .store import PagedStore, StoreView, load_meta, spill_rows


def storage_mode() -> str:
    """The process-wide storage default: '' (resident) or 'paged'
    (``REPRO_STORAGE``, validated by ``repro_torch.env``)."""
    return env.get("REPRO_STORAGE")


__all__ = [
    "CacheStats", "DEFAULT_CACHE_PAGES", "DEFAULT_PAGE_BYTES", "IOPlan",
    "LRUPageCache", "Manifest", "PageLayout", "PagePrefetcher",
    "PagedStore", "PrefetchTicket", "StoreView", "cache_pin_mode",
    "drain_queue", "load_meta", "page_runs", "plan_batch", "prefetch_mode",
    "rows_per_page", "shutdown_prefetch", "spill_rows", "storage_mode",
    "write_atomic",
]
