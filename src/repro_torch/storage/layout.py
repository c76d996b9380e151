"""Learned-position page layout: where a snapshot slot lives on disk.

Port of ``repro/storage/layout.py``.

The paper's defining claim is that the learned models approximate the
position of each record **on disk**; this module fixes the disk geometry
those positions point into.  The layout is cluster-major, mirroring the
serving snapshot exactly: cluster ``k`` owns one contiguous *extent* of
fixed-size pages holding its ``n_max`` slot rows in mapped-value order
(ring order, then §5.3 insert-buffer rows, then padding slots) — so a
certified rank interval ``[lo-E, hi+E]`` translates to a contiguous run
of pages, which is the whole point of the paper's IntervalGen.

Pages are fixed-size (``page_bytes``, default 4 KB like the paper's
evaluation); the row capacity of a page is additionally truncated to a
multiple of 128 rows once it exceeds 128, so page boundaries line up
with the kernels' 128-point count tiles and a gathered page block feeds
the refinement kernels without re-alignment.

All math here is integer slot/page arithmetic over numpy arrays — no
file IO (that is ``repro_torch.storage.store``) and no torch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the paper evaluates 4 KB pages; keep parity with core.paging
DEFAULT_PAGE_BYTES = 4096
_TILE_ROWS = 128        # kernel tile alignment for large pages
_RECORD_BYTES = 8       # f64 component size; a record is d of these


def rows_per_page(page_bytes: int, d: int) -> int:
    """Row capacity of one page: floor-fit f64 records, 128-row aligned
    once a page holds at least a full kernel tile."""
    rpp = max(1, int(page_bytes) // (d * _RECORD_BYTES))
    if rpp > _TILE_ROWS:
        rpp -= rpp % _TILE_ROWS
    return rpp


@dataclass(frozen=True)
class PageLayout:
    """Slot ↔ page geometry for one store generation.

    ``extents[k]`` is the first page of cluster ``k``'s extent; every
    extent spans ``pages_per_cluster`` contiguous pages (all clusters
    share the snapshot's padded ``n_max``).  Flat slot ids are the
    executor's candidate axis: ``slot = k * n_max + i``.
    """

    page_bytes: int
    rows_per_page: int
    d: int
    n_max: int
    extents: tuple          # (K,) start page per cluster

    @property
    def K(self) -> int:
        return len(self.extents)

    @property
    def pages_per_cluster(self) -> int:
        return -(-self.n_max // self.rows_per_page)

    @property
    def page_stride_bytes(self) -> int:
        """Physical bytes per page in the store file (packed rows; at
        most ``page_bytes``)."""
        return self.rows_per_page * self.d * _RECORD_BYTES

    def _extents_arr(self) -> np.ndarray:
        return np.asarray(self.extents, dtype=np.int64)

    def slot_pages(self, slots: np.ndarray) -> np.ndarray:
        """Page id holding each flat slot (same shape as ``slots``)."""
        slots = np.asarray(slots, dtype=np.int64)
        k, i = slots // self.n_max, slots % self.n_max
        return self._extents_arr()[k] + i // self.rows_per_page

    def slot_locations(self, slots: np.ndarray):
        """(page id, row offset inside the page) per flat slot."""
        slots = np.asarray(slots, dtype=np.int64)
        k, i = slots // self.n_max, slots % self.n_max
        return (self._extents_arr()[k] + i // self.rows_per_page,
                i % self.rows_per_page)

    def cluster_file_rows(self, k: int) -> tuple[int, int]:
        """[start, stop) in file-row space covering cluster ``k``'s
        ``n_max`` slot rows (its extent's pages are contiguous)."""
        start = int(self.extents[k]) * self.rows_per_page
        return start, start + self.n_max


__all__ = ["DEFAULT_PAGE_BYTES", "PageLayout", "rows_per_page"]
