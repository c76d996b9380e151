"""Page store: the disk emulation layer.

The paper is a *disk-based* index evaluated on page accesses with 4 KB
pages. On TPU the same role is played by fixed-size HBM row tiles; the
accounting is identical, so one implementation serves both stories. Rows
are stored in index order (ascending LIMS value per cluster); a page holds
``omega`` records and the store counts unique page fetches per query.

Copied from ``repro/core/paging.py``: results must match it bitwise.
"""
from __future__ import annotations

import numpy as np

DEFAULT_PAGE_BYTES = 4096


class PageStore:
    """Rows laid out sequentially in pages of ``omega`` records."""

    def __init__(self, rows: np.ndarray, record_bytes: int | None = None,
                 page_bytes: int = DEFAULT_PAGE_BYTES):
        self.rows = rows
        rb = record_bytes if record_bytes is not None else rows[0].nbytes
        self.omega = max(1, page_bytes // max(1, rb))
        self.n = rows.shape[0]
        self.n_pages = -(-self.n // self.omega)
        self.page_accesses = 0          # cumulative, across queries
        self.rows_fetched = 0

    def reset_counters(self) -> None:
        self.page_accesses = 0
        self.rows_fetched = 0

    def page_range(self, lo_row: int, hi_row: int) -> range:
        """Pages covering rows [lo_row, hi_row] inclusive."""
        if hi_row < lo_row:
            return range(0)
        return range(lo_row // self.omega, hi_row // self.omega + 1)

    def fetch_pages(self, page_ids, visited: set | None = None):
        """Return (row_indices, rows) for all unvisited pages; count I/O.

        ``visited`` is the caller-held per-query (or per-kNN-search) set —
        Algorithm 2 in the paper relies on skipping already-read pages
        across radius expansions.
        """
        new_pages = []
        for pid in page_ids:
            if pid < 0 or pid >= self.n_pages:
                continue
            if visited is not None:
                if pid in visited:
                    continue
                visited.add(pid)
            new_pages.append(pid)
        self.page_accesses += len(new_pages)
        if not new_pages:
            return np.empty(0, np.int64), self.rows[:0]
        idx = np.concatenate(
            [np.arange(p * self.omega, min((p + 1) * self.omega, self.n))
             for p in new_pages])
        self.rows_fetched += len(idx)
        return idx, self.rows[idx]

    def nbytes(self) -> int:
        return int(self.rows.nbytes)
