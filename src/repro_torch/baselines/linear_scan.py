"""Brute-force page scan: the floor every index must beat.

Port of ``repro/baselines/linear_scan.py`` (``:1-56``), copied; it
imports ``repro_torch.core``.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.index import QueryStats
from ..core.metrics import MetricSpace, dist_one_to_many
from ..core.paging import DEFAULT_PAGE_BYTES, PageStore


class LinearScan:
    name = "scan"

    def __init__(self, space: MetricSpace, page_bytes: int = DEFAULT_PAGE_BYTES,
                 **_):
        t0 = time.perf_counter()
        self.space = space
        self.store = PageStore(space.data, record_bytes=space.record_nbytes(),
                               page_bytes=page_bytes)
        self.build_time_s = time.perf_counter() - t0

    def _all_dists(self, q, st: QueryStats) -> np.ndarray:
        idx, rows = self.store.fetch_pages(range(self.store.n_pages), set())
        st.pages += self.store.n_pages
        st.dist_comps += len(rows)
        if self.space._custom is not None:
            return np.asarray([self.space._custom(q, r) for r in rows])
        return dist_one_to_many(q, rows, self.space.metric)

    def range_query(self, q, r):
        st = QueryStats()
        t0 = time.perf_counter()
        d = self._all_dists(q, st)
        ids = np.where(d <= r)[0]
        st.time_s = time.perf_counter() - t0
        return ids, d[ids], st

    def knn_query(self, q, k):
        st = QueryStats()
        t0 = time.perf_counter()
        d = self._all_dists(q, st)
        order = np.argsort(d, kind="stable")[:k]
        st.time_s = time.perf_counter() - t0
        return order, d[order], st

    def point_query(self, q):
        ids, d, st = self.range_query(q, 0.0)
        return ids, st

    def index_nbytes(self) -> int:
        return 0

    def reset_page_counters(self) -> None:
        self.store.reset_counters()
