"""ML-index (Davitkova et al., EDBT'20): iDistance + learned models.

Data is clustered; each object is keyed by ``key(p) = j * scale +
dist(p, c_j)`` (single reference point per cluster — the paper's critique
of ML is precisely that equi-distant points from one pivot collapse to the
same key, inflating false positives vs LIMS's multi-pivot rings). Keys are
sorted into one global page sequence; a learned model per cluster predicts
rank from key; exponential search corrects it. Range/kNN identical in
spirit to LIMS (growing radius for kNN).

Port of ``repro/baselines/ml_index.py`` (``:1-154``), copied; it
imports ``repro_torch.core``.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.clustering import kcenter
from ..core.index import QueryStats
from ..core.metrics import MetricSpace, dist_one_to_many
from ..core.paging import DEFAULT_PAGE_BYTES, PageStore
from ..core.rankmodel import PolyRankModel, SearchStats, exponential_search


class MLIndex:
    name = "ml"

    def __init__(self, space: MetricSpace, n_clusters: int = 50,
                 degree: int = 20, page_bytes: int = DEFAULT_PAGE_BYTES,
                 seed: int = 0, **_):
        t0 = time.perf_counter()
        self.space = space
        self.K = min(n_clusters, space.n)
        cl = kcenter(space, self.K, seed=seed)
        self.K = cl.k
        self.center_idx = cl.center_idx
        self.center_rows = space.data[cl.center_idx].copy()
        # iDistance scale: strictly larger than any intra-cluster distance
        self.dist_min = np.zeros(self.K)
        self.dist_max = np.zeros(self.K)
        for c in range(self.K):
            mem = cl.members[c]
            if len(mem):
                d = cl.dist_to_center[mem]
                self.dist_min[c] = d.min()
                self.dist_max[c] = d.max()
        self.scale = float(self.dist_max.max()) * 1.5 + 1e-9
        keys = cl.assign * self.scale + cl.dist_to_center
        order = np.argsort(keys, kind="stable")
        self.keys_sorted = keys[order]
        self.store = PageStore(space.data[order],
                               record_bytes=space.record_nbytes(),
                               page_bytes=page_bytes)
        self.store_ids = order.astype(np.int64)
        # per-cluster rank models over the global sorted key array
        self.models: list[PolyRankModel] = []
        self.cluster_bounds = np.searchsorted(
            self.keys_sorted, np.arange(self.K + 1) * self.scale, side="left")
        self._segs: list = []
        for c in range(self.K):
            lo, hi = self.cluster_bounds[c], self.cluster_bounds[c + 1]
            m = PolyRankModel.fit(self.keys_sorted[lo:hi], degree)
            self.models.append(m)
            self._segs.append(self.keys_sorted[lo:hi].tolist())
        self.build_time_s = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _locate(self, c: int, key: float, side: str, st: QueryStats) -> int:
        lo = self.cluster_bounds[c]
        seg = self._segs[c]
        if len(seg) == 0:
            return int(lo)
        ss = SearchStats()
        guess = self.models[c].predict_scalar(key)
        st.model_calls += 1
        pos = exponential_search(seg, key, guess, side=side, stats=ss)
        st.probes += ss.probes
        return int(lo + pos)

    def range_query(self, q, r, visited: set | None = None, collect="filtered"):
        st = QueryStats()
        t0 = time.perf_counter()
        if visited is None:
            visited = set()
        dq = self._dist_rows(q, self.center_rows, st)
        out_ids: list[int] = []
        out_d: list[float] = []
        for c in range(self.K):
            r_lo = max(dq[c] - r, self.dist_min[c])
            r_hi = min(dq[c] + r, self.dist_max[c])
            if r_lo > r_hi:
                st.clusters_pruned += 1
                continue
            lb = self._locate(c, c * self.scale + r_lo, "left", st)
            ub = self._locate(c, c * self.scale + r_hi, "right", st) - 1
            if ub < lb:
                continue
            before = self.store.page_accesses
            idx, rows = self.store.fetch_pages(self.store.page_range(lb, ub),
                                               visited)
            st.pages += self.store.page_accesses - before
            if len(idx) == 0:
                continue
            d = self._dist_rows(q, rows, st)
            st.candidates += len(idx)
            for i, dist in zip(idx, d):
                if collect == "all" or dist <= r:
                    out_ids.append(int(self.store_ids[i]))
                    out_d.append(float(dist))
        st.time_s = time.perf_counter() - t0
        return (np.asarray(out_ids, dtype=np.int64),
                np.asarray(out_d), st)

    def knn_query(self, q, k, delta_r: float | None = None):
        st = QueryStats()
        t0 = time.perf_counter()
        dr = delta_r if delta_r is not None else \
            float(np.median(self.dist_max[self.dist_max > 0])) / 10 or 1.0
        visited: set = set()
        heap_d = np.full(k, np.inf)
        heap_id = np.full(k, -1, dtype=np.int64)
        r, flag = 0.0, False
        while not flag:
            r += dr
            if heap_d[-1] < r:
                flag = True
            ids, ds, st_i = self.range_query(q, r, visited=visited,
                                             collect="all")
            st += st_i
            if len(ids):
                cat_d = np.concatenate([heap_d, ds])
                cat_i = np.concatenate([heap_id, ids])
                sel = np.argsort(cat_d, kind="stable")[:k]
                heap_d, heap_id = cat_d[sel], cat_i[sel]
        st.time_s = time.perf_counter() - t0
        got = heap_id >= 0
        return heap_id[got], heap_d[got], st

    def point_query(self, q):
        ids, d, st = self.range_query(q, 0.0)
        return ids, st

    def _dist_rows(self, q, rows, st: QueryStats):
        st.dist_comps += len(rows)
        if self.space._custom is not None:
            return np.asarray([self.space._custom(q, row) for row in rows])
        return dist_one_to_many(q, rows, self.space.metric)

    def index_nbytes(self) -> int:
        b = self.keys_sorted.nbytes + self.store_ids.nbytes
        b += self.center_rows.nbytes + self.cluster_bounds.nbytes
        b += sum(m.nbytes() for m in self.models)
        return int(b)

    def reset_page_counters(self) -> None:
        self.store.reset_counters()
