"""LIMS: the learned index for exact similarity search in metric spaces.

Faithful implementation of the paper's index (Fig. 1) and query algorithms
(Alg. 1: range, Alg. 2: kNN, §5.1 point queries, §5.3 updates):

  build:  k-center clustering → FFT pivots per cluster → per-(cluster,pivot)
          sorted distance columns + degree-20 polynomial rank models →
          equal-count rings → LIMS values → rows stored in pages in LIMS
          order → degree-1 position model per cluster.
  query:  TriPrune → AreaLocate (models + exponential search) → IntervalGen
          (ring-ID box → LIMS-value intervals) → PosLocate (position model +
          exponential search → pages) → exact-distance refinement.

All results are exact; learned models only ever *accelerate* locating
ranks, never decide membership.

Port of ``repro/core/index.py`` with the host builder only: the device
builder (``backend="device"``) raises ``NotImplementedError``, and
snapshot spill is not ported yet.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from .clustering import Clustering, kcenter, kmeans
from .mapping import PivotMapping, build_mapping, lims_value, ring_of_rank
from .metrics import MetricSpace
from .paging import DEFAULT_PAGE_BYTES, PageStore
from .pivots import fft_pivots
from .rankmodel import PolyRankModel, SearchStats, binary_search, exponential_search

_NO_DEVICE_BUILDER = "device builder: later slice"


@dataclass
class QueryStats:
    pages: int = 0
    dist_comps: int = 0
    probes: int = 0
    model_calls: int = 0
    candidates: int = 0
    intervals: int = 0
    clusters_pruned: int = 0
    time_s: float = 0.0

    def __iadd__(self, o: "QueryStats") -> "QueryStats":
        for f in ("pages", "dist_comps", "probes", "model_calls",
                  "candidates", "intervals", "clusters_pruned", "time_s"):
            setattr(self, f, getattr(self, f) + getattr(o, f))
        return self


@dataclass
class ClusterIndex:
    cid: int
    pivot_idx: np.ndarray          # (m,) global indices of pivot objects
    pivot_rows: np.ndarray         # (m, ...) pivot payloads
    mapping: PivotMapping
    rank_models: list              # m PolyRankModels: distance -> rank
    pos_model: PolyRankModel       # LIMS value -> storage rank
    store: PageStore               # rows in ascending-LIMS order
    store_ids: np.ndarray          # (n_i,) global object id per stored row
    pivot_d_stored: np.ndarray     # (n_i, m) pivot distances, storage order
    # (n_i,) False where the stored row is tombstoned — kept in sync by
    # delete()/retrain_cluster() so nothing ever rescans the tombstone set
    live_mask: np.ndarray = field(default_factory=lambda: np.ones(0, bool))
    # --- update state (§5.3) ---
    buf_d: np.ndarray = field(default_factory=lambda: np.empty(0))
    buf_rows: list = field(default_factory=list)
    buf_ids: list = field(default_factory=list)
    # lazy python-list views: probe loops index python floats (~5x faster
    # than numpy scalar indexing; the probe counter is the portable metric)
    _d_lists: list | None = None
    _lims_list: list | None = None

    def d_list(self, j: int) -> list:
        if self._d_lists is None:
            self._d_lists = [col.tolist() for col in self.mapping.d_sorted]
        return self._d_lists[j]

    def lims_list(self) -> list:
        if self._lims_list is None:
            self._lims_list = self.mapping.lims_sorted.tolist()
        return self._lims_list

    @property
    def n(self) -> int:
        return len(self.store_ids)

    def nbytes(self) -> int:
        b = self.mapping.d_sorted.nbytes + self.mapping.lims_sorted.nbytes
        b += self.pivot_d_stored.nbytes + self.store_ids.nbytes
        b += self.live_mask.nbytes
        b += sum(m.nbytes() for m in self.rank_models) + self.pos_model.nbytes()
        b += self.mapping.dist_min.nbytes + self.mapping.dist_max.nbytes
        b += self.buf_d.nbytes + 8 * len(self.buf_ids)
        return int(b)


class LIMSIndex:
    """Exact metric similarity index (paper: LIMS). ``learned=False`` gives
    the N-LIMS ablation: identical structure/pages, binary search instead of
    model + exponential search.  Only ``backend="host"`` is ported."""

    def __init__(self, space: MetricSpace, n_clusters: int | None = None,
                 m: int = 3, n_rings: int = 20, degree: int = 8,
                 pos_degree: int = 8, page_bytes: int = DEFAULT_PAGE_BYTES,
                 seed: int = 0, clusterer: str = "kcenter",
                 learned: bool = True, max_intervals: int = 4096,
                 backend: str = "host"):
        t0 = time.perf_counter()
        self.space = space
        self.m = m
        self.n_rings = n_rings
        self.degree = degree
        self.pos_degree = pos_degree
        self.page_bytes = page_bytes
        self.learned = learned
        self.max_intervals = max_intervals
        self.backend = backend
        # backend the most recent retrain_cluster actually ran with
        # (records "auto"'s routing decision; None before any retrain)
        self.last_retrain_backend: str | None = None
        n = space.n

        if n_clusters is None:
            from .kselect import select_k
            grid = [k for k in (8, 16, 32, 64, 128) if k <= max(2, n // 4)] or [1]
            n_clusters = select_k(space, grid, m=m, seed=seed).best_k
        self.K = min(n_clusters, n)

        if backend == "device":
            raise NotImplementedError(_NO_DEVICE_BUILDER)
        if backend != "host":
            raise ValueError(f"unknown build backend {backend!r}")
        if clusterer == "kcenter":
            self.clustering: Clustering = kcenter(space, self.K, seed=seed)
        elif clusterer == "kmeans":
            self.clustering = kmeans(space, self.K, seed=seed)
        else:
            raise ValueError(clusterer)
        self.K = self.clustering.k

        self.clusters: list[ClusterIndex] = []
        for c in range(self.K):
            self.clusters.append(self._build_cluster(c))
        self.tombstones: set[int] = set()
        # payloads of inserted objects (gid >= space.n): ``space.data``
        # only covers build-time rows, so retrains must look rows that a
        # previous retrain folded out of the buffer up here
        self.inserted_rows: dict[int, np.ndarray] = {}
        self._live = n
        self._next_id = n
        self.build_time_s = time.perf_counter() - t0
        # data-driven default kNN radius step: median ring width (§5.2)
        widths = [(ci.mapping.dist_max[j] - ci.mapping.dist_min[j]) / max(n_rings, 1)
                  for ci in self.clusters for j in range(self.m) if ci.n > 1]
        self.default_delta_r = 2.0 * float(np.median(widths)) if widths else 1.0

    # ------------------------------------------------------------------ build
    def _build_cluster(self, c: int) -> ClusterIndex:
        """Build one cluster's host structures in exact f64."""
        space, m = self.space, self.m
        mem = self.clustering.members[c]
        d1 = self.clustering.dist_to_center[mem]
        centroid = int(self.clustering.center_idx[c])
        piv = fft_pivots(space, mem, centroid, m, d1)
        pivot_d = np.empty((len(mem), m), dtype=np.float64)
        pivot_d[:, 0] = d1
        for j in range(1, m):
            if piv[j] == piv[0]:
                pivot_d[:, j] = d1
            else:
                pivot_d[:, j] = space.dist(space.data[piv[j]], mem)
        mapping = build_mapping(pivot_d, self.n_rings)
        deg = self.degree if self.learned else 1
        rank_models = [PolyRankModel.fit(mapping.d_sorted[j], deg)
                       for j in range(m)]
        pos_model = PolyRankModel.fit(
            mapping.lims_sorted.astype(np.float64), self.pos_degree)
        order = mapping.order
        rows = space.data[mem[order]]
        store = PageStore(rows, record_bytes=space.record_nbytes(),
                          page_bytes=self.page_bytes)
        return ClusterIndex(
            cid=c, pivot_idx=piv, pivot_rows=space.data[piv].copy(),
            mapping=mapping, rank_models=rank_models, pos_model=pos_model,
            store=store, store_ids=np.asarray(mem[order], dtype=np.int64),
            pivot_d_stored=pivot_d[order],
            live_mask=np.ones(len(mem), bool),
        )

    # ------------------------------------------------------------- rank locate
    def _locate(self, ci: ClusterIndex, arr: np.ndarray, x: float, side: str,
                model: PolyRankModel, st: QueryStats) -> int:
        ss = SearchStats()
        if self.learned:
            guess = model.predict_scalar(x)
            st.model_calls += 1
            pos = exponential_search(arr, x, guess, side=side, stats=ss)
        else:
            pos = binary_search(arr, x, side=side, stats=ss)
        st.probes += ss.probes
        return pos

    # ------------------------------------------------------------ range query
    def range_query(self, q: np.ndarray, r: float,
                    visited: dict | None = None,
                    collect: str = "filtered"):
        """Alg. 1. Returns (ids, dists, stats).

        ``visited``: {cid: set(page_id)} shared across calls (kNN reuse).
        ``collect``: 'filtered' → only results with d<=r; 'all' → every
        refined candidate (kNN needs candidates beyond r).
        """
        st = QueryStats()
        t0 = time.perf_counter()
        out_ids: list[int] = []
        out_d: list[float] = []
        if visited is None:
            visited = {}   # always dedupe page fetches within one query

        # --- TriPrune: one batched q→all-pivots distance evaluation -------
        piv_rows = np.concatenate([ci.pivot_rows for ci in self.clusters], axis=0)
        dq = self._dist_rows(q, piv_rows, st).reshape(self.K, self.m)
        for ci in self.clusters:
            dmin, dmax = ci.mapping.dist_min, ci.mapping.dist_max
            dqv = dq[ci.cid]
            alive = ci.n > 0 and bool(
                np.all(dqv <= dmax + r) and np.all(dqv >= dmin - r))
            if not alive:
                st.clusters_pruned += 1
            else:
                self._search_cluster(ci, q, dqv, r, st, visited, out_ids, out_d,
                                     collect)
            # insert buffer is outside the ring structure: always check
            self._search_buffer(ci, q, dqv[0], r, st, out_ids, out_d, collect)

        ids = np.asarray(out_ids, dtype=np.int64)
        ds = np.asarray(out_d, dtype=np.float64)
        if collect == "filtered":
            keep = ds <= r
            ids, ds = ids[keep], ds[keep]
        st.time_s = time.perf_counter() - t0
        return ids, ds, st

    def _search_cluster(self, ci: ClusterIndex, q, dqv, r, st: QueryStats,
                        visited, out_ids, out_d, collect) -> None:
        m, N = self.m, self.n_rings
        n = ci.n
        rid_min = np.empty(m, dtype=np.int64)
        rid_max = np.empty(m, dtype=np.int64)
        # --- AreaLocate ---------------------------------------------------
        for j in range(m):
            r_min = max(dqv[j] - r, ci.mapping.dist_min[j])
            r_max = min(dqv[j] + r, ci.mapping.dist_max[j])
            if r_min > r_max:
                return
            col = ci.d_list(j)
            lo = self._locate(ci, col, r_min, "left", ci.rank_models[j], st)
            hi = self._locate(ci, col, r_max, "right", ci.rank_models[j], st) - 1
            if hi < lo:
                return
            rid_min[j] = ring_of_rank(lo, n, N)
            rid_max[j] = ring_of_rank(hi, n, N)
        # --- IntervalGen: ring-ID box → LIMS-value intervals ---------------
        n_prefix = int(np.prod((rid_max - rid_min + 1)[:-1])) if m > 1 else 1
        intervals: list[tuple[int, int]] = []
        if n_prefix > self.max_intervals:
            # exact fallback: one covering interval (superset; refine fixes)
            intervals.append((int(lims_value(rid_min, N)),
                              int(lims_value(rid_max, N))))
        else:
            ranges = [range(int(rid_min[j]), int(rid_max[j]) + 1)
                      for j in range(m - 1)]
            lo_last, hi_last = int(rid_min[-1]), int(rid_max[-1])
            for prefix in itertools.product(*ranges):
                base = 0
                for j, p in enumerate(prefix):
                    base = base * N + p
                base *= N
                lo_v, hi_v = base + lo_last, base + hi_last
                # merge with previous interval when contiguous in LIMS space
                # (adjacent prefixes with ring-spanning last dim): exact, and
                # collapses O(prod |L_j|) locates into few.
                if intervals and lo_v <= intervals[-1][1] + 1:
                    intervals[-1] = (intervals[-1][0], hi_v)
                else:
                    intervals.append((lo_v, hi_v))
        st.intervals += len(intervals)
        # --- PosLocate + fetch + refine ------------------------------------
        vis = None
        if visited is not None:
            vis = visited.setdefault(ci.cid, set())
        lims_sorted = ci.lims_list()
        for lo_v, hi_v in intervals:
            lb = self._locate(ci, lims_sorted, lo_v, "left", ci.pos_model, st)
            ub = self._locate(ci, lims_sorted, hi_v, "right", ci.pos_model, st) - 1
            if ub < lb:
                continue
            pages = ci.store.page_range(lb, ub)
            before = ci.store.page_accesses
            idx, rows = ci.store.fetch_pages(pages, vis)
            st.pages += ci.store.page_accesses - before
            if len(idx) == 0:
                continue
            d = self._dist_rows(q, rows, st)
            st.candidates += len(idx)
            for row_i, dist in zip(idx, d):
                gid = int(ci.store_ids[row_i])
                if gid in self.tombstones:
                    continue
                if collect == "all" or dist <= r:
                    out_ids.append(gid)
                    out_d.append(float(dist))

    def _search_buffer(self, ci: ClusterIndex, q, d_q_centroid, r,
                       st: QueryStats, out_ids, out_d, collect) -> None:
        nb = len(ci.buf_ids)
        if nb == 0:
            return
        lo = np.searchsorted(ci.buf_d, d_q_centroid - r, side="left")
        hi = np.searchsorted(ci.buf_d, d_q_centroid + r, side="right")
        st.probes += max(1, int(np.ceil(np.log2(nb + 1)))) * 2
        if hi <= lo:
            return
        rows = np.stack([ci.buf_rows[i] for i in range(lo, hi)])
        st.pages += -(-len(rows) // ci.store.omega)
        d = self._dist_rows(q, rows, st)
        st.candidates += len(rows)
        for i, dist in zip(range(lo, hi), d):
            gid = ci.buf_ids[i]
            if gid in self.tombstones:
                continue
            if collect == "all" or dist <= r:
                out_ids.append(gid)
                out_d.append(float(dist))

    # ------------------------------------------------------------- point query
    def point_query(self, q: np.ndarray):
        """§5.1: k-center property prunes K-1 clusters; search nearest only."""
        st = QueryStats()
        t0 = time.perf_counter()
        piv_rows = np.concatenate([ci.pivot_rows for ci in self.clusters], axis=0)
        dq = self._dist_rows(q, piv_rows, st).reshape(self.K, self.m)
        order = np.argsort(dq[:, 0])
        out_ids: list[int] = []
        out_d: list[float] = []
        # identical objects can sit in a different cluster only if equidistant
        # centroids were tie-broken differently; scan clusters whose centroid
        # distance equals the minimum (exactness), typically just one.
        best = dq[order[0], 0]
        visited: dict = {}
        for c in order:
            if dq[c, 0] > best:
                break
            ci = self.clusters[c]
            if ci.n > 0 and np.all(dq[c] <= ci.mapping.dist_max) and \
               np.all(dq[c] >= ci.mapping.dist_min):
                self._search_cluster(ci, q, dq[c], 0.0, st, visited,
                                     out_ids, out_d, "filtered")
            self._search_buffer(ci, q, dq[c, 0], 0.0, st, out_ids, out_d,
                                "filtered")
        ids = np.asarray(out_ids, dtype=np.int64)
        ds = np.asarray(out_d, dtype=np.float64)
        keep = ds <= 0.0
        st.time_s = time.perf_counter() - t0
        return ids[keep], st

    # --------------------------------------------------------------- kNN query
    def live_count(self) -> int:
        """Objects that a query can return: stored + buffered − tombstoned.
        Maintained incrementally by insert/delete — O(1) on the query path."""
        return self._live

    def knn_query(self, q: np.ndarray, k: int, delta_r: float | None = None):
        """Alg. 2: growing-radius range queries, never re-reading pages.

        ``k`` is clamped to the number of live objects — asking for more
        neighbours than the index holds returns them all (previously the
        radius loop could never satisfy ``k`` and ran forever).
        """
        st = QueryStats()
        t0 = time.perf_counter()
        k = min(int(k), self.live_count())
        if k <= 0:
            return (np.empty(0, np.int64), np.empty(0), st)
        dr = float(delta_r) if delta_r is not None else self.default_delta_r
        visited: dict = {}
        heap_d = np.full(k, np.inf)
        heap_id = np.full(k, -1, dtype=np.int64)
        r, flag = 0.0, False
        while not flag:
            r += dr
            if heap_d[-1] < r:        # furthest candidate inside radius
                flag = True
            ids, ds, st_i = self.range_query(q, r, visited=visited,
                                             collect="all")
            st += st_i
            if len(ids):
                cat_d = np.concatenate([heap_d, ds])
                cat_i = np.concatenate([heap_id, ids])
                # dedupe by id, keep best distance
                uniq, ui = np.unique(cat_i, return_index=True)
                keep = ui[uniq >= 0] if (uniq >= 0).any() else ui
                cat_d, cat_i = cat_d[keep], cat_i[keep]
                pad = k - len(cat_d)
                if pad > 0:
                    cat_d = np.concatenate([cat_d, np.full(pad, np.inf)])
                    cat_i = np.concatenate([cat_i, np.full(pad, -1, np.int64)])
                sel = np.argsort(cat_d, kind="stable")[:k]
                heap_d, heap_id = cat_d[sel], cat_i[sel]
        st.time_s = time.perf_counter() - t0
        got = heap_id >= 0
        return heap_id[got], heap_d[got], st

    # ----------------------------------------------------------------- updates
    def insert(self, p: np.ndarray) -> int:
        """§5.3: append to the nearest cluster's sorted insert buffer."""
        st = QueryStats()
        cents = np.stack([ci.pivot_rows[0] for ci in self.clusters])
        d = self._dist_rows(p, cents, st)
        c = int(np.argmin(d))
        ci = self.clusters[c]
        pos = int(np.searchsorted(ci.buf_d, d[c]))
        row = np.array(p, copy=True)
        ci.buf_d = np.insert(ci.buf_d, pos, d[c])
        ci.buf_rows.insert(pos, row)
        ci.buf_ids.insert(pos, self._next_id)
        gid = self._next_id
        self.inserted_rows[gid] = row
        self._live += 1
        self._next_id += 1
        return gid

    def delete(self, q: np.ndarray) -> int:
        """Point query → tombstone; refresh the cluster's dist_min/max."""
        ids, _ = self.point_query(q)
        removed = 0
        for gid in ids:
            gid = int(gid)
            if gid in self.tombstones:
                continue
            self.tombstones.add(gid)
            removed += 1
            for ci in self.clusters:
                hit = np.where(ci.store_ids == gid)[0]
                if len(hit):
                    # incremental live mask: O(n) per delete, not
                    # O(n·|tombstones|) via an isin rebuild
                    ci.live_mask[hit] = False
                    if ci.live_mask.any():
                        pd = ci.pivot_d_stored[ci.live_mask]
                        ci.mapping.dist_min = pd.min(axis=0)
                        ci.mapping.dist_max = pd.max(axis=0)
                    break
        self._live -= removed
        return removed

    def retrain_cluster(self, c: int, backend: str | None = None) -> None:
        """Partial reconstruction (§5.3): rebuild one cluster's index,
        folding its insert buffer in and dropping tombstones.

        Only the host rebuild is ported: ``"auto"`` takes it, and
        ``"device"`` raises ``NotImplementedError``.  ``None`` uses the
        backend the index was built with.  The chosen backend lands in
        ``last_retrain_backend``.
        """
        backend = self.backend if backend is None else backend
        if backend not in ("host", "device", "auto"):
            raise ValueError(f"unknown build backend {backend!r}")
        if backend == "device":
            raise NotImplementedError(_NO_DEVICE_BUILDER)
        ci = self.clusters[c]
        live = [int(g) for g in ci.store_ids if g not in self.tombstones]
        # build-time rows come from space.data; rows a previous retrain
        # folded in (gid >= space.n) come from the inserted-payload map
        all_rows = [self.space.data[g] if g < self.space.n
                    else self.inserted_rows[g] for g in live]
        all_ids = list(live)
        for gid, row in zip(ci.buf_ids, ci.buf_rows):
            if gid not in self.tombstones:
                all_rows.append(row)
                all_ids.append(gid)
        if not all_rows:
            return
        self.last_retrain_backend = "host"
        sub = MetricSpace(np.stack(all_rows), self.space.metric,
                          self.space._custom)
        deg = self.degree if self.learned else 1
        # single-cluster LIMS over the member set, centroid = pivot 0
        mem = np.arange(sub.n)
        d1 = sub.dist(ci.pivot_rows[0], mem)
        piv_rows = [ci.pivot_rows[0]]
        pivot_d = np.empty((sub.n, self.m))
        pivot_d[:, 0] = d1
        d_near = d1.copy()
        for j in range(1, self.m):
            nxt = int(np.argmax(d_near))
            piv_rows.append(sub.data[nxt])
            dj = sub.dist(sub.data[nxt], mem)
            pivot_d[:, j] = dj
            d_near = np.minimum(d_near, dj)
        mapping = build_mapping(pivot_d, self.n_rings)
        ci.rank_models = [PolyRankModel.fit(mapping.d_sorted[j], deg)
                          for j in range(self.m)]
        ci.pos_model = PolyRankModel.fit(
            mapping.lims_sorted.astype(np.float64), self.pos_degree)
        order = mapping.order
        ci.mapping = mapping
        ci.pivot_rows = np.stack(piv_rows)
        ci.store = PageStore(sub.data[order], record_bytes=sub.record_nbytes(),
                             page_bytes=self.page_bytes)
        ci.store_ids = np.asarray([all_ids[i] for i in order], dtype=np.int64)
        ci.pivot_d_stored = pivot_d[order]
        ci.live_mask = np.ones(sub.n, bool)
        ci.buf_d = np.empty(0)
        ci.buf_rows, ci.buf_ids = [], []
        ci._d_lists = None
        ci._lims_list = None
        # tombstoned inserts can never resurface: free their payloads
        for g in set(self.inserted_rows) & self.tombstones:
            del self.inserted_rows[g]

    # ------------------------------------------------------------------ helpers
    def _dist_rows(self, q, rows, st: QueryStats) -> np.ndarray:
        st.dist_comps += len(rows)
        if self.space._custom is not None:
            return np.asarray([self.space._custom(q, row) for row in rows])
        from .metrics import dist_one_to_many
        return dist_one_to_many(q, rows, self.space.metric)

    def index_nbytes(self) -> int:
        return int(sum(ci.nbytes() for ci in self.clusters))

    def data_nbytes(self) -> int:
        return int(sum(ci.store.nbytes() for ci in self.clusters))

    def reset_page_counters(self) -> None:
        for ci in self.clusters:
            ci.store.reset_counters()
