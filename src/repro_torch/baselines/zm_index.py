"""ZM index (Wang et al., MDM'19): z-order curve + learned CDF.

Coordinates are quantized to ``bits`` per dimension and bit-interleaved
into a Morton code; data is sorted by code and a learned model predicts
rank from code. A range query maps the L_p ball to its bounding box, takes
the [z(box_lo), z(box_hi)] code interval and scans it — the naive ZM
behaviour the paper critiques (many irrelevant points between z_lo and
z_hi, worse with dimensionality). kNN is unsupported, as in the paper.
Vector metrics only (needs coordinates).

Port of ``repro/baselines/zm_index.py`` (``:1-104``), copied; it
imports ``repro_torch.core``.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.index import QueryStats
from ..core.metrics import MetricSpace, dist_one_to_many
from ..core.paging import DEFAULT_PAGE_BYTES, PageStore
from ..core.rankmodel import PolyRankModel, SearchStats, exponential_search


def _interleave(codes: np.ndarray, bits: int) -> np.ndarray:
    """Bit-interleave (n, d) uint codes → (n,) uint64 Morton codes."""
    n, d = codes.shape
    out = np.zeros(n, dtype=np.uint64)
    for b in range(bits - 1, -1, -1):          # msb first
        for j in range(d):
            out = (out << np.uint64(1)) | ((codes[:, j] >> np.uint64(b)) & np.uint64(1))
    return out


class ZMIndex:
    name = "zm"

    def __init__(self, space: MetricSpace, degree: int = 20,
                 page_bytes: int = DEFAULT_PAGE_BYTES, bits: int | None = None,
                 **_):
        if not space.is_vector:
            raise ValueError("ZM index requires a vector space")
        t0 = time.perf_counter()
        self.space = space
        X = space.data.astype(np.float64)
        self.lo = X.min(axis=0)
        self.hi = X.max(axis=0)
        d = X.shape[1]
        self.bits = bits if bits is not None else max(2, min(10, 60 // d))
        self.d = d
        z = self._zcode(X)
        order = np.argsort(z, kind="stable")
        self.z_sorted = z[order].astype(np.float64)  # model works on floats
        self.store = PageStore(X[order], record_bytes=space.record_nbytes(),
                               page_bytes=page_bytes)
        self.store_ids = order.astype(np.int64)
        self.model = PolyRankModel.fit(self.z_sorted, degree)
        self._z_list = self.z_sorted.tolist()
        self.build_time_s = time.perf_counter() - t0

    def _zcode(self, X: np.ndarray) -> np.ndarray:
        span = np.maximum(self.hi - self.lo, 1e-12)
        q = np.clip((X - self.lo) / span, 0.0, 1.0)
        cells = (q * (2 ** self.bits - 1)).astype(np.uint64)
        return _interleave(cells, self.bits)

    def _locate(self, z: float, side: str, st: QueryStats) -> int:
        ss = SearchStats()
        guess = self.model.predict_scalar(z)
        st.model_calls += 1
        pos = exponential_search(self._z_list, z, guess, side=side, stats=ss)
        st.probes += ss.probes
        return pos

    def range_query(self, q, r, collect="filtered"):
        st = QueryStats()
        t0 = time.perf_counter()
        box_lo = self._zcode(np.maximum(q - r, self.lo)[None, :])[0]
        box_hi = self._zcode(np.minimum(q + r, self.hi)[None, :])[0]
        lb = self._locate(float(box_lo), "left", st)
        ub = self._locate(float(box_hi), "right", st) - 1
        out_ids: list[int] = []
        out_d: list[float] = []
        if ub >= lb:
            idx, rows = self.store.fetch_pages(
                self.store.page_range(lb, ub), set())
            st.pages += len(set(self.store.page_range(lb, ub)))
            d = dist_one_to_many(q, rows, self.space.metric)
            st.dist_comps += len(rows)
            st.candidates += len(rows)
            for i, dist in zip(idx, d):
                if dist <= r:
                    out_ids.append(int(self.store_ids[i]))
                    out_d.append(float(dist))
        st.time_s = time.perf_counter() - t0
        return np.asarray(out_ids, dtype=np.int64), np.asarray(out_d), st

    def point_query(self, q):
        ids, d, st = self.range_query(q, 0.0)
        return ids, st

    def index_nbytes(self) -> int:
        return int(self.z_sorted.nbytes + self.store_ids.nbytes +
                   self.model.nbytes())

    def reset_page_counters(self) -> None:
        self.store.reset_counters()
