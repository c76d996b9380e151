"""Metric ball tree — the traditional-index stand-in for the M-tree.

Recursive 2-center splits; every node (internal or leaf) occupies one disk
page, as M-tree nodes do, so "page accesses" counts every node visited.
Triangle-inequality pruning: skip a subtree when d(q, c) - radius > r.
Works for any metric (only distances used).

Port of ``repro/baselines/balltree.py`` (``:1-153``), copied; it
imports ``repro_torch.core``.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.index import QueryStats
from ..core.metrics import MetricSpace, dist_one_to_many
from ..core.paging import DEFAULT_PAGE_BYTES


@dataclass
class _Node:
    center_row: np.ndarray
    radius: float
    idx: np.ndarray | None = None        # leaf: member global ids
    children: list = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return self.idx is not None


class BallTree:
    name = "balltree"

    def __init__(self, space: MetricSpace, page_bytes: int = DEFAULT_PAGE_BYTES,
                 seed: int = 0, **_):
        t0 = time.perf_counter()
        self.space = space
        self.omega = max(1, page_bytes // max(1, space.record_nbytes()))
        self._rng = np.random.default_rng(seed)
        self.n_nodes = 0
        self.root = self._build(np.arange(space.n))
        self.build_time_s = time.perf_counter() - t0
        self.page_accesses = 0

    def _build(self, idx: np.ndarray) -> _Node:
        self.n_nodes += 1
        space = self.space
        c_local = int(self._rng.integers(len(idx)))
        d0 = space.dist(space.data[idx[c_local]], idx)
        center = space.data[idx[c_local]].copy()
        radius = float(d0.max()) if len(idx) else 0.0
        if len(idx) <= self.omega:
            return _Node(center, radius, idx=idx)
        # 2-center split: farthest point from c, then farthest from that
        a = int(np.argmax(d0))
        da = space.dist(space.data[idx[a]], idx)
        b = int(np.argmax(da))
        db = space.dist(space.data[idx[b]], idx)
        left = da <= db
        if left.sum() in (0, len(idx)):      # degenerate: median split
            half = max(1, len(idx) // 2)
            order = np.argsort(da, kind="stable")
            l_idx, r_idx = idx[order[:half]], idx[order[half:]]
        else:
            l_idx, r_idx = idx[left], idx[~left]
        node = _Node(center, radius)
        node.children = [self._build(l_idx), self._build(r_idx)]
        return node

    # ------------------------------------------------------------------
    def range_query(self, q, r):
        st = QueryStats()
        t0 = time.perf_counter()
        out_ids: list[int] = []
        out_d: list[float] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            st.pages += 1                       # node read = page access
            dc = self._d1(q, node.center_row, st)
            if dc - node.radius > r:
                continue
            if node.is_leaf:
                d = self._drows(q, node.idx, st)
                st.candidates += len(node.idx)
                hit = d <= r
                out_ids.extend(int(i) for i in node.idx[hit])
                out_d.extend(float(x) for x in d[hit])
            else:
                stack.extend(node.children)
        st.time_s = time.perf_counter() - t0
        return np.asarray(out_ids, dtype=np.int64), np.asarray(out_d), st

    def knn_query(self, q, k):
        st = QueryStats()
        t0 = time.perf_counter()
        best: list[tuple[float, int]] = []      # max-heap via negation
        heap: list[tuple[float, int, _Node]] = []
        tie = 0

        def push(node):
            nonlocal tie
            dc = self._d1(q, node.center_row, st)
            heapq.heappush(heap, (max(0.0, dc - node.radius), tie, node))
            tie += 1

        push(self.root)
        while heap:
            lb, _, node = heapq.heappop(heap)
            if len(best) == k and lb > -best[0][0]:
                break
            st.pages += 1
            if node.is_leaf:
                d = self._drows(q, node.idx, st)
                st.candidates += len(node.idx)
                for dist, gid in zip(d, node.idx):
                    if len(best) < k:
                        heapq.heappush(best, (-float(dist), int(gid)))
                    elif dist < -best[0][0]:
                        heapq.heapreplace(best, (-float(dist), int(gid)))
            else:
                for ch in node.children:
                    push(ch)
        st.time_s = time.perf_counter() - t0
        pairs = sorted((-nd, gid) for nd, gid in best)
        return (np.asarray([g for _, g in pairs], dtype=np.int64),
                np.asarray([d for d, _ in pairs]), st)

    def point_query(self, q):
        ids, d, st = self.range_query(q, 0.0)
        return ids, st

    def _d1(self, q, row, st) -> float:
        st.dist_comps += 1
        if self.space._custom is not None:
            return float(self.space._custom(q, row))
        return float(dist_one_to_many(q, row[None, :], self.space.metric)[0])

    def _drows(self, q, idx, st) -> np.ndarray:
        st.dist_comps += len(idx)
        rows = self.space.data[idx]
        if self.space._custom is not None:
            return np.asarray([self.space._custom(q, row) for row in rows])
        return dist_one_to_many(q, rows, self.space.metric)

    def index_nbytes(self) -> int:
        # centers + radii per node ~ the M-tree routing-entry overhead
        rec = self.space.record_nbytes()
        return int(self.n_nodes * (rec + 8))

    def reset_page_counters(self) -> None:
        pass
