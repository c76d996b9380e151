"""Choosing the number of clusters K (paper §5.4).

Overhead(K) = OR(K) + λ·MAE(K):
  * OR (Eq. 14/15): mean pairwise overlap of cluster balls, measured along
    the centroid axis;
  * MAE (Eq. 16): mean absolute error of *linear* rank models over every
    (cluster, pivot) sorted-distance column — uneven intra-cluster
    distributions fit lines badly.
K* is the elbow of the overhead curve (max distance to the chord —
"kneedle" criterion), as in the paper's elbow method.

Copied from ``repro/core/kselect.py``: results must match it bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .clustering import kcenter
from .metrics import MetricSpace
from .pivots import fft_pivots


def overlap_rate(space: MetricSpace, center_idx: np.ndarray,
                 dist_min1: np.ndarray, dist_max1: np.ndarray) -> float:
    """Eq. (14)/(15): pairwise ball-overlap length over dist_max, averaged."""
    k = len(center_idx)
    if k < 2:
        return 0.0
    cc = np.empty((k, k), dtype=np.float64)
    for i in range(k):
        cc[i] = space.dist(space.data[center_idx[i]], center_idx)
    total = 0.0
    for i in range(k):
        if dist_max1[i] <= 0:
            continue
        hi = np.minimum(cc[i] + dist_max1, dist_max1[i])
        lo = np.maximum(cc[i] - dist_max1, dist_min1[i])
        r = hi - lo
        r[i] = 0.0
        total += float(np.sum(np.maximum(r, 0.0))) / dist_max1[i]
    return total / (k * (k - 1))


def linear_mae(d_sorted_cols: list[np.ndarray]) -> float:
    """Eq. (16): MAE of per-column least-squares lines, over all objects."""
    total_err, total_n = 0.0, 0
    for col in d_sorted_cols:
        n = len(col)
        if n == 0:
            continue
        ranks = np.searchsorted(col, col, side="left").astype(np.float64)
        if col[-1] > col[0]:
            A = np.stack([col, np.ones_like(col)], axis=1)
            sol, *_ = np.linalg.lstsq(A, ranks, rcond=None)
            pred = A @ sol
        else:
            pred = np.full(n, ranks.mean())
        total_err += float(np.abs(pred - ranks).sum())
        total_n += n
    return total_err / max(total_n, 1)


@dataclass
class KSelectResult:
    ks: np.ndarray
    overhead: np.ndarray
    or_curve: np.ndarray
    mae_curve: np.ndarray
    best_k: int


def select_k(space: MetricSpace, ks, m: int = 3, seed: int = 0,
             lam: float | None = None) -> KSelectResult:
    ks = np.asarray(sorted(ks))
    ors, maes = [], []
    for k in ks:
        cl = kcenter(space, int(k), seed=seed)
        dmin1 = np.empty(cl.k)
        dmax1 = np.empty(cl.k)
        cols = []
        for c in range(cl.k):
            mem = cl.members[c]
            d1 = cl.dist_to_center[mem]
            dmin1[c] = d1.min() if len(mem) else 0.0
            dmax1[c] = d1.max() if len(mem) else 0.0
            piv = fft_pivots(space, mem, int(cl.center_idx[c]), m, d1)
            for j in range(m):
                if j == 0:
                    cols.append(np.sort(d1))
                else:
                    cols.append(np.sort(space.dist(space.data[piv[j]], mem)))
        ors.append(overlap_rate(space, cl.center_idx, dmin1, dmax1))
        maes.append(linear_mae(cols))
    ors = np.asarray(ors)
    maes = np.asarray(maes)
    lam = lam if lam is not None else 1.0 / max(maes.max(), 1e-12)  # paper: 1/max(MAE)
    overhead = ors + lam * maes
    best_k = int(ks[_elbow(ks.astype(np.float64), overhead)])
    return KSelectResult(ks, overhead, ors, maes, best_k)


def _elbow(x: np.ndarray, y: np.ndarray) -> int:
    """Index of max perpendicular distance to the chord (kneedle)."""
    if len(x) < 3:
        return len(x) - 1
    x0, y0, x1, y1 = x[0], y[0], x[-1], y[-1]
    denom = np.hypot(x1 - x0, y1 - y0) + 1e-12
    d = np.abs((y1 - y0) * x - (x1 - x0) * y + x1 * y0 - y1 * x0) / denom
    return int(np.argmax(d))
