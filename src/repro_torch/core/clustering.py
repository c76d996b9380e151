"""Data clustering for LIMS: k-center (Gonzalez farthest-first) + kMeans.

Port of ``repro/core/clustering.py``; kMeans distances go through the
port's torch ``cdist``.

The paper uses the k-center algorithm (2-approximate optimal radius,
Hochbaum & Shmoys) and notes kMeans is a drop-in alternative. Both are
implemented over a ``MetricSpace`` so they work for any metric (kMeans only
for vector spaces, since it needs means).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .metrics import MetricSpace, cdist


@dataclass
class Clustering:
    center_idx: np.ndarray        # (K,) indices into the dataset
    assign: np.ndarray            # (n,) cluster id per object
    dist_to_center: np.ndarray    # (n,) distance to own centroid
    members: list                 # list of K index arrays

    @property
    def k(self) -> int:
        return len(self.center_idx)


def kcenter(space: MetricSpace, k: int, seed: int = 0) -> Clustering:
    """Gonzalez farthest-first traversal k-center clustering.

    O(nK) distance computations; each pass is one one-vs-many batched call.
    """
    n = space.n
    k = min(k, n)
    rng = np.random.default_rng(seed)
    first = int(rng.integers(n))
    centers = [first]
    d_near = space.dist_points(first)          # (n,) dist to nearest center
    assign = np.zeros(n, dtype=np.int64)
    for c in range(1, k):
        nxt = int(np.argmax(d_near))
        centers.append(nxt)
        d_new = space.dist_points(nxt)
        closer = d_new < d_near
        assign[closer] = c
        d_near = np.where(closer, d_new, d_near)
    center_idx = np.asarray(centers, dtype=np.int64)
    members = [np.where(assign == c)[0] for c in range(k)]
    return Clustering(center_idx, assign, d_near, members)


def kmeans(space: MetricSpace, k: int, iters: int = 15, seed: int = 0) -> Clustering:
    """Lloyd's kMeans (vector metrics only); centers snapped to the nearest
    data object at the end so the centroid is a real object (LIMS uses the
    centroid as pivot #1 and the k-center point-query pruning property)."""
    if not space.is_vector:
        raise ValueError("kmeans requires a vector metric")
    X = space.data.astype(np.float64)
    n = space.n
    k = min(k, n)
    rng = np.random.default_rng(seed)
    cent = X[rng.choice(n, size=k, replace=False)]
    for _ in range(iters):
        d = _cd(X, cent, space)
        assign = np.argmin(d, axis=1)
        for c in range(k):
            sel = assign == c
            if sel.any():
                cent[c] = X[sel].mean(axis=0)
    d = _cd(X, cent, space)
    assign = np.argmin(d, axis=1)
    # snap centers to nearest member
    center_idx = np.empty(k, dtype=np.int64)
    for c in range(k):
        sel = np.where(assign == c)[0]
        if len(sel) == 0:
            center_idx[c] = int(np.argmin(d[:, c]))
        else:
            center_idx[c] = sel[np.argmin(d[sel, c])]
    d_own = space.dist(space.data[center_idx[0]]) * 0  # placeholder fill below
    d_own = np.empty(n, dtype=np.float64)
    for c in range(k):
        sel = np.where(assign == c)[0]
        if len(sel):
            d_own[sel] = space.dist(space.data[center_idx[c]], sel)
    members = [np.where(assign == c)[0] for c in range(k)]
    return Clustering(center_idx, assign, d_own, members)


def _cd(X, cent, space: MetricSpace) -> np.ndarray:
    space.dist_count += X.shape[0] * cent.shape[0]
    metric = space.metric if space.metric != "cosine" else "l2"
    return cdist(torch.from_numpy(X), torch.from_numpy(cent), metric).numpy()
