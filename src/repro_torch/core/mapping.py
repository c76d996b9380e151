"""Pivot-based mapping: super rings, ring IDs and LIMS values (Defs. 5-8).

Per (cluster, pivot) the sorted distance list is cut into N equal-count
"super rings"; an object's LIMS value is the lexicographic concatenation of
its m ring IDs, realized as the integer  sum_j rid_j * N^(m-1-j)  — which
satisfies the paper's binary relation (Def. 8) exactly.

Copied from ``repro/core/mapping.py``: results must match it bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def ranks_with_ties_low(sorted_x: np.ndarray, x: np.ndarray) -> np.ndarray:
    """rank(x) = |{x' < x}| for each x, against the sorted column."""
    return np.searchsorted(sorted_x, x, side="left")


def ring_of_rank(rank, n: int, n_rings: int):
    """Equation (4): rid = floor(rank / ceil(n / N)), clipped to [0, N-1]."""
    width = -(-n // n_rings) if n > 0 else 1
    return np.clip(np.asarray(rank) // max(width, 1), 0, n_rings - 1)


@dataclass
class PivotMapping:
    """Everything derived from one cluster's (n_i, m) pivot-distance matrix."""
    d_sorted: np.ndarray       # (m, n_i) per-pivot sorted distances
    rids: np.ndarray           # (n_i, m) ring id per object (original order)
    lims: np.ndarray           # (n_i,) LIMS value per object (original order)
    order: np.ndarray          # argsort of lims (stable): storage order
    lims_sorted: np.ndarray    # lims[order]
    n_rings: int
    dist_min: np.ndarray       # (m,)
    dist_max: np.ndarray       # (m,)

    @property
    def n(self) -> int:
        return self.lims.shape[0]

    @property
    def m(self) -> int:
        return self.d_sorted.shape[0]


def build_mapping(pivot_d: np.ndarray, n_rings: int) -> PivotMapping:
    """``pivot_d``: (n_i, m) distances object→pivot, original cluster order."""
    pivot_d = np.asarray(pivot_d, dtype=np.float64)
    n, m = pivot_d.shape
    d_sorted = np.sort(pivot_d, axis=0).T.copy()          # (m, n)
    rids = np.empty((n, m), dtype=np.int64)
    for j in range(m):
        r = ranks_with_ties_low(d_sorted[j], pivot_d[:, j])
        rids[:, j] = ring_of_rank(r, n, n_rings)
    weights = n_rings ** np.arange(m - 1, -1, -1, dtype=np.int64)
    lims = rids @ weights
    order = np.argsort(lims, kind="stable")
    return PivotMapping(
        d_sorted=d_sorted,
        rids=rids,
        lims=lims,
        order=order,
        lims_sorted=lims[order],
        n_rings=n_rings,
        dist_min=d_sorted[:, 0].copy() if n else np.zeros(m),
        dist_max=d_sorted[:, -1].copy() if n else np.zeros(m),
    )


def lims_value(rids: np.ndarray, n_rings: int) -> np.ndarray:
    """Concatenate ring IDs (last axis) into integer LIMS values."""
    rids = np.asarray(rids)
    m = rids.shape[-1]
    weights = n_rings ** np.arange(m - 1, -1, -1, dtype=np.int64)
    return rids @ weights
