"""Pivot selection: farthest-first traversal (FFT) within a cluster.

Per the paper (§4.3) pivot #1 is the cluster centroid (its distances double
as the k-center assignment distances and feed the OR statistic), and the
remaining m-1 pivots are chosen by FFT inside the cluster — linear time and
space, maximizing spread so the ring intersections are tight.

Copied from ``repro/core/pivots.py``: results must match it bitwise.
"""
from __future__ import annotations

import numpy as np

from .metrics import MetricSpace


def fft_pivots(space: MetricSpace, member_idx: np.ndarray, centroid_idx: int,
               m: int, d_to_centroid: np.ndarray | None = None) -> np.ndarray:
    """Return (m,) global indices of pivots for one cluster.

    ``d_to_centroid`` (len == len(member_idx)) is reused from clustering if
    available to save one distance pass.
    """
    pivots = [int(centroid_idx)]
    if m == 1 or len(member_idx) == 0:
        return np.asarray(pivots[:m], dtype=np.int64)
    if d_to_centroid is None:
        d_near = space.dist(space.data[centroid_idx], member_idx)
    else:
        d_near = np.array(d_to_centroid, dtype=np.float64, copy=True)
    for _ in range(1, m):
        nxt_local = int(np.argmax(d_near))
        nxt = int(member_idx[nxt_local])
        if nxt in pivots:            # degenerate tiny cluster: reuse allowed
            break
        pivots.append(nxt)
        d_new = space.dist(space.data[nxt], member_idx)
        d_near = np.minimum(d_near, d_new)
    while len(pivots) < m:           # pad degenerate clusters
        pivots.append(pivots[-1])
    return np.asarray(pivots, dtype=np.int64)
