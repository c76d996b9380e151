"""Distance metrics for generic metric spaces.

Port of ``repro/core/metrics.py``.  Two execution paths:
  * vector metrics (L2 / squared-L2 / L1 / Linf / cosine) — batched torch
    f32 on whatever device the operands live on (the hand-written
    kernels in ``repro_torch.kernels`` implement the query path's Gram
    math);
  * generic metrics (edit distance over fixed-length strings) — vectorized
    numpy dynamic programming, host-side. LIMS only ever needs
    one-against-many distances, which is what these provide.

Every function returns *true* metric distances (so the triangle inequality
holds); squared L2 is exposed separately for callers that want to avoid the
sqrt (the Gram-trick kernel) and take responsibility for re-squaring radii.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

VECTOR_METRICS = ("l2", "l1", "linf", "cosine")
GENERIC_METRICS = ("edit",)


# ---------------------------------------------------------------------------
# torch batched many-vs-many distances
# ---------------------------------------------------------------------------
def cdist(x: torch.Tensor, y: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Pairwise distances between rows of ``x`` (nq, d) and ``y`` (np, d)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if metric == "l2":
        # Gram trick, as the reference; clamp for fp error
        xn = torch.sum(x * x, dim=-1, keepdim=True)
        yn = torch.sum(y * y, dim=-1, keepdim=True)
        sq = xn + yn.T - 2.0 * (x @ y.T)
        return torch.sqrt(torch.clamp(sq, min=0.0))
    if metric == "l1":
        return torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    if metric == "linf":
        return torch.amax(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    if metric == "cosine":
        # angular distance = 1 - cos; NOT a metric in general, kept for
        # retrieval use only (LIMS proper requires a true metric).
        xn = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
        yn = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=1e-12)
        return 1.0 - xn @ yn.T
    raise ValueError(f"unknown vector metric: {metric}")


def dist_one_to_many(q: np.ndarray, pts: np.ndarray, metric: str) -> np.ndarray:
    """Host-side one-vs-many distance in float64 with the *direct* (diff)
    formulation: bit-exact zeros for identical objects (point queries) and
    bounds that are consistent between build and query time. The Gram-trick
    f32 path is reserved for the many-vs-many TPU kernels where its MXU
    mapping pays off."""
    if metric == "edit":
        return edit_distance_one_to_many(np.asarray(q), np.asarray(pts))
    q = np.asarray(q, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    if metric == "l2":
        diff = pts - q
        return np.sqrt(np.einsum("nd,nd->n", diff, diff))
    if metric == "l1":
        return np.abs(pts - q).sum(axis=1)
    if metric == "linf":
        return np.abs(pts - q).max(axis=1)
    if metric == "cosine":
        qn = q / max(np.linalg.norm(q), 1e-12)
        pn = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-12)
        return 1.0 - pn @ qn
    raise ValueError(f"unknown metric: {metric}")


# ---------------------------------------------------------------------------
# Edit (Levenshtein) distance, vectorized across candidates.
# Strings are encoded as fixed-length int arrays (the paper's Signature
# dataset uses 65-letter strings).
# ---------------------------------------------------------------------------
def edit_distance_one_to_many(q: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Levenshtein distance from ``q`` (la,) to each row of ``pts`` (n, lb).

    Classic DP with the row dimension vectorized over all candidates; the
    inner scan over the candidate-string position is sequential because of
    the dp[j-1] dependency, so the loop nest is la * lb numpy steps on
    n-vectors.
    """
    q = np.asarray(q)
    pts = np.atleast_2d(np.asarray(pts))
    n, lb = pts.shape
    la = q.shape[0]
    # dp[j] = edit distance between q[:i] and pts[:, :j]
    dp = np.broadcast_to(np.arange(lb + 1, dtype=np.int32), (n, lb + 1)).copy()
    for i in range(1, la + 1):
        prev_diag = dp[:, 0].copy()          # dp[i-1][j-1]
        dp[:, 0] = i
        for j in range(1, lb + 1):
            cur = dp[:, j].copy()            # dp[i-1][j]
            sub = prev_diag + (pts[:, j - 1] != q[i - 1])
            dp[:, j] = np.minimum(np.minimum(cur + 1, dp[:, j - 1] + 1), sub)
            prev_diag = cur
    return dp[:, lb].astype(np.float64)


def edit_distance(a: np.ndarray, b: np.ndarray) -> float:
    return float(edit_distance_one_to_many(a, b[None, :])[0])


# ---------------------------------------------------------------------------
# MetricSpace: the object LIMS is built over.
# ---------------------------------------------------------------------------
class MetricSpace:
    """A dataset living in a metric space.

    ``data`` is an (n, d) float array for vector metrics, or an (n, L) int
    array of encoded strings for the edit metric. The API is purely
    one-vs-many / subset distance evaluation + a distance-computation
    counter (the paper's ``D`` cost term).
    """

    def __init__(self, data: np.ndarray, metric: str = "l2",
                 dist_fn: Callable | None = None):
        self.data = np.asarray(data)
        self.metric = metric
        self._custom = dist_fn
        self.n = self.data.shape[0]
        self.dist_count = 0
        if metric not in VECTOR_METRICS + GENERIC_METRICS and dist_fn is None:
            raise ValueError(f"metric {metric!r} needs an explicit dist_fn")

    @property
    def is_vector(self) -> bool:
        return self.metric in VECTOR_METRICS

    def reset_counter(self) -> None:
        self.dist_count = 0

    def dist(self, q: np.ndarray, idx: np.ndarray | None = None) -> np.ndarray:
        """Distances from query object ``q`` to data[idx] (or all)."""
        pts = self.data if idx is None else self.data[idx]
        self.dist_count += len(pts)
        if self._custom is not None:
            return np.asarray([self._custom(q, p) for p in pts])
        return dist_one_to_many(q, pts, self.metric)

    def dist_points(self, i: int, idx: np.ndarray | None = None) -> np.ndarray:
        return self.dist(self.data[i], idx)

    def pair(self, a: np.ndarray, b: np.ndarray) -> float:
        self.dist_count += 1
        if self._custom is not None:
            return float(self._custom(a, b))
        return float(dist_one_to_many(a, b[None, :], self.metric)[0])

    def record_nbytes(self) -> int:
        return int(self.data[0].nbytes)
