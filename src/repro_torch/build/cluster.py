"""Batched device clustering for the LIMS builder.

Port of ``repro/build/cluster.py``.  ``device_kcenter`` mirrors the host
Gonzalez farthest-first traversal (``repro_torch.core.clustering.kcenter``)
as a Python loop of K-1 argmax + one-to-all passes on the device, with no
host synchronisation inside the loop; ``device_kmeans`` runs Lloyd
iterations with the f32 ``cdist`` + ``index_add_`` means.  Both return
the same host ``Clustering`` record the numpy path produces.

Structural parity with the host build: the sweeps use the *direct*
(diff) distance formulation, the same math as the host's
``dist_one_to_many``, summed over d in a fixed order (k = 0 upwards, the
same on the CPU and the card), and by default run in f64, so every
argmax sees values within ~1 ulp of the host's and picks the same
centers except on exact ties.  ``exact_sweeps=False`` drops to f32; the
resulting index is still exact (any partition is: the materialization
recomputes all bounds exactly), only structural bit-parity with the host
build is given up.

``dist_to_center`` is always recomputed on the host in f64 after the
sweeps: it becomes pivot column #1 of every cluster, and exactness
requires columns consistent with query-time host distances.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.clustering import Clustering
from ..core.metrics import MetricSpace, cdist
from ..kernels.dispatch import resolve_device


def direct_dist(diff: torch.Tensor, metric: str) -> torch.Tensor:
    """Reduce row differences ``diff`` (..., d) to distances (...): the
    last axis summed (l2, l1) or maxed (linf) from k = 0 upwards."""
    a = diff[..., 0] * diff[..., 0] if metric == "l2" else diff[..., 0].abs()
    for k in range(1, diff.shape[-1]):
        x = diff[..., k]
        if metric == "l2":
            a = a + x * x
        elif metric == "l1":
            a = a + x.abs()
        else:
            a = torch.maximum(a, x.abs())
    return torch.sqrt(a) if metric == "l2" else a


def one_to_all(X: torch.Tensor, row: torch.Tensor, metric: str) -> torch.Tensor:
    """(n,) distances row→X in the direct (diff) formulation: the same
    math as the host ``dist_one_to_many``, so f64 sweeps agree with the
    host to ~1 ulp (no Gram-trick cancellation)."""
    if metric in ("l2", "l1", "linf"):
        return direct_dist(X - row, metric)
    if metric == "cosine":
        xn = X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True),
                             min=1e-12)
        rn = row / torch.clamp(torch.linalg.norm(row), min=1e-12)
        return 1.0 - xn @ rn
    raise ValueError(f"device clustering: unsupported metric {metric!r}")


def _kcenter_sweeps(X: torch.Tensor, first: int, k: int, metric: str):
    """K-1 farthest-first sweeps; each step is one argmax + one
    one-vs-all distance pass (O(nd)), all on the device.  The picked
    index stays a device tensor, so the loop never waits for the card.
    Returns (centers (k,), assign (n,), d_near (n,)) on the device."""
    n = X.shape[0]
    dev = X.device
    d_near = one_to_all(X, X[first], metric)
    centers = torch.zeros(k, dtype=torch.int64, device=dev)
    centers[0] = first
    assign = torch.zeros(n, dtype=torch.int64, device=dev)
    for c in range(1, k):
        nxt = torch.argmax(d_near).view(1)        # first maximum, as np
        d_new = one_to_all(X, X.index_select(0, nxt)[0], metric)
        closer = d_new < d_near
        assign = torch.where(closer, c, assign)
        d_near = torch.where(closer, d_new, d_near)
        centers[c:c + 1] = nxt
    return centers, assign, d_near


def _exact_dist_to_center(space: MetricSpace, center_idx: np.ndarray,
                          members: list) -> np.ndarray:
    """Host-exact f64 distance to the own centroid, per object.  This is
    pivot column #1 downstream: it must be bit-consistent with the
    query-time ``dist_one_to_many``."""
    d_own = np.zeros(space.n, dtype=np.float64)
    for c, mem in enumerate(members):
        if len(mem):
            d_own[mem] = space.dist(space.data[int(center_idx[c])], mem)
    return d_own


def device_kcenter(space: MetricSpace, k: int, seed: int = 0,
                   exact_sweeps: bool = True, device=None) -> Clustering:
    """Device mirror of ``clustering.kcenter`` (same seed → same first
    center; f64 sweeps → same argmax picks up to ~1-ulp ties)."""
    dev = resolve_device(device)
    n = space.n
    k = min(k, n)
    rng = np.random.default_rng(seed)
    first = int(rng.integers(n))
    dtype = np.float64 if exact_sweeps else np.float32
    X = torch.from_numpy(space.data.astype(dtype)).to(dev)
    centers, assign, _ = _kcenter_sweeps(X, first, k, space.metric)
    centers = centers.cpu().numpy()
    assign = assign.cpu().numpy()
    space.dist_count += n * k        # the sweeps' distance passes
    members = [np.where(assign == c)[0] for c in range(k)]
    d_own = _exact_dist_to_center(space, centers, members)
    return Clustering(centers, assign, d_own, members)


def _kmeans_sweeps(X: torch.Tensor, cent: torch.Tensor, k: int, iters: int,
                   metric: str):
    m = "l2" if metric == "cosine" else metric       # host `_cd` parity
    ones = torch.ones(X.shape[0], dtype=cent.dtype, device=X.device)
    for _ in range(iters):
        assign = torch.argmin(cdist(X, cent, m), dim=1)
        sums = torch.zeros_like(cent).index_add_(0, assign, X)
        cnt = torch.zeros(k, dtype=cent.dtype,
                          device=X.device).index_add_(0, assign, ones)
        cent = torch.where(cnt[:, None] > 0,
                           sums / torch.clamp(cnt, min=1.0)[:, None], cent)
    d = cdist(X, cent, m)
    assign = torch.argmin(d, dim=1)
    # snap centers to the nearest member (empty cluster → global argmin)
    own = assign[:, None] == torch.arange(k, device=X.device)[None]
    d_member = torch.where(own, d, torch.inf)
    return torch.where(own.any(dim=0), torch.argmin(d_member, dim=0),
                       torch.argmin(d, dim=0))


def device_kmeans(space: MetricSpace, k: int, iters: int = 15,
                  seed: int = 0, device=None) -> Clustering:
    """Lloyd's kMeans on the device (vector metrics): f32 ``cdist``
    assignment + ``index_add_`` means, centers snapped to real objects at
    the end.  The final assignment is recomputed against the snapped
    centers so it is consistent with the returned ``center_idx``."""
    if not space.is_vector:
        raise ValueError("kmeans requires a vector metric")
    dev = resolve_device(device)
    n = space.n
    k = min(k, n)
    rng = np.random.default_rng(seed)
    cent0 = space.data[rng.choice(n, size=k, replace=False)]
    X = torch.from_numpy(space.data.astype(np.float32)).to(dev)
    cent = torch.from_numpy(np.asarray(cent0, np.float32)).to(dev)
    center_idx = _kmeans_sweeps(X, cent, k, iters, space.metric)
    center_idx = center_idx.cpu().numpy().astype(np.int64)
    space.dist_count += n * k * (iters + 1)
    # final assignment against the *snapped* centers, on the host in f64
    # (cluster membership must agree with the exact dist_to_center below)
    d = np.stack([space.dist(space.data[int(c)]) for c in center_idx], axis=1)
    assign = np.argmin(d, axis=1).astype(np.int64)
    members = [np.where(assign == c)[0] for c in range(k)]
    d_own = _exact_dist_to_center(space, center_idx, members)
    return Clustering(center_idx, assign, d_own, members)


def cluster_major(members: list, pad_mult: int = 128):
    """Pack per-cluster member index lists into the padded cluster-major
    layout every builder stage runs over.

    Returns ``(member_idx (K, n_max) int64, mask (K, n_max) bool,
    counts (K,) int64, n_max)``; padding slots hold index 0 and a False
    mask.  Member order inside a cluster is the host order (ascending
    global id, from ``np.where``) so device argmaxes tie-break exactly
    like the host's.  ``n_max`` rounds up to a multiple of ``pad_mult``
    so builds and retrains over drifting cluster sizes share shapes.
    """
    K = len(members)
    counts = np.asarray([len(mm) for mm in members], dtype=np.int64)
    n_max = max(int(counts.max()) if K else 1, 1)
    n_max = -(-n_max // max(pad_mult, 1)) * max(pad_mult, 1)
    member_idx = np.zeros((K, n_max), dtype=np.int64)
    mask = np.zeros((K, n_max), dtype=bool)
    for c, mm in enumerate(members):
        member_idx[c, :len(mm)] = mm
        mask[c, :len(mm)] = True
    return member_idx, mask, counts, n_max


__all__ = ["device_kcenter", "device_kmeans", "cluster_major", "one_to_all"]
