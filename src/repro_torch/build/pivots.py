"""Device FFT pivot selection + pivot-distance columns for the builder.

Port of ``repro/build/pivots.py``.  ``fft_sweeps`` runs the per-cluster
farthest-first traversal for ALL clusters at once over the padded
cluster-major layout: each of the m-1 rounds is one masked argmax per
cluster plus one batched point-to-pivot distance pass, the device
analogue of the host's ``repro_torch.core.pivots.fft_pivots`` loop,
including its degenerate-cluster semantics (a re-picked pivot latches
the cluster and the remaining pivot slots repeat the last distinct
pivot).

``pivot_columns`` computes the full (K, m, n_max) pivot-distance matrix
through the port's ``pdist`` kernels.  For l1 and linf one grouped
launch compares each cluster's m pivots with its own n_max member slots
and writes (K, m, n_max) directly.  For l2 (and cosine, which has no
kernel) it keeps the reference's chunked launch: pivots of a cluster
chunk form the query rows, the chunk's member rows the point rows, and
the block diagonal of the resulting (cc·m, cc·n_max) matrix is gathered
per cluster, cc times the cells it needs.  Both give the same f32
values cell for cell.  These f32 columns feed the rank-model fits only:
the exact f64 columns exactness depends on are recomputed on the host.
"""
from __future__ import annotations

import torch

from ..core.metrics import cdist
from ..kernels import ops
from .cluster import direct_dist


def _rows_to_pivot(rows: torch.Tensor, prow: torch.Tensor,
                   metric: str) -> torch.Tensor:
    """(K, n_max) distances from every (padded) member row to its own
    cluster's pivot row: direct formulation, vectorized over clusters."""
    if metric in ("l2", "l1", "linf"):
        return direct_dist(rows - prow[:, None, :], metric)
    if metric == "cosine":
        xn = rows / torch.clamp(
            torch.linalg.norm(rows, dim=-1, keepdim=True), min=1e-12)
        rn = prow / torch.clamp(
            torch.linalg.norm(prow, dim=-1, keepdim=True), min=1e-12)
        return 1.0 - torch.einsum("knd,kd->kn", xn, rn)
    raise ValueError(f"device pivots: unsupported metric {metric!r}")


def fft_sweeps(rows: torch.Tensor, mask: torch.Tensor, gids: torch.Tensor,
               d1: torch.Tensor, cent_rows: torch.Tensor,
               cent_gids: torch.Tensor, m: int, metric: str) -> torch.Tensor:
    """(K, m) global pivot ids for every cluster, pivot #1 = centroid.

    Mirrors the host loop: ``d_near`` starts at the centroid distances
    (the exact host values, so parity of the first argmax is free), each
    round argmaxes within the cluster and min-updates, and a round that
    re-picks an existing pivot (all surviving ``d_near`` zero: duplicate
    points) latches the cluster into repeating its last pivot, exactly
    the host's ``break``-then-pad semantics.
    """
    K = rows.shape[0]
    ar = torch.arange(K, device=rows.device)
    neg = torch.tensor(-torch.inf, dtype=d1.dtype, device=d1.device)
    d_near = torch.where(mask, d1, neg)
    piv_gids = cent_gids[:, None].to(gids.dtype)               # (K, 1..m)
    piv_row = cent_rows
    latched = ~mask.any(dim=1)                                 # empty clusters
    for _ in range(1, m):
        best = torch.argmax(d_near, dim=1)
        nxt_gid = gids[ar, best]
        latched = latched | (nxt_gid[:, None] == piv_gids).any(dim=1)
        piv_row = torch.where(latched[:, None], piv_row, rows[ar, best])
        new_gid = torch.where(latched, piv_gids[:, -1], nxt_gid)
        piv_gids = torch.cat([piv_gids, new_gid[:, None]], dim=1)
        dj = _rows_to_pivot(rows, piv_row, metric)
        d_near = torch.minimum(d_near, torch.where(mask, dj, neg))
    return piv_gids


def pivot_columns(rows: torch.Tensor, pivot_rows: torch.Tensor, metric: str,
                  chunk: int = 16) -> torch.Tensor:
    """(K, m, n_max) f32 member→pivot distances through the ``pdist``
    kernels.

    l1 / linf: one grouped launch, cluster k's m pivots against its own
    n_max member slots (padded slots included).  l2 and cosine are
    chunked over clusters: one launch covers a chunk of ``cc`` =
    ``chunk`` clusters, queries the chunk's cc·m pivots, points its
    cc·n_max member slots, and the needed per-cluster block diagonal of
    the (cc·m, cc·n_max) result is then gathered, so the kernel waste
    factor is ``cc``, not K.  Cosine has no kernel: it takes the plain
    ``cdist``, as the reference does.
    """
    if metric in ops.GROUPED:
        return ops.pdist_grouped(pivot_rows, rows, metric)
    K, n_max, d = rows.shape
    m = pivot_rows.shape[1]
    outs = []
    for c0 in range(0, K, chunk):
        c1 = min(c0 + chunk, K)
        cc = c1 - c0
        q = pivot_rows[c0:c1].reshape(cc * m, d)
        p = rows[c0:c1].reshape(cc * n_max, d)
        if metric == "l2":
            dist = torch.sqrt(torch.clamp(ops.pdist(q, p, metric="sql2"),
                                          min=0.0))
        elif metric == "cosine":
            dist = cdist(q, p, metric)
        else:
            raise ValueError(f"device pivots: unsupported metric {metric!r}")
        ar = torch.arange(cc, device=dist.device)
        outs.append(dist.reshape(cc, m, cc, n_max)[ar, :, ar, :])
    return torch.cat(outs, dim=0)


__all__ = ["fft_sweeps", "pivot_columns"]
