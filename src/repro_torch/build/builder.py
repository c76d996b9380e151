"""Builder orchestration + the exact host materialization.

Port of ``repro/build/builder.py``.  ``device_build`` runs the full §4
build pipeline with the heavy stages on the device (batched clustering
sweeps, FFT pivot argmax sweeps, pivot-distance columns through the
``pdist`` kernels, and every rank/position model fit in one batched
least-squares pass) and returns a ``DeviceBuildResult``: the structural
choices (clustering, pivot ids), the device-fit models, and per-stage
timings.

``LIMSIndex(backend="device")`` consumes the result and materializes
its host structures from it, recomputing exactly (f64, host
``dist_one_to_many``) everything exactness depends on: pivot-distance
columns, ring boundaries, TriPrune extents.  Device-fit models ride
along as-is: they are accelerators the host corrects with exponential
search, and snapshots re-certify their error bound E against the exact
columns.

``retrain_device`` is the single-cluster variant that
``LIMSIndex.retrain_cluster(backend="device")`` routes through.

Every entry point takes ``device`` (default ``cuda``, raising without a
card; ``"cpu"`` runs the kernels' plain versions).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.clustering import Clustering
from ..core.metrics import MetricSpace
from ..core.rankmodel import PolyRankModel
from ..kernels.dispatch import resolve_device
from .cluster import cluster_major, device_kcenter, device_kmeans
from .fit import batched_chebfit
from .pivots import fft_sweeps, pivot_columns

_PAD_LIMS = float(2 ** 30)     # sorts after every real LIMS value


@dataclass
class DeviceBuildResult:
    """Everything the host materialization needs from the device pass."""
    clustering: Clustering
    pivot_gids: np.ndarray                  # (K, m) global pivot object ids
    rank_models: list                       # K lists of m PolyRankModels
    pos_models: list                        # K PolyRankModels
    device_rank_err: np.ndarray             # (K, m) device-certified E est.
    timings: dict                           # per-stage seconds

    @property
    def K(self) -> int:
        return self.clustering.k


def _check_vector(space: MetricSpace, what: str) -> None:
    if space._custom is not None or not space.is_vector:
        raise ValueError(f"device {what} backend requires a built-in vector "
                         f"metric (got {space.metric!r})")


# ------------------------------------------------------------------ fitting
def _ranks_to_lims(cols_raw, mask, counts, n_rings: int):
    """Device ring assignment from the (K, m, n_max) raw column matrix:
    ties-low ranks per (cluster, pivot), equal-count ring ids, LIMS
    values, and the per-cluster sorted LIMS column for position fits."""
    K, m, n_max = cols_raw.shape
    dev = cols_raw.device
    masked = torch.where(mask[:, None, :], cols_raw, torch.inf)
    cols_sorted, order = torch.sort(masked, dim=-1, stable=True)
    idx = torch.arange(n_max, device=dev)
    prev = torch.cat(
        [torch.full((K, m, 1), -torch.inf, dtype=cols_sorted.dtype,
                    device=dev), cols_sorted[:, :, :-1]], dim=-1)
    r_sorted = torch.cummax(
        torch.where(cols_sorted != prev, idx, 0), dim=2).values
    # back to member order: the inverse permutation of the sort
    rank_member = torch.empty_like(r_sorted).scatter_(2, order, r_sorted)
    width = torch.clamp(-(-counts // n_rings), min=1)[:, None, None]
    rid = torch.clamp(rank_member // width, 0, n_rings - 1)
    weights = torch.tensor([n_rings ** (m - 1 - j) for j in range(m)],
                           dtype=torch.int64, device=dev)
    lims = torch.sum(rid * weights[None, :, None], dim=1)     # (K, n_max)
    lims_col = torch.sort(torch.where(mask, lims.to(torch.float32),
                                      _PAD_LIMS), dim=-1).values
    return cols_sorted, lims_col


def _fit_all_models(cols_raw, mask, counts, n_rings: int, deg_rank: int,
                    pos_degree: int):
    """ONE batched least-squares pass for the K·m rank models and the
    K position models; returns host ``PolyRankModel`` records plus the
    device-side certified error estimate per rank group.  ``counts`` is
    a (K,) int64 array."""
    K, m, n_max = cols_raw.shape
    dev = cols_raw.device
    counts_t = torch.from_numpy(np.asarray(counts, np.int64)).to(dev)
    cols_sorted, lims_col = _ranks_to_lims(cols_raw, mask, counts_t, n_rings)
    cols_all = torch.cat([cols_sorted.reshape(K * m, n_max), lims_col])
    del cols_sorted, lims_col
    counts_all = torch.cat([torch.repeat_interleave(counts_t, m), counts_t])
    deg_req = torch.cat(
        [torch.full((K * m,), deg_rank, dtype=torch.int32, device=dev),
         torch.full((K,), pos_degree, dtype=torch.int32, device=dev)])
    coef, lo, hi, _, dg, err = batched_chebfit(
        cols_all, counts_all, deg_req, max(deg_rank, pos_degree))
    coef = coef.cpu().numpy().astype(np.float64)
    lo = lo.cpu().numpy().astype(np.float64)
    hi = hi.cpu().numpy().astype(np.float64)
    dg = dg.cpu().numpy().astype(np.int64)
    counts_all = counts_all.cpu().numpy()

    def wrap(g: int) -> PolyRankModel:
        n_g = int(counts_all[g])
        if n_g == 0:
            return PolyRankModel(np.zeros(1), 0.0, 1.0, 0)
        c = coef[g, :int(dg[g]) + 1].copy()
        if not c.any():                      # constant / degenerate column
            c = np.zeros(1)
        return PolyRankModel(c, float(lo[g]), float(hi[g]), n_g)

    rank_models = [[wrap(k * m + j) for j in range(m)] for k in range(K)]
    pos_models = [wrap(K * m + k) for k in range(K)]
    dev_err = err.cpu().numpy().astype(np.float64)[:K * m].reshape(K, m)
    return rank_models, pos_models, dev_err


# ------------------------------------------------------------- full build
def device_build(space: MetricSpace, n_clusters: int, m: int = 3,
                 n_rings: int = 20, degree: int = 8, pos_degree: int = 8,
                 seed: int = 0, clusterer: str = "kcenter",
                 learned: bool = True, exact_sweeps: bool = True,
                 device=None) -> DeviceBuildResult:
    """Run the device build pipeline and return its structural output.

    ``exact_sweeps`` runs the clustering / pivot argmax sweeps in f64
    for structural bit-parity with the host build; f32 sweeps only risk
    picking different (equally valid) centers/pivots.  Each stage ends
    by copying its result to the host, so the stage times in
    ``timings`` include the device's work.
    """
    _check_vector(space, "build")
    dev = resolve_device(device)
    timings: dict = {}
    t0 = time.perf_counter()
    if clusterer == "kcenter":
        clustering = device_kcenter(space, n_clusters, seed=seed,
                                    exact_sweeps=exact_sweeps, device=dev)
    elif clusterer == "kmeans":
        clustering = device_kmeans(space, n_clusters, seed=seed, device=dev)
    else:
        raise ValueError(clusterer)
    timings["cluster_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    member_idx, mask, counts, _ = cluster_major(clustering.members)
    dtype = np.float64 if exact_sweeps else np.float32
    X = torch.from_numpy(space.data.astype(dtype)).to(dev)
    mi = torch.from_numpy(member_idx).to(dev)
    mask_dev = torch.from_numpy(mask).to(dev)
    rows = X[mi]                                            # (K, n_max, d)
    d1 = torch.from_numpy(clustering.dist_to_center.astype(dtype)).to(dev)
    d1 = torch.where(mask_dev, d1[mi], 0.0)
    cent_gids = torch.from_numpy(clustering.center_idx).to(dev)
    piv_gids = fft_sweeps(rows, mask_dev, torch.where(mask_dev, mi, -1), d1,
                          X[cent_gids], cent_gids, m, space.metric)
    piv_gids = piv_gids.cpu().numpy().astype(np.int64)
    space.dist_count += int(counts.sum()) * (m - 1)
    # (empty clusters need no patching: fft_sweeps latches them onto the
    # centroid gid from round one, the host's centroid-only semantics)
    timings["pivot_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows_f32 = rows.to(torch.float32)
    del rows, d1
    pivot_rows = X[torch.from_numpy(piv_gids).to(dev)].to(torch.float32)
    cols_raw = pivot_columns(rows_f32, pivot_rows, space.metric)
    del rows_f32, X
    deg_rank = degree if learned else 1
    rank_models, pos_models, dev_err = _fit_all_models(
        cols_raw, mask_dev, counts, n_rings, deg_rank, pos_degree)
    timings["fit_s"] = time.perf_counter() - t0
    timings["device_s"] = sum(timings.values())
    return DeviceBuildResult(
        clustering=clustering, pivot_gids=piv_gids,
        rank_models=rank_models, pos_models=pos_models,
        device_rank_err=dev_err, timings=timings)


# ------------------------------------------------------ index / snapshot API
def build_index(space: MetricSpace, n_clusters: int | None = None, **kw):
    """Build a host ``LIMSIndex`` through the device builder
    (``LIMSIndex(backend="device")`` convenience wrapper)."""
    from ..core.index import LIMSIndex
    return LIMSIndex(space, n_clusters=n_clusters, backend="device", **kw)


def build_snapshot(space: MetricSpace, n_clusters: int | None = None, *,
                   spill_path: str | None = None,
                   page_bytes: int | None = None,
                   store: bool = False, device=None, **kw):
    """Device-build an index and emit its serving ``LIMSSnapshot`` on the
    same device.

    Returns ``(snapshot, index)``: the snapshot serves through
    ``QueryExecutor``; the index remains the §5.3 update target, exactly
    as with a host build.

    ``spill_path`` additionally emits the paged disk layout as part of
    the build (the reference's DESIGN.md §7): rows land in
    learned-position page extents the moment they exist, so a freshly
    built corpus is cold-start servable without a second pass.
    ``store=True`` returns the store-backed snapshot view instead of the
    resident one.
    """
    from ..core.snapshot import LIMSSnapshot
    index = build_index(space, n_clusters=n_clusters, device=device, **kw)
    snap = LIMSSnapshot.build(index, device=device)
    if spill_path is not None:
        from ..storage import DEFAULT_PAGE_BYTES, PagedStore
        snap.spill(spill_path,
                   page_bytes=page_bytes or DEFAULT_PAGE_BYTES)
        if store:
            snap = snap.with_store(PagedStore(spill_path))
    elif store:
        raise ValueError("store=True requires spill_path")
    return snap, index


# ------------------------------------------------------------------ retrain
def retrain_device(sub: MetricSpace, cent_row: np.ndarray, m: int,
                   n_rings: int, degree: int, pos_degree: int,
                   exact_sweeps: bool = True, device=None):
    """Single-cluster device rebuild for ``retrain_cluster`` (§5.3).

    Pivot selection + every model fit run on the device (one cluster is
    one row of the padded layout); the pivot-distance matrix handed back
    is recomputed exactly on the host, so the caller's mapping/extents
    are bit-exact.  Returns ``(piv_rows (m, d) f64, pivot_d (n, m) f64,
    rank_models, pos_model)``.
    """
    _check_vector(sub, "retrain")
    dev = resolve_device(device)
    n = sub.n
    mem = np.arange(n)
    d1 = sub.dist(cent_row, mem)                     # exact f64
    # pad to a multiple of 128, as cluster_major does
    n_pad = -(-n // 128) * 128
    dim = sub.data.shape[1]
    dtype = np.float64 if exact_sweeps else np.float32
    rows_np = np.zeros((1, n_pad, dim), dtype)
    rows_np[0, :n] = sub.data
    mask_np = np.zeros((1, n_pad), bool)
    mask_np[0, :n] = True
    d1_np = np.zeros((1, n_pad), dtype)
    d1_np[0, :n] = d1
    rows = torch.from_numpy(rows_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    gids = torch.where(mask, torch.arange(n_pad, device=dev)[None], -1)
    piv_gids = fft_sweeps(
        rows, mask, gids, torch.from_numpy(d1_np).to(dev),
        torch.from_numpy(np.asarray(cent_row, dtype)[None]).to(dev),
        torch.tensor([-1], device=dev),              # centroid ∉ members
        m, sub.metric).cpu().numpy()[0]
    sub.dist_count += n * (m - 1)

    piv_rows = np.empty((m, dim), np.float64)
    pivot_d = np.empty((n, m), np.float64)
    piv_rows[0] = cent_row
    pivot_d[:, 0] = d1
    for j in range(1, m):
        g = int(piv_gids[j])
        if g < 0:                                    # latched onto centroid
            piv_rows[j] = cent_row
            pivot_d[:, j] = d1
        else:
            piv_rows[j] = sub.data[g]
            pivot_d[:, j] = sub.dist(sub.data[g], mem)

    prow_f32 = torch.from_numpy(piv_rows[None].astype(np.float32)).to(dev)
    cols_raw = pivot_columns(rows.to(torch.float32), prow_f32, sub.metric)
    rank_models, pos_models, _ = _fit_all_models(
        cols_raw, mask, np.asarray([n]), n_rings, degree, pos_degree)
    return piv_rows, pivot_d, rank_models[0], pos_models[0]


__all__ = ["DeviceBuildResult", "device_build", "build_index",
           "build_snapshot", "retrain_device"]
