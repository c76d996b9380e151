"""The immutable device snapshot of a host ``LIMSIndex``.

Port of ``repro/core/snapshot.py``, resident only (paged spill/load and
the reduced-precision filter plane are later slices).  Everything a
query needs is laid out per cluster, padded to a common ``n_max``, as
torch tensors on one device:

  rows    (K, n_max, d)  f32   ring-ordered store rows, then §5.3 insert-
                               buffer rows, then invalid padding slots
  rids    (K, n_max, m)  i32   ring id per (row, pivot); -1 on non-ring slots
  pivots  (K, m, d)      f32   pivot payloads
  dmin/dmax (K, m)       f32   per-pivot distance extents (TriPrune)
  width   (K,)           i32   ring width ceil(n/N)
  ns      (K,)           i32   stored-row count per cluster
  valid / in_ring / always (K, n_max) bool
  coef    (K, m, C)      f32   Chebyshev rank-model tables
  model_lo/hi/n (K, m)   f32   per-group domain + train count
  rank_err (K, m)        f32   certified rank-error bound E

Host-side refinement data (``gids_np``, ``rows_np`` in f64, ``valid_np``)
rides along so the final exact refinement never round-trips through f32,
and so do host mirrors of the ring ids and rank tables (``tables_np``),
which the executor's observed-rank-error replay reads without copying
anything back from the device.

Exactness with learned models on the device: the snapshot certifies a
per-(cluster, pivot) rank-error bound E and the planner widens the
predicted ring box by it.  E is measured by running the port's own
``rankeval`` — the kernel that will serve, on the snapshot's device —
over each group's sorted column, plus a Chebyshev derivative bound
``D = Σ k²|c_k|`` times the largest gap between samples in normalized
t-space, plus slack for rint/f32 (the reference's DESIGN.md §3).
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ..kernels import ops
from ..kernels.dispatch import resolve_device
from .index import LIMSIndex

_E_SLACK = 2.0      # ranks: rint (±0.5 twice) + f32 eval slop

# device-tensor fields, in the reference's flatten order
DEVICE_FIELDS = (
    "rows", "rids", "pivots", "dmin", "dmax", "width", "ns",
    "valid", "in_ring", "always",
    "coef", "model_lo", "model_hi", "model_n", "rank_err",
)
HOST_FIELDS = ("gids_np", "rows_np", "valid_np")
SCALAR_FIELDS = ("K", "m", "n_rings", "n_max", "live")


@dataclass(frozen=True)
class LIMSSnapshot:
    """Immutable snapshot of one ``LIMSIndex`` (vector metrics, L2)."""

    # static metadata
    K: int
    m: int
    n_rings: int
    n_max: int
    live: int
    # device tensors (cluster-major; see module docstring for shapes)
    rows: torch.Tensor
    rids: torch.Tensor
    pivots: torch.Tensor
    dmin: torch.Tensor
    dmax: torch.Tensor
    width: torch.Tensor
    ns: torch.Tensor
    valid: torch.Tensor
    in_ring: torch.Tensor
    always: torch.Tensor
    coef: torch.Tensor
    model_lo: torch.Tensor
    model_hi: torch.Tensor
    model_n: torch.Tensor
    rank_err: torch.Tensor
    # host-side refinement data (f64 / int64, flat (K·n_max, …))
    gids_np: np.ndarray
    rows_np: np.ndarray
    valid_np: np.ndarray
    # host mirrors of rids / pivots / the rank tables / in_ring (see
    # host_tables)
    tables_np: SimpleNamespace

    @property
    def n_slots(self) -> int:
        """Total padded slot count P = K · n_max (the candidate axis)."""
        return self.K * self.n_max

    @property
    def d(self) -> int:
        return self.rows.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def device_nbytes(self) -> int:
        return int(sum(getattr(self, f).nbytes for f in DEVICE_FIELDS))

    def filter_rows(self) -> tuple[torch.Tensor, float]:
        """(row plane, certified margin) for first-pass distance
        filtering.  The reduced-precision plane is not ported, so this
        is always the f32 plane with margin 0.0 (callers add the margin
        unconditionally, as in the reference)."""
        return self.rows, 0.0

    @classmethod
    def build(cls, index: LIMSIndex, device=None) -> "LIMSSnapshot":
        """Lay ``index`` out on ``device`` (default ``cuda``; raises if
        there is no card) and certify E with the port's ``rankeval`` on
        that device."""
        if index.space.metric != "l2":
            raise ValueError("the device path serves the L2 metric only")
        dev = resolve_device(device)
        K, m = index.K, index.m
        d = index.space.data.shape[1]
        dead = index.tombstones

        n_slots = [ci.n + len(ci.buf_ids) for ci in index.clusters]
        n_max = max(max(n_slots), 1)
        rows = np.zeros((K, n_max, d), np.float32)
        rows64 = np.zeros((K, n_max, d), np.float64)
        rids = np.full((K, n_max, m), -1, np.int32)
        pivots = np.zeros((K, m, d), np.float32)
        dmin = np.zeros((K, m), np.float32)
        dmax = np.zeros((K, m), np.float32)
        width = np.ones((K,), np.int32)
        gids = np.full((K, n_max), -1, np.int64)
        valid = np.zeros((K, n_max), bool)
        in_ring = np.zeros((K, n_max), bool)
        for ci in index.clusters:
            k, n, nb = ci.cid, ci.n, len(ci.buf_ids)
            pivots[k] = ci.pivot_rows
            if n:
                rows[k, :n] = ci.store.rows
                rows64[k, :n] = ci.store.rows
                rids[k, :n] = ci.mapping.rids[ci.mapping.order]
                dmin[k] = ci.mapping.dist_min
                dmax[k] = ci.mapping.dist_max
                width[k] = max(1, -(-n // index.n_rings))
                gids[k, :n] = ci.store_ids
                in_ring[k, :n] = True
                valid[k, :n] = ci.live_mask
            if nb:
                buf = np.stack(ci.buf_rows)
                rows[k, n:n + nb] = buf
                rows64[k, n:n + nb] = buf
                gids[k, n:n + nb] = ci.buf_ids
                valid[k, n:n + nb] = [g not in dead for g in ci.buf_ids]
        coef, lo, hi, n_model, err = _certified_rank_table(index, dev)
        coef = coef.reshape(K, m, -1)
        lo, hi, n_model = (a.reshape(K, m) for a in (lo, hi, n_model))
        err = err.reshape(K, m).astype(np.float32)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return cls(
            K=K, m=m, n_rings=index.n_rings, n_max=n_max,
            live=int(valid.sum()),
            rows=put(rows), rids=put(rids), pivots=put(pivots),
            dmin=put(dmin), dmax=put(dmax), width=put(width),
            ns=put(np.array([ci.n for ci in index.clusters], np.int32)),
            valid=put(valid), in_ring=put(in_ring),
            always=put(valid & ~in_ring),
            coef=put(coef), model_lo=put(lo), model_hi=put(hi),
            model_n=put(n_model), rank_err=put(err),
            gids_np=gids.reshape(-1),
            rows_np=rows64.reshape(K * n_max, d),
            valid_np=valid.reshape(-1),
            tables_np=host_tables(rids, pivots, coef, lo, hi, n_model, err,
                                  in_ring),
        )


def host_tables(rids, pivots, coef, lo, hi, n, err,
                in_ring) -> SimpleNamespace:
    """Host mirrors of the fields the executor's rank-health replay
    reads (``QueryExecutor._health_arrays``): ``rids`` (K, n_max, m),
    f32 ``pivots`` (K, m, d), ``coef`` (K, m, C), ``lo``/``hi``/``n``/
    ``err`` (K, m), and ``in_ring`` flat (K·n_max,).  The reference
    copies them back from the device once per executor; the port keeps
    the host arrays the build already holds."""
    def f32(a):
        return np.asarray(a, np.float32)

    return SimpleNamespace(
        rids=np.asarray(rids, np.int32), pivots=f32(pivots), coef=f32(coef),
        lo=f32(lo), hi=f32(hi), n=f32(n), err=f32(err),
        in_ring=np.asarray(in_ring, bool).reshape(-1))


def rank_columns(index: LIMSIndex) -> np.ndarray:
    """(G, n_col) f32 sorted pivot-distance column of every (cluster,
    pivot) group, padded past a group's n with its last value: the
    points at which E certifies ``rankeval``."""
    m = index.m
    n_col = max(int(ci.n) for ci in index.clusters)
    xcols = np.zeros((index.K * m, n_col), np.float32)
    for gi, (ci, j) in enumerate(
            (ci, j) for ci in index.clusters for j in range(m)):
        n = ci.n
        col = ci.mapping.d_sorted[j]
        xcols[gi, :n] = col
        if n:
            xcols[gi, n:] = col[-1]       # pad with hi (ignored)
    return xcols


def _certified_rank_table(index: LIMSIndex, device: torch.device):
    """(G, C) Chebyshev table for one-launch ``rankeval`` + the certified
    per-group rank-error bound E, measured with the port's ``rankeval``
    on ``device`` (the kernel that serves there)."""
    m = index.m
    G = index.K * m
    models = [ci.rank_models[j] for ci in index.clusters for j in range(m)]
    C = max(len(mo.coef) for mo in models)
    coef = np.zeros((G, C), np.float32)
    lo = np.zeros(G, np.float32)
    hi = np.ones(G, np.float32)
    n_model = np.zeros(G, np.float32)
    for g, mo in enumerate(models):
        coef[g, :len(mo.coef)] = mo.coef
        lo[g], hi[g], n_model[g] = mo.lo, mo.hi, mo.n

    # certify E: kernel error at the data points + derivative bound for
    # the gaps between them
    err = np.zeros(G)
    if max(int(ci.n) for ci in index.clusters) > 0:
        def put(a):
            return torch.from_numpy(a).to(device)

        pred = ops.rankeval(put(rank_columns(index)), put(coef), put(lo),
                            put(hi), put(n_model),
                            n_rings=index.n_rings)[0]
        pred = pred.cpu().numpy()
        for gi, mo in enumerate(models):
            n = mo.n
            if n == 0:
                continue
            err_pt = np.abs(pred[gi, :n] -
                            np.arange(n, dtype=np.float64)).max()
            deriv = float(np.sum(
                np.arange(len(mo.coef)) ** 2 * np.abs(mo.coef)))
            span = mo.hi - mo.lo
            col = index.clusters[gi // m].mapping.d_sorted[gi % m]
            gap = float(np.diff(col).max()) * 2.0 / span \
                if (n > 1 and span > 0) else 0.0
            # ranks live in [0, n-1] and predictions are clipped to the
            # same interval, so n always bounds the error
            err[gi] = min(err_pt + deriv * gap + _E_SLACK, float(n))
    return coef, lo, hi, n_model, err


__all__ = ["LIMSSnapshot", "DEVICE_FIELDS", "HOST_FIELDS", "SCALAR_FIELDS",
           "host_tables", "rank_columns"]
