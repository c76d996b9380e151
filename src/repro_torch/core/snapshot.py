"""The immutable device snapshot of a host ``LIMSIndex``.

Port of ``repro/core/snapshot.py``.  Everything a query needs is laid
out per cluster, padded to a common ``n_max``, as torch tensors on one
device:

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

Reduced-precision filter plane (the reference's DESIGN.md §13): with
``REPRO_ROWS_DTYPE=bf16|f16`` the snapshot also keeps ``rows_lp``, a
bf16/f16 copy of ``rows`` that only first-pass distance filtering reads
(``pdist`` and ``range_filter`` take its 2-byte points natively), and
its certified margin ``lp_eps`` = max over rows of ‖x_f32 − x_lp‖,
computed exactly in f64.  By the triangle inequality every distance on
the plane is within ``lp_eps`` of the true one, so a filter radius
widened by it admits every true result, and the exact f64 refinement
keeps results bit-identical.  Off (the default), ``rows_lp`` is None,
``lp_eps`` 0.0, and every threshold is the f32 plane's.  The paged tier
drops the plane (its rows are on disk).

Paged storage tier (the reference's DESIGN.md §7): :meth:`spill` writes
the rows into a paged store directory in the reference's format and
:meth:`load` reads one back, resident or store-backed.  A store-backed
snapshot (``store`` set) keeps every query table on the device but no
row payload: ``rows`` is (K, 0, d) and ``rows_np`` (0, d), and the
executor gathers candidate rows page by page through ``store``, a view
frozen on the snapshot's own store generation.

Exactness with learned models on the device: the snapshot certifies a
per-(cluster, pivot) rank-error bound E and the planner widens the
predicted ring box by it.  E is measured by running the port's own
``rankeval`` — the kernel that will serve, on the snapshot's device —
over each group's sorted column, plus a Chebyshev derivative bound
``D = Σ k²|c_k|`` times the largest gap between samples in normalized
t-space, plus slack for rint/f32 (the reference's DESIGN.md §3).
"""
from __future__ import annotations

import shutil
import tempfile
import weakref
from dataclasses import dataclass, replace
from types import SimpleNamespace

import numpy as np
import torch

from ..kernels import ops
from ..kernels.dispatch import resolve_device, rows_dtype
from ..storage import (DEFAULT_CACHE_PAGES, DEFAULT_PAGE_BYTES, PagedStore,
                       StoreView, load_meta, spill_rows, storage_mode)
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
# everything spilled to the store's metadata file (rows go to pages.bin)
_SPILL_FIELDS = tuple(f for f in DEVICE_FIELDS if f != "rows")
# the reduced-precision plane's point types (REPRO_ROWS_DTYPE)
LP_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}


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
    # paged storage tier: when set, row payloads live on disk — ``rows``
    # and ``rows_np`` are empty and the executor fetches candidate pages
    # through this view of the shared reader, bound to THIS snapshot's
    # generation layout, so a later writeback can never remap an
    # in-flight batch's slots
    store: StoreView | None = None
    # reduced-precision filter plane: a bf16/f16 copy of ``rows`` and
    # its certified quantization margin; None / 0.0 when off
    rows_lp: torch.Tensor | None = None
    lp_eps: float = 0.0

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
        """Bytes of every device tensor, the filter plane's included."""
        lp = 0 if self.rows_lp is None else self.rows_lp.nbytes
        return int(sum(getattr(self, f).nbytes for f in DEVICE_FIELDS)) + lp

    def filter_rows(self) -> tuple[torch.Tensor, float]:
        """(row plane, certified margin) for first-pass distance
        filtering: the reduced-precision plane with its margin when
        there is one, else the f32 plane with margin 0.0 (callers add
        the margin unconditionally; + 0.0 changes no f32 value)."""
        if self.rows_lp is not None:
            return self.rows_lp, self.lp_eps
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

        rows_dev = put(rows)
        rows_lp, lp_eps = _lp_plane(rows_dev)
        return cls(
            K=K, m=m, n_rings=index.n_rings, n_max=n_max,
            live=int(valid.sum()), rows_lp=rows_lp, lp_eps=lp_eps,
            rows=rows_dev, rids=put(rids), pivots=put(pivots),
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

    # ------------------------------------------------------ paged storage
    def spill(self, path: str, page_bytes: int = DEFAULT_PAGE_BYTES):
        """Spill to a paged store directory: rows land in cluster-major
        page extents (mapped-value order), every other array in the
        generation's metadata file, published by one atomic manifest
        swap — the reference's format, byte for byte.  Incremental over
        an existing store: clusters with unchanged row bytes keep their
        extents.  Returns the new manifest; ``self`` is untouched."""
        K, n_max, d = self.K, self.n_max, self.d
        if self.rows_np.shape != (K * n_max, d):
            raise ValueError("spill needs a resident snapshot "
                             "(store-backed rows are on disk)")
        meta = {f: getattr(self, f).cpu().numpy() for f in _SPILL_FIELDS}
        meta.update(
            gids_np=self.gids_np, valid_np=self.valid_np,
            scalars=np.asarray(
                [self.K, self.m, self.n_rings, self.n_max, self.live],
                np.int64))
        return spill_rows(path, self.rows_np.reshape(K, n_max, d),
                          page_bytes=page_bytes, meta_arrays=meta)

    def with_store(self, store: "PagedStore | StoreView") -> "LIMSSnapshot":
        """Store-backed view of this snapshot: row payloads dropped (the
        executor fetches them from ``store`` page-wise), every query
        table kept on the device.  A raw ``PagedStore`` is bound through
        a ``StoreView`` freezing its *current* generation's layout — call
        this right after :meth:`spill` so snapshot and layout match.
        Pure — returns a new snapshot."""
        if isinstance(store, PagedStore):
            store = store.view()
        return replace(
            self, rows=torch.zeros((self.K, 0, self.d), dtype=torch.float32,
                                   device=self.device),
            rows_np=np.zeros((0, self.d), np.float64), store=store,
            rows_lp=None, lp_eps=0.0)

    @classmethod
    def load(cls, path: str, store: "bool | PagedStore | None" = None,
             cache_pages: int | None = DEFAULT_CACHE_PAGES,
             device=None) -> "LIMSSnapshot":
        """Load a spilled snapshot (the port's or the reference's) onto
        ``device`` (default ``cuda``; raises if there is no card).

        ``store=None/False``: resident — rows read back from the page
        file; bit-identical round trip with :meth:`spill`.
        ``store=True``: cold start — metadata loads, rows stay on disk
        behind a fresh ``PagedStore`` with ``cache_pages`` capacity.
        ``store=<PagedStore>``: serve through an existing reader (keeps
        its warm page cache; refreshed to the latest manifest).
        """
        dev = resolve_device(device)
        meta, man = load_meta(path)
        K, m, n_rings, n_max, live = (int(v) for v in meta["scalars"])
        d = man.d

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        kw = {f: put(meta[f]) for f in _SPILL_FIELDS}
        if isinstance(store, StoreView):
            store = store.base
        # the view's (layout, pages file) pair comes from the SAME
        # manifest read as the metadata above — a writeback (or
        # compaction) landing between the two reads would otherwise pair
        # generation-G arrays with G+1 extents
        if isinstance(store, PagedStore):
            ps = store.refresh().view(man.layout(), man.pages_file)
        elif store:
            ps = PagedStore(path, cache_pages=cache_pages).view(
                man.layout(), man.pages_file)
        else:
            ps = None
        if ps is not None:
            rows = torch.zeros((K, 0, d), dtype=torch.float32, device=dev)
            rows_np = np.zeros((0, d), np.float64)
            rows_lp, lp_eps = None, 0.0
        else:
            reader = PagedStore(path, cache_pages=0)
            rows64 = np.stack([reader.read_cluster(k) for k in range(K)])
            rows = put(rows64.astype(np.float32))
            rows_np = rows64.reshape(K * n_max, d)
            rows_lp, lp_eps = _lp_plane(rows)
        return cls(K=K, m=m, n_rings=n_rings, n_max=n_max, live=live,
                   rows=rows, rows_np=rows_np,
                   rows_lp=rows_lp, lp_eps=lp_eps,
                   gids_np=np.asarray(meta["gids_np"], np.int64),
                   valid_np=np.asarray(meta["valid_np"], bool),
                   tables_np=host_tables(*(meta[f] for f in (
                       "rids", "pivots", "coef", "model_lo", "model_hi",
                       "model_n", "rank_err", "in_ring"))),
                   store=ps, **kw)


def maybe_paged(snap: LIMSSnapshot, path: str | None = None,
                page_bytes: int = DEFAULT_PAGE_BYTES,
                cache_pages: int | None = DEFAULT_CACHE_PAGES
                ) -> LIMSSnapshot:
    """Apply the process-wide ``REPRO_STORAGE`` policy to a fresh
    snapshot: under ``paged``, spill it (to ``path``, or a self-cleaning
    temp directory) and return the store-backed view; otherwise return
    ``snap`` unchanged."""
    if storage_mode() != "paged" or snap.store is not None:
        return snap
    cleanup = path is None
    if path is None:
        path = tempfile.mkdtemp(prefix="lims-paged-")
    snap.spill(path, page_bytes=page_bytes)
    store = PagedStore(path, cache_pages=cache_pages)
    if cleanup:
        weakref.finalize(store, shutil.rmtree, path, ignore_errors=True)
    return snap.with_store(store)


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


def lp_quant_eps(rows: torch.Tensor, lp: torch.Tensor,
                 metric: str = "l2") -> float:
    """Certified quantization margin of a reduced-precision row plane:
    ``max_x ‖x − x̃‖`` over rows, computed exactly in f64 on the host
    (the tensors may lie on any device).  By the triangle inequality
    ``|d(q, x̃) − d(q, x)| ≤ ‖x − x̃‖`` for every query under a
    norm-induced metric, so a filter radius widened by this margin
    keeps every true result.  An f16 value past 65,504 rounds to inf
    and makes the margin inf, as in the reference."""
    def f64(t):
        return t.detach().to("cpu", torch.float64).numpy()

    delta = np.abs(f64(rows) - f64(lp))
    if delta.size == 0:
        return 0.0
    delta = delta.reshape(-1, delta.shape[-1])
    if metric in ("l2", "sql2"):
        per = np.sqrt(np.sum(delta * delta, axis=-1))
    elif metric == "l1":
        per = np.sum(delta, axis=-1)
    elif metric == "linf":
        per = np.max(delta, axis=-1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return float(per.max())


def _lp_plane(rows: torch.Tensor) -> tuple[torch.Tensor | None, float]:
    """(rows_lp, lp_eps) under the ``REPRO_ROWS_DTYPE`` policy, made on
    ``rows``' device (round to nearest even, as the reference's
    ``astype``); None / 0.0 when the plane is off (the default)."""
    dt = rows_dtype()
    if dt is None or rows.numel() == 0:
        return None, 0.0
    lp = rows.to(LP_DTYPES[dt])
    return lp, lp_quant_eps(rows, lp, "l2")


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
           "LP_DTYPES", "host_tables", "lp_quant_eps", "maybe_paged",
           "rank_columns"]
