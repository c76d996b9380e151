"""The port's baselines (``repro_torch.baselines``) against the
reference's (``repro.baselines``), on the CPU.

Both packages build each baseline over the same seeded numpy corpus and
answer the same queries.  These are host numpy algorithms in both, so
every answer is held exactly: ids, f64 distances, every ``QueryStats``
field but ``time_s``, ``index_nbytes`` and the page stores' counters.
GaussMix under L2 for all five (``ZMIndex`` has no kNN, as in the
paper); L1 and the edit distance over Signature strings for the metric
ones (``BallTree``, ``LinearScan``, and ``MLIndex``/``NLIMS`` under
L1).
"""
import dataclasses

import numpy as np
import pytest

from repro import baselines as ref_baselines
from repro.core.metrics import MetricSpace as RefSpace
from repro_torch import baselines
from repro_torch.core.index import QueryStats
from repro_torch.core.metrics import MetricSpace, dist_one_to_many
from repro_torch.data.datasets import gauss_mix, signature

N, D = 3000, 8
NQ, K = 12, 10
STAT_FIELDS = [f.name for f in dataclasses.fields(QueryStats)
               if f.name != "time_s"]
KW = {"MLIndex": dict(n_clusters=12, degree=8, seed=1),
      "NLIMS": dict(n_clusters=8, m=3, n_rings=10, seed=0),
      "ZMIndex": dict(degree=8),
      "BallTree": dict(seed=3),
      "LinearScan": {}}


def _data(metric):
    if metric == "edit":
        return signature(n_anchors=4, per_anchor=40, seed=2)
    return gauss_mix(N, D, seed=4)


def _queries(X, metric):
    """NQ queries near data rows (4 for the edit distance, whose host
    dynamic program is slow) and a radius at the 0.3% quantile of each
    one's distances (the edit distance: its 2% quantile)."""
    rng = np.random.default_rng(5)
    rows = rng.choice(len(X), 4 if metric == "edit" else NQ, replace=False)
    out = []
    for i in rows:
        if metric == "edit":
            q = X[i].copy()
            q[rng.integers(0, X.shape[1], 3)] = rng.integers(0, 40, 3)
            frac = 2e-2
        else:
            q = X[i] + rng.normal(0, 0.003, X.shape[1])
            frac = 3e-3
        d = dist_one_to_many(q, X, metric)
        out.append((q, float(np.quantile(d, frac))))
    return out


def _pair(name, metric):
    X = _data(metric)
    ref = getattr(ref_baselines, name)(RefSpace(X, metric), **KW[name])
    got = getattr(baselines, name)(MetricSpace(X, metric), **KW[name])
    return X, ref, got


def _same_stats(a, b):
    for f in STAT_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def _same_answer(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    if len(a) == 3:
        assert np.asarray(a[1]).dtype == np.asarray(b[1]).dtype
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    _same_stats(a[-1], b[-1])


def _stores(ix):
    if hasattr(ix, "store"):
        return [ix.store]
    if hasattr(ix, "clusters"):
        return [ci.store for ci in ix.clusters]
    return []


CASES = [(n, "l2") for n in ("LinearScan", "MLIndex", "NLIMS", "ZMIndex",
                             "BallTree")] + \
    [("BallTree", "l1"), ("LinearScan", "l1"), ("MLIndex", "l1"),
     ("NLIMS", "l1"), ("BallTree", "edit"), ("LinearScan", "edit")]


@pytest.mark.parametrize("name,metric", CASES)
def test_baseline_answers_equal_reference(name, metric):
    """Range, kNN (not ZMIndex) and point queries: ids, f64 distances,
    QueryStats, index bytes and page counters equal the reference's."""
    X, ref, got = _pair(name, metric)
    assert got.name == ref.name
    assert got.index_nbytes() == ref.index_nbytes()
    for ix in (ref, got):
        ix.reset_page_counters()
    for q, r in _queries(X, metric):
        _same_answer(got.range_query(q, r), ref.range_query(q, r))
        if name != "ZMIndex":
            _same_answer(got.knn_query(q, K), ref.knn_query(q, K))
    for i in (0, len(X) // 2, len(X) - 1):
        _same_answer(got.point_query(X[i]), ref.point_query(X[i]))
    for a, b in zip(_stores(got), _stores(ref), strict=True):
        assert (a.page_accesses, a.rows_fetched) == \
            (b.page_accesses, b.rows_fetched)
    for ix in (ref, got):
        ix.reset_page_counters()
    assert all(s.page_accesses == 0 for s in _stores(got))


def test_baseline_answers_are_exact():
    """Every baseline's range answer is the brute-force answer and its
    kNN distances the k smallest (ids at ties aside)."""
    X = _data("l2")
    space = MetricSpace(X, "l2")
    ixs = [getattr(baselines, n)(space, **KW[n]) for n in KW]
    for q, r in _queries(X, "l2")[:4]:
        d = dist_one_to_many(q, X, "l2")
        truth = set(np.where(d <= r)[0].tolist())
        kth = np.sort(d)[:K]
        for ix in ixs:
            ids, dist, _ = ix.range_query(q, r)
            assert set(ids.tolist()) == truth, ix.name
            np.testing.assert_array_equal(np.sort(dist), np.sort(d[ids]))
            if ix.name != "zm":
                _, kd, _ = ix.knn_query(q, K)
                np.testing.assert_array_equal(np.sort(kd), kth)


def test_zm_index_needs_vectors():
    space = MetricSpace(signature(n_anchors=2, per_anchor=10), "edit")
    with pytest.raises(ValueError, match="vector"):
        baselines.ZMIndex(space)


def test_pages_beat_scan_at_low_selectivity():
    """The twin of tests/test_lims.py:229 on the port: LIMS reads far
    fewer pages than a full scan, with the port's LinearScan and the
    reference's counting the same pages."""
    from repro.core.index import LIMSIndex as RefLIMS
    from repro_torch.core import LIMSIndex
    X = gauss_mix(40_000, 8, seed=2)
    sp = MetricSpace(X, "l2")
    ix = LIMSIndex(sp, n_clusters=50, m=3, n_rings=20)
    scan = baselines.LinearScan(sp)
    ref_ix = RefLIMS(RefSpace(X, "l2"), n_clusters=50, m=3, n_rings=20)
    ref_scan = ref_baselines.LinearScan(RefSpace(X, "l2"))
    rng = np.random.default_rng(1)
    tot_l = tot_s = 0
    for qi in rng.choice(40_000, 5):
        q = X[qi] + rng.normal(0, 0.003, 8)
        d = dist_one_to_many(q, X, "l2")
        r = float(np.quantile(d, 1e-4))
        got_l, got_s = ix.range_query(q, r), scan.range_query(q, r)
        _same_answer(got_l, ref_ix.range_query(q, r))
        _same_answer(got_s, ref_scan.range_query(q, r))
        tot_l += got_l[2].pages
        tot_s += got_s[2].pages
    assert tot_l < tot_s / 5
