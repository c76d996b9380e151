"""The port's device builder (``repro_torch.build``) against the reference.

Data come from numpy seeds and go to both packages: the reference
builder ``repro.build`` (its ``pdist`` in Pallas interpret mode) and the
port's, run with ``device="cpu"`` (the kernels' plain versions).  For
l2, l1 and linf the structures (centers, assignment, pivot ids) must be
equal bit for bit, to the reference's and to the port's host build; the
fitted models equal within the tolerance stated at each check; every
range and kNN result identical, ids and f64 distances.

``repro.build`` imports ``jax.experimental.enable_x64``, which the
installed jax no longer has.  The module-scoped fixture imports it with
that name patched to ``jax.enable_x64(True)`` and restores
``jax.experimental`` afterwards; nothing else sees the patch.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.build import (batched_chebfit, build_snapshot,
                               cluster_major, device_build)
from repro_torch.build.builder import retrain_device
from repro_torch.build.cluster import one_to_all
from repro_torch.build.pivots import pivot_columns
from repro_torch.core import (LIMSIndex, LIMSSnapshot, MetricSpace,
                              QueryExecutor)
from repro_torch.core.metrics import cdist, dist_one_to_many
from repro_torch.data.datasets import gauss_mix, signature, skewed
from repro_torch.kernels import _cuda

N, D, K, M, RINGS = 3000, 8, 8, 3, 12
METRICS = ["l2", "l1", "linf"]
CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """The reference's builder, core and data modules."""
    jax = pytest.importorskip("jax")
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        mp.setenv("REPRO_INTERPRET", "on")
        mp.setenv("REPRO_AUTOTUNE", "off")
        yield SimpleNamespace(
            build=importlib.import_module("repro.build"),
            builder=importlib.import_module("repro.build.builder"),
            pivots=importlib.import_module("repro.build.pivots"),
            core=importlib.import_module("repro.core"))


def _data(metric: str) -> np.ndarray:
    # the paper pairs Skewed with L1; GaussMix is the L2 corpus
    return gauss_mix(N, D, seed=4) if metric == "l2" else skewed(N, D, seed=1)


@pytest.fixture(scope="module", params=METRICS)
def built(request, ref):
    """Per metric: the data, the port's device build result, and three
    indexes: the reference's device build, the port's device build, the
    port's host build."""
    metric = request.param
    X = _data(metric)
    kw = dict(n_clusters=K, m=M, n_rings=RINGS)
    return SimpleNamespace(
        metric=metric, X=X,
        result=device_build(MetricSpace(X, metric), K, m=M, n_rings=RINGS,
                            device=CPU),
        ref=ref.core.LIMSIndex(ref.core.MetricSpace(X, metric),
                               backend="device", **kw),
        dev=LIMSIndex(MetricSpace(X, metric), backend="device", device=CPU,
                      **kw),
        host=LIMSIndex(MetricSpace(X, metric), **kw))


def _eq(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _queries(X, n_q, seed=2, scale=0.004):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n_q)] + rng.normal(0, scale,
                                                   (n_q, X.shape[1]))


def _radii(X, Q, metric, sel=0.02):
    return np.array([float(np.quantile(dist_one_to_many(q, X, metric), sel))
                     for q in Q])


# ----------------------------------------------------------- structures
def test_device_build_structures_equal(built):
    """Centers, assignment and pivot ids: bitwise equal to the
    reference's device build and to the port's host build."""
    r, ref, host = built.result, built.ref, built.host
    for other in (ref.clustering, host.clustering):
        assert _eq(r.clustering.center_idx, other.center_idx)
        assert _eq(r.clustering.assign, other.assign)
        assert _eq(r.clustering.dist_to_center, other.dist_to_center)
    assert _eq(r.pivot_gids, np.stack([ci.pivot_idx for ci in ref.clusters]))
    assert _eq(r.pivot_gids, np.stack([ci.pivot_idx for ci in host.clusters]))
    assert set(r.timings) == {"cluster_s", "pivot_s", "fit_s", "device_s"}
    assert built.dev.device_build_timings.keys() == r.timings.keys()


def test_device_index_materializes_host_structures(built):
    """The f64 recompute makes every exactness-bearing column of the
    device-built index equal to the host build's."""
    for h, d, rf in zip(built.host.clusters, built.dev.clusters,
                        built.ref.clusters):
        assert _eq(h.pivot_idx, d.pivot_idx)
        for f in ("d_sorted", "rids", "lims_sorted", "dist_min", "dist_max"):
            assert _eq(getattr(h.mapping, f), getattr(d.mapping, f)), f
            assert _eq(getattr(rf.mapping, f), getattr(d.mapping, f)), f
        assert _eq(h.store_ids, d.store_ids)
        assert _eq(h.pivot_d_stored, d.pivot_d_stored)
    assert built.host.default_delta_r == built.dev.default_delta_r


def test_device_models_match_reference(built):
    """Device-fit models against the reference's: same sizes, degrees
    and spans; predicted ranks at every column value within
    max(2, 1% of n).  The columns differ in the last f32 bits (another
    summation order in pdist) and the f32 normal equations are solved
    by another LAPACK build; a degree-8 fit is ill-conditioned, so its
    coefficients move along near-null directions (measured: up to 6% of
    the largest) while the ranks it predicts barely move (measured:
    0.6% of n at most)."""
    for d, rf in zip(built.dev.clusters, built.ref.clusters):
        cols = list(d.mapping.d_sorted) + [d.mapping.lims_sorted * 1.0]
        for a, b, col in zip(d.rank_models + [d.pos_model],
                             rf.rank_models + [rf.pos_model], cols):
            assert a.n == b.n and len(a.coef) == len(b.coef)
            np.testing.assert_allclose([a.lo, a.hi], [b.lo, b.hi],
                                       rtol=1e-6)
            diff = np.abs(a.predict(col) - b.predict(col)).max()
            assert diff <= max(2, 0.01 * a.n)


def test_pivot_columns_match_reference(built, ref):
    """The port's chunked pdist launch and block-diagonal gather against
    the reference's on the same f32 rows: rtol 1e-6 for l1/linf (another
    summation order over d), and for l2 the pdist tolerance of
    test_torch_kernels.py, rtol 1e-5 / atol 1e-5·d (another Gram
    order), after the square root."""
    X, metric = built.X, built.metric
    member_idx, _, _, n_max = cluster_major(built.result.clustering.members)
    rows = X[member_idx].astype(np.float32)
    prow = X[built.result.pivot_gids].astype(np.float32)
    got = pivot_columns(torch.from_numpy(rows), torch.from_numpy(prow),
                        metric, chunk=3).numpy()
    want = np.asarray(ref.pivots.pivot_columns(rows, prow, metric, chunk=3))
    assert got.shape == (K, M, n_max)
    if metric == "l2":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * D)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _chunked_columns(rows, prow, metric, chunk):
    """The reference's chunked pivot columns through the port's
    ``ops.pdist``: a chunk's (cc·m, cc·n_max) matrix, then its
    per-cluster block diagonal."""
    from repro_torch.kernels import ops
    K, n_max, d = rows.shape
    m = prow.shape[1]
    outs = []
    for c0 in range(0, K, chunk):
        cc = min(chunk, K - c0)
        dist = ops.pdist(prow[c0:c0 + cc].reshape(cc * m, d),
                         rows[c0:c0 + cc].reshape(cc * n_max, d), metric)
        ar = torch.arange(cc, device=dist.device)
        outs.append(dist.reshape(cc, m, cc, n_max)[ar, :, ar, :])
    return torch.cat(outs)


def _lp_columns_inputs(device, K=7, n_max=384, m=3, d=8):
    """Cluster-major rows with zero-padded slots past each cluster's
    count, and each cluster's m pivot rows among its members."""
    rng = np.random.default_rng(K + n_max + d)
    X = skewed(K * n_max, d, seed=5).astype(np.float32)
    rows = X.reshape(K, n_max, d).copy()
    counts = rng.integers(1, n_max + 1, K)
    for k in range(K):
        rows[k, counts[k]:] = rows[k, 0]        # padding holds row 0
    prow = np.stack([rows[k, rng.integers(0, counts[k], m)]
                     for k in range(K)])
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(prow).to(device))


@pytest.mark.parametrize("metric", ["l1", "linf"])
@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_pivot_columns_grouped_equals_chunked(metric, chunk):
    """For l1 and linf ``pivot_columns`` is one grouped launch; it
    equals the chunked launch and gather bit for bit, padded slots
    included, whatever the chunk (which it no longer reads)."""
    rows, prow = _lp_columns_inputs(CPU)
    got = pivot_columns(rows, prow, metric, chunk=chunk)
    assert got.shape == (7, 3, 384)
    assert torch.equal(got, _chunked_columns(rows, prow, metric, chunk))


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l1", "linf"])
@pytest.mark.parametrize("K,n_max,d", [(7, 384, 8), (64, 1024, 8),
                                       (5, 256, 256)])
def test_pivot_columns_grouped_equals_chunked_on_card(metric, K, n_max, d):
    """On the card: the grouped launch against the chunked launch and
    gather (the G = 1 kernel), ``torch.equal``; one launch in all for
    the grouped columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rows, prow = _lp_columns_inputs(torch.device("cuda"), K, n_max, d=d)
    _cuda.reset_launches()
    got = pivot_columns(rows, prow, metric)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["pdist_" + metric] == 1
    assert torch.equal(got, _chunked_columns(rows, prow, metric, 16))


@pytest.mark.parametrize("metric", METRICS)
def test_one_to_all_close_to_host(metric):
    """The f64 sweep distances against the host's ``dist_one_to_many``:
    both sum d nonnegative terms, in different orders, so they differ by
    at most (d - 1) ulps of the sum; the max of linf is exact."""
    X = skewed(2000, D, seed=3)
    got = one_to_all(torch.from_numpy(X), torch.from_numpy(X[7]),
                     metric).numpy()
    want = dist_one_to_many(X[7], X, metric)
    if metric == "linf":
        assert _eq(got, want)
    assert np.all(np.abs(got - want) <= (D - 1) * np.spacing(want))


def test_fft_sweeps_latch_on_duplicates():
    """A cluster of identical rows latches onto its centroid: pivots
    repeat exactly as the host's break-then-pad loop repeats them."""
    rng = np.random.default_rng(0)
    X = np.concatenate([gauss_mix(400, 4, seed=2),
                        np.tile([[9.0, 9.0, 9.0, 9.0]], (60, 1)),
                        np.tile([[-9.0, 9.0, -9.0, 9.0]], (2, 1))])
    X = X[rng.permutation(len(X))]
    host = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=8)
    dev = device_build(MetricSpace(X, "l2"), 6, m=3, n_rings=8, device=CPU)
    piv = np.stack([ci.pivot_idx for ci in host.clusters])
    assert _eq(dev.pivot_gids, piv)
    assert any(p[0] == p[1] == p[2] for p in piv)


# ---------------------------------------------------------------- fitting
def _fit_inputs(G=12, n_max=512, seed=0):
    rng = np.random.default_rng(seed)
    cols = np.full((G, n_max), np.inf, np.float32)
    counts = rng.integers(2, n_max, G)
    counts[0] = n_max
    for g in range(G):
        cols[g, :counts[g]] = np.sort(rng.gamma(2.0, 1.0, counts[g]))
    cols[3, :counts[3]] = 3.25                      # constant column
    cols[4, :] = np.inf
    cols[4, 0] = 1.5                                # single element
    counts[4] = 1
    counts[5] = 0                                   # empty group
    return cols, counts, np.where(np.arange(G) % 2, 8, 5)


def test_batched_chebfit_matches_reference(ref):
    """dg, lo, hi and n equal the reference's; coef and the error
    estimate agree to 1e-4 of the group's largest coefficient / of n:
    both solve the f32 normal equations, through different LAPACK
    builds (measured: 1.5e-5 relative)."""
    cols, counts, deg = _fit_inputs()
    got = [t.numpy() for t in batched_chebfit(cols, counts, deg, 8)]
    want = [np.asarray(a) for a in ref.build.batched_chebfit(cols, counts,
                                                             deg, 8)]
    coef, lo, hi, n, dg, err = got
    for a, b in zip((lo, hi, n, dg), want[1:5]):
        assert _eq(a, b)
    scale = np.maximum(np.abs(want[0]).max(axis=1, keepdims=True), 1.0)
    assert np.all(np.abs(coef - want[0]) <= 1e-4 * scale)
    assert np.all(np.abs(err - want[5]) <= 1e-4 * np.maximum(n, 1.0))


def test_batched_chebfit_degenerate_groups():
    """The batched fit survives constant, single-element and empty
    columns (the device mirror of the hardened host fit)."""
    n_max = 64
    cols = np.zeros((4, n_max), np.float32)
    rng = np.random.default_rng(0)
    cols[0] = np.sort(rng.gamma(2.0, 1.0, n_max))     # healthy
    cols[1] = 3.25                                     # constant column
    cols[2, 0] = 1.5                                   # single element
    counts = np.array([n_max, n_max, 1, 0])
    coef, lo, hi, n, dg, err = (t.numpy() for t in batched_chebfit(
        cols, counts, np.full(4, 8), 8))
    assert np.all(np.isfinite(coef))
    t = np.clip((cols[0] - lo[0]) / (hi[0] - lo[0]) * 2 - 1, -1, 1)
    pred = np.polynomial.chebyshev.chebval(t, coef[0])
    assert np.abs(pred - np.arange(n_max)).max() < n_max / 4
    assert not coef[1].any() and hi[1] > lo[1]
    assert not coef[2].any() and hi[2] > lo[2]
    assert not coef[3].any() and err[3] == 0.0
    assert np.all(err <= n + 1e-6)


# ---------------------------------------------------------------- queries
def test_device_index_queries_identical(built):
    """Range and kNN results of the port's device-built index are
    identical (ids and f64 distances) to the reference's device-built
    index and to the port's host build, and range equals brute force."""
    X, metric = built.X, built.metric
    Q = _queries(X, 6)
    for q, r in zip(Q, _radii(X, Q, metric)):
        got = built.dev.range_query(q, r)
        for other in (built.ref, built.host):
            want = other.range_query(q, r)
            assert _eq(got[0], want[0]) and _eq(got[1], want[1])
        d_all = dist_one_to_many(q, X, metric)
        assert set(got[0].tolist()) == set(np.nonzero(d_all <= r)[0].tolist())
        got = built.dev.knn_query(q, 6)
        for other in (built.ref, built.host):
            want = other.knn_query(q, 6)
            assert _eq(got[0], want[0]) and _eq(got[1], want[1])


def test_device_snapshot_serves_like_host():
    """A snapshot of the device-built L2 index answers batches exactly
    as the host build's snapshot does."""
    X = gauss_mix(N, D, seed=4)
    snap, dev = build_snapshot(MetricSpace(X, "l2"), K, m=M, n_rings=RINGS,
                               device=CPU)
    host = LIMSIndex(MetricSpace(X, "l2"), n_clusters=K, m=M, n_rings=RINGS)
    assert snap.live == dev.live_count() == N
    eh = QueryExecutor(LIMSSnapshot.build(host, device=CPU))
    ed = QueryExecutor(snap)
    Q = _queries(X, 6, seed=5)
    rs = _radii(X, Q, "l2")
    for (ai, ad), (bi, bd) in zip(eh.range_query_batch(Q, rs),
                                  ed.range_query_batch(Q, rs)):
        assert _eq(ai, bi) and _eq(ad, bd)
    ka, da = eh.knn_query_batch(Q, 6)
    kb, db = ed.knn_query_batch(Q, 6)
    assert _eq(ka, kb) and _eq(da, db)


def test_build_snapshot_paged_matches_reference(ref, tmp_path):
    """``build_snapshot(spill_path=, store=True)`` spills during the
    build and returns the store-backed snapshot, as the reference's does:
    the same page file byte for byte, the same manifest, the same layout
    metadata, model domains within the tolerance of
    ``test_device_models_match_reference`` (the device fits, and with
    them the coefficients and the bound E, differ in f32), and the same
    answers as the reference's store-backed snapshot and the host."""
    from repro.core.executor import QueryExecutor as RefExecutor
    from repro_torch.storage import Manifest, load_meta
    X = gauss_mix(N, D, seed=4)
    kw = dict(m=M, n_rings=RINGS)
    path, ref_path = str(tmp_path / "port"), str(tmp_path / "ref")
    snap, dev = build_snapshot(MetricSpace(X, "l2"), K, spill_path=path,
                               page_bytes=1024, store=True, device=CPU, **kw)
    ref_snap, _ = ref.build.build_snapshot(
        ref.core.MetricSpace(X, "l2"), K, spill_path=ref_path,
        page_bytes=1024, store=True, **kw)
    assert snap.store is not None and tuple(snap.rows.shape) == (K, 0, D)
    with open(f"{path}/pages.bin", "rb") as f, \
            open(f"{ref_path}/pages.bin", "rb") as g:
        assert f.read() == g.read()
    assert vars(Manifest.load(path)) == vars(Manifest.load(ref_path))
    meta, _ = load_meta(path)
    ref_meta, _ = load_meta(ref_path)
    assert sorted(meta) == sorted(ref_meta)
    for k in meta:
        assert meta[k].dtype == ref_meta[k].dtype, k
        if k in ("model_lo", "model_hi"):
            np.testing.assert_allclose(meta[k], ref_meta[k], rtol=1e-6)
        elif k not in ("coef", "rank_err"):
            assert _eq(meta[k], ref_meta[k]), k
    ex, rex = QueryExecutor(snap), RefExecutor(ref_snap)
    Q = _queries(X, 6, seed=7)
    rs = _radii(X, Q, "l2")
    for (ai, ad), (bi, bd), q, r in zip(ex.range_query_batch(Q, rs),
                                        rex.range_query_batch(Q, rs), Q, rs):
        assert _eq(ai, bi) and _eq(ad, bd)
        hi, hd, _ = dev.range_query(q, r)
        assert set(ai.tolist()) == set(hi.tolist())
    ka, da = ex.knn_query_batch(Q, 6)
    kb, db = rex.knn_query_batch(Q, 6)
    assert _eq(ka, kb) and _eq(da, db)
    resident, _ = build_snapshot(MetricSpace(X, "l2"), K, spill_path=path,
                                 page_bytes=1024, device=CPU, **kw)
    assert resident.store is None and resident.rows.shape[1] > 0
    with pytest.raises(ValueError, match="spill_path"):
        build_snapshot(MetricSpace(X, "l2"), K, store=True, device=CPU, **kw)


# ---------------------------------------------------------------- retrain
@pytest.mark.parametrize("metric", METRICS)
def test_device_retrain_matches_host(metric):
    """After inserts and deletes, a device retrain answers exactly as a
    host retrain of the same cluster, and both fold the buffer in."""
    X = _data(metric)[:900]
    rng = np.random.default_rng(0)
    new = X[rng.choice(900, 12)] + rng.normal(0, 0.01, (12, D))
    idx = [LIMSIndex(MetricSpace(X, metric), n_clusters=4, m=3, n_rings=8)
           for _ in range(2)]
    for ix, backend in zip(idx, ("device", "host")):
        for row in new:
            ix.insert(row)
        assert ix.delete(X[3]) == 1 and ix.delete(new[0]) == 1
        for c in range(ix.K):
            ix.retrain_cluster(c, backend=backend, device=CPU)
        assert ix.last_retrain_backend == backend
        assert all(len(ci.buf_ids) == 0 for ci in ix.clusters)
    all_rows = np.concatenate([X, new])
    Q = _queries(X, 4, seed=5)
    for q, r in zip(Q, _radii(all_rows, Q, metric, 0.03)):
        a, b = (ix.range_query(q, r) for ix in idx)
        assert _eq(a[0], b[0]) and _eq(a[1], b[1])
        truth = set(np.nonzero(dist_one_to_many(q, all_rows, metric)
                               <= r)[0].tolist()) - {3, 900}
        assert set(a[0].tolist()) == truth
        a, b = (ix.knn_query(q, 6) for ix in idx)
        assert _eq(a[0], b[0]) and _eq(a[1], b[1])


def test_retrain_device_matches_reference(ref):
    """``retrain_device`` picks the reference's pivots and returns the
    same exact f64 pivot rows and distance matrix."""
    X = skewed(700, D, seed=6)
    cent = X[0] + 0.01
    got = retrain_device(MetricSpace(X, "l1"), cent, 3, 8, 8, 8, device=CPU)
    want = ref.builder.retrain_device(ref.core.MetricSpace(X, "l1"), cent,
                                      3, 8, 8, 8)
    assert _eq(got[0], want[0]) and _eq(got[1], want[1])
    assert got[3].n == want[3].n == 700


# --------------------------------------------------------- other metrics
def test_cosine_pivot_columns_take_plain_cdist():
    """Cosine has no pdist kernel: its columns are the plain ``cdist``
    block diagonal, and no kernel is launched."""
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.normal(size=(3, 128, 5)).astype(np.float32))
    prow = torch.from_numpy(rng.normal(size=(3, 2, 5)).astype(np.float32))
    before = dict(_cuda.LAUNCHES)
    got = pivot_columns(rows, prow, "cosine", chunk=2)
    assert _cuda.LAUNCHES == before
    for k in range(3):
        assert torch.equal(got[k], cdist(prow[k], rows[k], "cosine"))


def test_device_build_rejects_generic_metrics():
    sig = signature(3, 40, seed=1)
    with pytest.raises(ValueError):
        device_build(MetricSpace(sig, "edit"), 3, m=2, device=CPU)
    X = gauss_mix(200, 4, seed=1)
    custom = MetricSpace(X, "l2", dist_fn=lambda a, b: float(np.abs(a - b).sum()))
    with pytest.raises(ValueError):
        device_build(custom, 3, m=2, device=CPU)


def test_device_kmeans_backend_is_exact():
    """kMeans on the device may partition otherwise than the host's f64
    Lloyd loop; the materialized index must still be exact."""
    X = gauss_mix(800, 4, seed=3)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=5, m=2, n_rings=8,
                   backend="device", clusterer="kmeans", device=CPU)
    rng = np.random.default_rng(1)
    for qi in rng.choice(800, 4):
        q = X[qi] + rng.normal(0, 0.004, 4)
        d = dist_one_to_many(q, X, "l2")
        r = float(np.quantile(d, 0.02))
        ids, _, _ = ix.range_query(q, r)
        assert set(map(int, ids)) == set(np.nonzero(d <= r)[0].tolist())
