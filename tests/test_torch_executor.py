"""The port's resident query path against the reference's, on the CPU.

Same seeded corpus and index settings as ``tests/test_batched.py``
(N = 2500, D = 6, K = 10).  The reference runs ``repro``'s snapshot,
planner and ``QueryExecutor`` through its Pallas kernels in interpret
mode; the port runs ``repro_torch``'s on CPU tensors, i.e. through each
kernel's plain version.  Checked: snapshot fields and model tables
equal, E covering the port kernel's own error, plan masks equal to the
reference's and supersets of the host index's candidates, fused and
staged plans bitwise equal, and range/kNN results — ids and f64
distances — identical to the reference executor and the host index
with ``REPRO_COMPACT`` on and off, also on a snapshot carried over from
the reference with ``snapshot_from_reference``.
"""
import numpy as np
import pytest
import torch

from repro.core import LIMSIndex as RefIndex
from repro.core import MetricSpace as RefSpace
from repro.core.executor import QueryExecutor as RefExecutor
from repro.core.metrics import dist_one_to_many
from repro.core.snapshot import LIMSSnapshot as RefSnapshot
from repro_torch.convert import FIELDS, snapshot_from_reference
from repro_torch.core import LIMSIndex, MetricSpace, QueryExecutor
from repro_torch.core.batched import BatchedLIMS
from repro_torch.core.planner import plan_arrays
from repro_torch.core.snapshot import (DEVICE_FIELDS, LIMSSnapshot,
                                       rank_columns)
from repro_torch.data.datasets import gauss_mix
from repro_torch.kernels import _cuda, ops

N, D = 2500, 6
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def env():
    X = gauss_mix(N, D, seed=4)
    ref_ix = RefIndex(RefSpace(X, "l2"), n_clusters=10, m=3, n_rings=12)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=10, m=3, n_rings=12)
    ref_snap = RefSnapshot.build(ref_ix)
    snap = LIMSSnapshot.build(ix, device=CPU)
    carried = snapshot_from_reference(
        {f: np.asarray(getattr(ref_snap, f)) for f in FIELDS}, CPU)
    return {"X": X, "ref_ix": ref_ix, "ix": ix, "ref_snap": ref_snap,
            "snap": snap, "ref_ex": RefExecutor(ref_snap),
            "port": QueryExecutor(snap), "carried": QueryExecutor(carried)}


@pytest.fixture(params=["on", "off"])
def compact(request, monkeypatch):
    """Both packages read REPRO_COMPACT per call."""
    monkeypatch.setenv("REPRO_COMPACT", request.param)
    return request.param


def _queries(X, n_q, seed=2, scale=0.004):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n_q)] + rng.normal(0, scale, (n_q, D))


def _radii(X, Q, seed=3):
    rng = np.random.default_rng(seed)
    rs = np.array([float(np.quantile(dist_one_to_many(q, X, "l2"),
                                     rng.uniform(5e-4, 5e-2))) for q in Q])
    rs[0] = 1e-12                       # provably empty
    return rs


# -------------------------------------------------------------- snapshot
def test_snapshot_fields_equal_reference(env):
    """Every field but E equals the reference snapshot's; E (certified
    on each package's own kernel) bounds the port kernel's error at the
    data points."""
    snap, ref = env["snap"], env["ref_snap"]
    for f in ("K", "m", "n_rings", "n_max", "live"):
        assert getattr(snap, f) == getattr(ref, f), f
    for f in DEVICE_FIELDS:
        if f == "rank_err":
            continue
        a, b = getattr(snap, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("gids_np", "rows_np", "valid_np"):
        assert np.array_equal(getattr(snap, f), getattr(ref, f)), f
    G, C = snap.K * snap.m, snap.coef.shape[-1]
    pred = ops.rankeval(torch.from_numpy(rank_columns(env["ix"])),
                        snap.coef.reshape(G, C), snap.model_lo.reshape(G),
                        snap.model_hi.reshape(G), snap.model_n.reshape(G),
                        snap.n_rings)[0].numpy()
    E = snap.rank_err.reshape(G).numpy()
    ns = snap.model_n.reshape(G).numpy().astype(int)
    for g in range(G):
        err = np.abs(pred[g, :ns[g]] - np.arange(ns[g])).max()
        assert err <= E[g], (g, err, E[g])
    np.testing.assert_allclose(E, np.asarray(ref.rank_err).reshape(G),
                               atol=1.0)


# ------------------------------------------------------------------ plans
def test_plan_masks_equal_reference_and_cover_host(env):
    X, ix = env["X"], env["ix"]
    port, ref = env["port"], env["ref_ex"]
    Q = _queries(X, 8, seed=6)
    rs = _radii(X, Q)
    before = port.planner.built
    pr = port.planner.plan_range(Q, rs)
    assert port.planner.built == before + 1
    rr = ref.planner.plan_range(Q, rs)
    assert np.array_equal(pr.mask, rr.mask)
    assert np.array_equal(pr.routing, rr.routing)
    gids = env["snap"].gids_np
    for b, (q, r) in enumerate(zip(Q, rs)):
        host_cand, _, _ = ix.range_query(q, r, collect="all")
        assert set(host_cand.tolist()) <= set(gids[pr.mask[b]].tolist())
    for k in (1, 6):
        pk, rk = port.planner.plan_knn(Q, k, 64), ref.planner.plan_knn(Q, k,
                                                                       64)
        # the kNN seed is an f32 Gram distance to the nearest pivot: the
        # reference's XLA dot sums in another order than the port's
        # kernel, so the seeds agree to a few f32 ulps, far inside the
        # planner's 1e-5 relative guard band, and the masks are equal
        np.testing.assert_allclose(pk.radii, rk.radii, rtol=1e-5)
        assert np.array_equal(pk.mask, rk.mask)
    assert port.planner.built == before + 3


def test_eval_mask_matches_plan_and_reference(env):
    """Round evaluation at explicit radii: at round-0 radii it is the
    plan's own mask; at doubled radii it equals the reference's."""
    port, ref = env["port"], env["ref_ex"]
    Q = _queries(env["X"], 5, seed=13)
    rs = _radii(env["X"], Q)
    plan = port.planner.plan_range(Q, rs)
    assert np.array_equal(port.planner.eval_mask(plan.qf, rs), plan.mask)
    rplan = ref.planner.plan_range(Q, rs)
    assert np.array_equal(port.planner.eval_mask(plan.qf, 2 * rs),
                          ref.planner.eval_mask(rplan.qf, 2 * rs))


def test_fused_and_staged_plans_bitwise(env):
    snap = env["snap"]
    Q = _queries(env["X"], 9, seed=8)
    qf = torch.from_numpy(Q.astype(np.float32))
    for rf in (torch.full((9,), 0.05), torch.linspace(0.0, 0.4, 9)):
        fm, fa = plan_arrays(qf, rf, snap, snap.n_rings, fused=True)
        sm, sa = plan_arrays(qf, rf, snap, snap.n_rings, fused=False)
        assert torch.equal(fm, sm) and torch.equal(fa, sa)
        assert fm.any()


# ---------------------------------------------------------------- queries
def _check_range(got, ref_got, host, Q, rs, X):
    assert len(got) == len(Q) and len(got[0][0]) == 0
    for (ids, ds), (rids, rds), (hids, hds) in zip(got, ref_got, host):
        assert np.array_equal(ids, rids) and np.array_equal(ds, rds)
        a, b = np.argsort(ids), np.argsort(hids)
        assert np.array_equal(ids[a], hids[b])
        assert np.array_equal(ds[a], hds[b])


@pytest.mark.parametrize("which", ["port", "carried"])
def test_range_identical(env, compact, which):
    X, ix = env["X"], env["ix"]
    ex = env[which]
    Q = _queries(X, 12)
    rs = _radii(X, Q)
    got = ex.range_query_batch(Q, rs)
    ref_got = env["ref_ex"].range_query_batch(Q, rs)
    host = [ix.range_query(q, r)[:2] for q, r in zip(Q, rs)]
    _check_range(got, ref_got, host, Q, rs, X)
    if compact == "on":
        assert ex.last_compact["slots"] > 0
        assert ex.last_compact["bucket"] >= ex.last_compact["slots"]
    else:
        assert ex.last_compact is None
    prof = ex.last_profile              # REPRO_OBS defaults to on
    assert prof.kind == "range" and prof.batch == len(Q)
    assert prof.missing() == []


@pytest.mark.parametrize("k", [1, 7, N + 500])
@pytest.mark.parametrize("which", ["port", "carried"])
def test_knn_identical(env, compact, which, k):
    X, ix = env["X"], env["ix"]
    ex = env[which]
    Q = _queries(X, 6, seed=5)
    ids, ds = ex.knn_query_batch(Q, k)
    k_eff = min(k, N)
    assert ids.shape == (6, k_eff) and ds.shape == (6, k_eff)
    rids, rds = env["ref_ex"].knn_query_batch(Q, k)
    assert np.array_equal(ids, rids) and np.array_equal(ds, rds)
    for b, q in enumerate(Q):
        hids, hds, _ = ix.knn_query(q, k)
        assert np.array_equal(ds[b], hds)
        assert set(ids[b].tolist()) == set(hids.tolist())
    assert ex.last_knn["rounds"] >= 1 and ex.last_knn["driver"] == "rounds"
    assert ex.last_knn["host_syncs"] >= ex.last_knn["rounds"]


def test_single_query_wrappers(env):
    X, ix = env["X"], env["ix"]
    q = _queries(X, 1, seed=9)[0]
    r = float(np.quantile(dist_one_to_many(q, X, "l2"), 0.01))
    ids, ds = env["port"].range_query(q, r)
    hids, _, _ = ix.range_query(q, r)
    assert set(ids.tolist()) == set(hids.tolist())
    ids, ds = env["port"].knn_query(q, 3)
    assert np.array_equal(ds, ix.knn_query(q, 3)[1])


def test_post_insert_delete_snapshot():
    """A snapshot taken after §5.3 updates sees buffered inserts (the
    always-candidate slots) and skips tombstones, like the host."""
    rng = np.random.default_rng(0)
    X = gauss_mix(1500, D, seed=1)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
    new_rows = X[rng.choice(1500, 25)] + rng.normal(0, 0.02, (25, D))
    gids = [ix.insert(r) for r in new_rows]
    ix.delete(X[3])
    ix.delete(new_rows[0])
    bx = BatchedLIMS(ix, device="cpu")
    assert bool(bx.snap.always.any())
    Q = np.concatenate([new_rows[:4], X[rng.choice(1500, 4)]]) \
        + rng.normal(0, 0.003, (8, D))
    rs = np.array([float(np.quantile(dist_one_to_many(q, X, "l2"), 0.02))
                   for q in Q])
    for (ids, ds), q, r in zip(bx.range_query_batch(Q, rs), Q, rs):
        h_ids, _, _ = ix.range_query(q, r)
        assert set(map(int, ids)) == set(map(int, h_ids))
    ids, ds = bx.knn_query_batch(Q, 5)
    for b, q in enumerate(Q):
        assert np.array_equal(ds[b], ix.knn_query(q, 5)[1])
    hit_ids, _ = bx.range_query(new_rows[1], 1e-9)
    assert gids[1] in set(map(int, hit_ids))


def test_cpu_path_launches_no_kernel(env):
    """The CPU lane runs the plain versions: the launch counters, which
    only a CUDA launch moves, stay put through a whole batch."""
    before = dict(_cuda.LAUNCHES)
    X = env["X"]
    Q = _queries(X, 3, seed=12)
    env["port"].range_query_batch(Q, 0.05)
    env["port"].knn_query_batch(Q, 4)
    assert _cuda.LAUNCHES == before
