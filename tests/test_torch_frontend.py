"""The port's replica-set serving (``repro_torch.serving.{frontend,
router,replicas}`` and ``CandidatePlan.subset``) against the reference,
on the CPU.

Twins of the twelve tests of ``tests/test_frontend.py`` on its seeded
corpus (GaussMix N = 1,200, d = 5, seed 13; K = 5, m = 3, N = 8): the
port runs with ``device="cpu"`` (every kernel through its plain
version) on the reference's snapshot carried over
(``snapshot_from_reference``), and its answers — router, frontend,
paged — are held to the reference executor's (Pallas in interpret
mode), ids and f64 distances with zero tolerance.  Beyond the twins:
``plan.subset``'s mask and routing rows equal the reference subset's;
over one sequence of batches the router's picks, ``routed_heat``,
``heat_skew`` and rebalanced owner arrays equal the reference router's;
``LIMSSnapshot.to`` shares every host field and, on its own device,
every tensor; each routed sub-batch counts its own host syncs on a
reused and on a fresh thread; and ``_cuda.launch`` loses no count
under concurrent launching threads.  Every wait is bounded.  The
reference is imported inside a fixture, so the ``gpu`` test (a
2-replica frontend on the card against the CPU port) collects where
JAX is absent.
"""
import dataclasses
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.convert import FIELDS, snapshot_from_reference
from repro_torch.core import LIMSIndex, LIMSSnapshot, MetricSpace
from repro_torch.core.executor import QueryExecutor
from repro_torch.core.metrics import dist_one_to_many
from repro_torch.core.snapshot import DEVICE_FIELDS
from repro_torch.data.datasets import gauss_mix
from repro_torch.kernels import _cuda
from repro_torch.serving import (FrontendOverload, PlanRouter, Replica,
                                 ReplicaSet, ServingEngine, ServingFrontend)

N, D = 1200, 5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    """The reference package, imported here so that the ``gpu`` test
    runs where JAX is absent."""
    core = pytest.importorskip("repro.core")
    from repro.core.executor import QueryExecutor as RefExecutor
    from repro.core.snapshot import LIMSSnapshot as RefSnapshot
    from repro.serving import PlanRouter as RefRouter
    from repro.serving import ReplicaSet as RefReplicaSet
    return SimpleNamespace(core=core, Executor=RefExecutor,
                           Snapshot=RefSnapshot, Router=RefRouter,
                           ReplicaSet=RefReplicaSet)


def _queries(X, n_q, seed=2, scale=0.004):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n_q)] + rng.normal(0, scale, (n_q, D))


def _radii(X, Q, sel=0.02):
    return np.array([float(np.quantile(dist_one_to_many(q, X, "l2"), sel))
                     for q in Q])


class _RefAnswers:
    """The reference executor's answers over the module's queries, each
    computed once (per-query results do not depend on batchmates, so a
    row of a full-batch answer is the answer of any sub-batch)."""

    def __init__(self, ex, Q, rs):
        self.ex, self.Q, self.rs = ex, Q, rs
        self._cache = {}

    def range(self):
        if "range" not in self._cache:
            self._cache["range"] = self.ex.range_query_batch(self.Q, self.rs)
        return self._cache["range"]

    def knn(self, k: int):
        if k not in self._cache:
            self._cache[k] = self.ex.knn_query_batch(self.Q, k)
        return self._cache[k]


@pytest.fixture(scope="module")
def setup(ref, tmp_path_factory):
    X = gauss_mix(N, D, seed=13)
    ref_ix = ref.core.LIMSIndex(ref.core.MetricSpace(X, "l2"),
                                n_clusters=5, m=3, n_rings=8)
    ref_snap = ref.Snapshot.build(ref_ix)
    snap = snapshot_from_reference(
        {f: np.asarray(getattr(ref_snap, f)) for f in FIELDS}, CPU)
    path = str(tmp_path_factory.mktemp("frontend-store"))
    snap.spill(path)
    Q = _queries(X, 12, seed=5)
    rs = _radii(X, Q)
    rs[0] = 1e-12                            # unrouted → round-robin
    return SimpleNamespace(
        X=X, ref_snap=ref_snap, snap=snap, path=path, Q=Q, rs=rs,
        want=_RefAnswers(ref.Executor(ref_snap), Q, rs))


def _pending(f: ServingFrontend) -> int:
    with f._cv:
        return len(f._pending)


def _wait_pending(f: ServingFrontend, n: int, timeout: float = 10.0):
    deadline = time.monotonic() + timeout
    while _pending(f) < n:
        assert time.monotonic() < deadline, \
            f"only {_pending(f)}/{n} requests queued"
        time.sleep(0.005)


def _join(threads, timeout: float = 30.0) -> None:
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), f"{t.name} did not finish"


def _same_range(got, want) -> None:
    assert len(got) == len(want)
    for (gi, gd), (wi, wd) in zip(got, want):
        assert np.array_equal(gi, np.asarray(wi))
        assert np.array_equal(gd, np.asarray(wd))


def _same_knn_row(got, want, j) -> None:
    assert np.array_equal(got[0], np.asarray(want[0])[j])
    assert np.array_equal(got[1], np.asarray(want[1])[j])


def _no_device(stats: list) -> list:
    """Replica stats without the device names (the packages name their
    devices differently)."""
    return [{k: v for k, v in st.items() if k != "device"} for st in stats]


def _submit_all(f: ServingFrontend, calls: list) -> dict:
    """Start one submitter thread per ``(tag, fn, args)``, wait until all
    are queued, resume the batcher and collect the results by tag."""
    out = {}
    threads = [threading.Thread(
        target=lambda tag=tag, fn=fn, a=a: out.__setitem__(tag, fn(*a)))
        for tag, fn, a in calls]
    for t in threads:
        t.start()
    _wait_pending(f, len(calls))
    f.resume()
    _join(threads)
    return out


# -------------------------------------------------------------------- shim
def test_core_serving_shim_still_works():
    """Every import path of the serving stack resolves to one class."""
    import repro_torch.serving as serving
    from repro_torch.core import ServingEngine as core_engine
    from repro_torch.core.serving import ServingEngine as shim_engine
    assert shim_engine is ServingEngine
    assert core_engine is ServingEngine
    for name in ("ServingFrontend", "FrontendOverload", "PlanRouter",
                 "ReplicaSet", "Replica", "MonitorDaemon", "ServingEngine"):
        assert name in serving.__all__ and hasattr(serving, name)


# ---------------------------------------------------------------- replicas
def test_replica_set_shares_aux_state(setup):
    """Placement moves the device tensors (on the snapshot's own device:
    the same tensors) and shares the host state by reference; every
    replica answers as the reference executor does."""
    snap = setup.snap
    rs = ReplicaSet(snap, n_replicas=3)
    assert len(rs) == 3
    assert all(isinstance(m, Replica) and m.device == CPU
               for m in rs.members)      # a CPU snapshot: [cpu], cycled
    for rep in rs.members:
        s = rep.ex.snap
        assert s.gids_np is snap.gids_np
        assert s.valid_np is snap.valid_np
        assert s.rows_np is snap.rows_np
        assert s.tables_np is snap.tables_np
        assert s.store is snap.store
        for f in DEVICE_FIELDS:
            assert getattr(s, f) is getattr(snap, f), f
    own = rs.ownership()
    assert own.shape == (3, snap.K)
    assert (own.sum(axis=0) == 1).all()      # every cluster owned once
    Q = setup.Q[:4]
    want = setup.want.knn(5)
    for rep in rs.members:
        ids, ds = rep.ex.knn_query_batch(Q, 5)
        for j in range(len(Q)):
            _same_knn_row((ids[j], ds[j]), want, j)
    with pytest.raises(ValueError):
        ReplicaSet(snap, n_replicas=0)


def test_snapshot_to_shares_host_state(setup):
    """``LIMSSnapshot.to``: the same tensors on the snapshot's device,
    the filter plane moved with the rows, a store-backed snapshot's one
    ``StoreView`` shared; ``self`` untouched."""
    snap = setup.snap
    moved = snap.to("cpu")
    assert moved is not snap and moved.device == CPU
    for f in DEVICE_FIELDS:
        assert getattr(moved, f).untyped_storage().data_ptr() == \
            getattr(snap, f).untyped_storage().data_ptr(), f
    lp = dataclasses.replace(snap, rows_lp=snap.rows.to(torch.bfloat16),
                             lp_eps=0.5)
    assert lp.to(CPU).rows_lp is lp.rows_lp
    assert lp.to(CPU).lp_eps == 0.5
    paged = LIMSSnapshot.load(setup.path, store=True, cache_pages=8,
                              device=CPU)
    rep = paged.to(CPU)
    assert rep.store is paged.store and rep.rows.shape[1] == 0


def test_rebalance_follows_heat(setup, ref):
    """Greedy makespan: the hottest cluster lands alone on one replica
    when it outweighs the rest combined; owner arrays equal the
    reference's for the same heat."""
    snap = setup.snap
    rs = ReplicaSet(snap, n_replicas=2)
    ref_rs = ref.ReplicaSet(setup.ref_snap, n_replicas=2)
    heat = np.ones(snap.K)
    heat[3] = 100.0
    owner = rs.rebalance(heat)
    assert np.array_equal(owner, ref_rs.rebalance(heat))
    hot = owner[3]
    assert (owner == hot).sum() == 1         # hot cluster isolated
    assert set(owner.tolist()) == {0, 1}
    assert np.array_equal(rs.owner, owner)
    stats = rs.load_stats()
    assert sum(s["owned_clusters"] for s in stats) == snap.K
    assert _no_device(stats) == _no_device(ref_rs.load_stats())
    with pytest.raises(ValueError):
        rs.rebalance(np.ones(snap.K + 1))
    with pytest.raises(ValueError):
        rs.set_ownership(np.full(snap.K, 2))


# ------------------------------------------------------------------- plans
def test_subset_rows_equal_reference(setup, ref):
    """``plan.subset(idx)``: a range subset's mask and routing rows equal
    the reference subset's, and a kNN subset's (re-evaluated on the
    receiving side) its parent's rows; host copies sliced, no device
    arrays, compaction or pins carried, ``built`` unchanged."""
    Q, rs = setup.Q, setup.rs
    idx = np.array([1, 3, 4, 8, 11])
    ex = QueryExecutor(setup.snap)
    ref_ex = ref.Executor(setup.ref_snap)
    plan = ex.planner.plan_range(Q, rs)
    ref_plan = ref_ex.planner.plan_range(Q, rs)
    routing = plan.routing                  # parent's host copy only
    assert np.array_equal(routing, np.asarray(ref_plan.routing))
    plan.compact_slots()
    plan._pins.append(np.arange(3))
    built = ex.planner.built
    other = QueryExecutor(setup.snap)
    sub = plan.subset(idx, planner=other.planner, device="cpu")
    ref_sub = ref_plan.subset(idx)
    assert ex.planner.built == built and other.planner.built == 0
    assert sub.B == len(idx) and sub._planner is other.planner
    assert sub._dev is None and sub._compact is None and sub._pins == []
    # compact_slots materialized the parent's host mask: sliced
    assert np.array_equal(sub._mask_np, plan.mask[idx])
    assert np.array_equal(sub._routing_np, routing[idx])
    assert np.array_equal(sub.radii, rs[idx])
    assert torch.equal(sub.qf, plan.qf[torch.from_numpy(idx)])
    assert np.array_equal(sub.mask, np.asarray(ref_sub.mask))
    assert np.array_equal(sub.routing, np.asarray(ref_sub.routing))
    assert np.array_equal(sub.mask, plan.mask[idx])
    # a kNN plan's seed radii come from f32 pivot distances, which the
    # plain pdist and the reference's Pallas kernel round apart in the
    # last ulp: its subset is held to its own parent's rows
    kplan = ex.planner.plan_knn(Q, 5, 64)
    ksub = kplan.subset(idx)
    assert ksub._mask_np is None and ksub._routing_np is None
    assert ksub.k == 5 and ksub.growth == 2.0 and ksub.max_rounds == 64
    assert np.array_equal(ksub.radii, kplan.radii[idx])
    assert np.array_equal(ksub.mask, kplan.mask[idx])
    assert np.array_equal(ksub.routing, kplan.routing[idx])


# ------------------------------------------------------------------ router
def test_router_bit_identical_and_one_plan(setup):
    """Sub-batched execution across replicas reassembles to exactly the
    reference executor's results, from exactly one plan construction per
    batch (subsetting never re-plans)."""
    snap, Q, rs = setup.snap, setup.Q, setup.rs
    direct = QueryExecutor(snap)
    router = PlanRouter(ReplicaSet(snap, n_replicas=3))
    before = router.routing_ex.planner.built
    got = router.range_query_batch(Q, rs)
    assert router.routing_ex.planner.built == before + 1
    _same_range(got, setup.want.range())
    assert len(got[0][0]) == 0
    for k in (1, 7, N + 50):                 # incl. k > live clamp
        ids_r, ds_r = router.knn_query_batch(Q, k)
        ids_d, ds_d = direct.knn_query_batch(Q, k)
        assert np.array_equal(ids_r, ids_d)
        assert np.array_equal(ds_r, ds_d)
    want = setup.want.knn(7)
    ids_r, ds_r = router.knn_query_batch(Q, 7)
    assert np.array_equal(ids_r, np.asarray(want[0]))
    assert np.array_equal(ds_r, np.asarray(want[1]))
    assert router.routing_ex.planner.built == before + 5
    # replica planners never built a plan; dispatch covered every query
    assert all(m.ex.planner.built == 0
               for m in router.replicas.members[1:])
    assert sum(m.queries for m in router.replicas.members) == 5 * len(Q)
    assert router.routed_heat.sum() > 0
    assert router.load_stats()["routed_heat"][0] >= 0


def test_router_picks_heat_and_rebalance_equal_reference(setup, ref):
    """Over one sequence of batches, with one replica's load charged as
    the dispatch charges it, the router's picks, ``routed_heat`` and
    ``heat_skew`` equal the reference router's, and so do the owner
    arrays ``rebalance()`` folds from them."""
    X, snap = setup.X, setup.snap
    router = PlanRouter(ReplicaSet(snap, n_replicas=3))
    ref_router = ref.Router(ref.ReplicaSet(setup.ref_snap, n_replicas=3))
    owner = np.array([0, 0, 1, 2, 0])[:snap.K]
    router.replicas.set_ownership(owner)
    ref_router.replicas.set_ownership(owner)
    Q2 = _queries(X, 10, seed=23)
    seq = [("range", setup.Q, setup.rs), ("knn", setup.Q, 5),
           ("knn", Q2, 3), ("range", Q2, _radii(X, Q2, sel=0.05))]
    for kind, Q, arg in seq:
        plans = []
        for rt in (router, ref_router):
            pl = rt.routing_ex.planner
            plans.append(pl.plan_range(Q, arg) if kind == "range"
                         else pl.plan_knn(Q, arg, 64))
        picks = [rt._assign(p) for rt, p in zip((router, ref_router), plans)]
        assert np.array_equal(picks[0], np.asarray(picks[1])), kind
        for rt, pick in zip((router, ref_router), picks):
            for rep in rt.replicas.members:
                n = int((np.asarray(pick) == rep.rid).sum())
                if n:
                    rep.record(n)
        assert np.array_equal(router.routed_heat, ref_router.routed_heat)
    assert router.heat_skew() == ref_router.heat_skew()
    got, want = router.load_stats(), ref_router.load_stats()
    assert got["routed_heat"] == want["routed_heat"]
    assert _no_device(got["replicas"]) == _no_device(want["replicas"])
    assert np.array_equal(router.rebalance(), ref_router.rebalance())
    assert np.array_equal(router.replicas.owner, ref_router.replicas.owner)
    assert router.heat_skew() == ref_router.heat_skew()


def test_subbatch_host_syncs_start_at_zero(setup):
    """Each routed sub-batch counts its own host syncs: one replica on
    the caller's thread twice in a row, and three replicas on fresh
    threads, each report the seed readback plus one per round."""
    snap, Q = setup.snap, setup.Q
    one = PlanRouter(ReplicaSet(snap, n_replicas=1))
    seen = []
    for _ in range(2):
        one.knn_query_batch(Q, 5)
        lk = one.routing_ex.last_knn
        seen.append(lk["host_syncs"])
        assert lk["host_syncs"] == 1 + lk["rounds"]
    assert seen[0] == seen[1]
    three = PlanRouter(ReplicaSet(snap, n_replicas=3))
    three.knn_query_batch(Q, 5)
    ran = [m for m in three.replicas.members if m.queries]
    assert len(ran) >= 2
    for m in ran:
        lk = m.ex.last_knn
        assert lk["host_syncs"] == 1 + lk["rounds"]


def test_router_paged_bit_identical(setup):
    """Routing composes with the paged tier: replicas share one
    StoreView/cache, results equal the reference's, pins drain."""
    Q = setup.Q[:8]
    paged = LIMSSnapshot.load(setup.path, store=True, cache_pages=8,
                              device=CPU)
    router = PlanRouter(ReplicaSet(paged, n_replicas=2))
    assert all(m.ex.snap.store is paged.store
               for m in router.replicas.members)
    ids_r, ds_r = router.knn_query_batch(Q, 7)
    for j in range(len(Q)):
        _same_knn_row((ids_r[j], ds_r[j]), setup.want.knn(7), j)
    assert paged.store.cache.pinned == 0
    _same_range(router.range_query_batch(Q, setup.rs[:8]),
                setup.want.range()[:8])
    assert paged.store.cache.pinned == 0
    heat = router.replicas.cluster_heat()
    assert heat is not None and heat.shape == (paged.K,)
    assert heat.sum() > 0                    # cache counters fed back
    router.rebalance()                       # folds heat into ownership


def test_router_replica_error_reaches_caller(setup):
    """An executor failure inside a routed sub-batch re-raises on the
    calling thread, never silently drops queries — on one replica and
    from a replica thread."""
    for n in (1, 3):
        router = PlanRouter(ReplicaSet(setup.snap, n_replicas=n))

        def boom(Q, plan):
            raise RuntimeError("replica died")
        for m in router.replicas.members:
            m.ex.execute_knn = boom
        with pytest.raises(RuntimeError, match="replica died"):
            router.knn_query_batch(setup.Q, 4)


# ---------------------------------------------------------------- frontend
def test_frontend_coalesces_concurrent_submitters(setup):
    """Single-query submitters are coalesced into one kernel batch, with
    results equal to the reference executor's."""
    Q = setup.Q[:6]
    with ServingFrontend(QueryExecutor(setup.snap), max_batch=8,
                         slo_ms=50.0) as f:
        f.pause()
        out = _submit_all(f, [(j, f.knn_query, (Q[j], 5))
                              for j in range(len(Q))])
        m = f.metrics()
        built = f._router_obj.routing_ex.planner.built
    for j in range(len(Q)):
        _same_knn_row(out[j], setup.want.knn(5), j)
    assert m["submitted"] == len(Q)
    assert m["batches"] == 1 == built        # all six in one dispatch
    assert m["batch_size_max"] == len(Q)
    assert m["coalesced_batches"] >= 1
    assert m["shed"] == 0
    assert m["queue_wait_ms_p99"] >= m["queue_wait_ms_p50"] >= 0.0
    assert sum(r["queries"] for r in m["routing"]["replicas"]) == len(Q)


def test_frontend_batches_by_key(setup):
    """Range queries coalesce regardless of radius; kNN batches never
    mix k (k shapes the plan and the outputs)."""
    Q, rs = setup.Q, setup.rs
    with ServingFrontend(QueryExecutor(setup.snap), n_replicas=2,
                         max_batch=8, slo_ms=50.0) as f:
        f.pause()
        calls = [(("r", j), f.range_query, (Q[j], rs[j])) for j in range(4)]
        calls += [(("k3", j), f.knn_query, (Q[j], 3)) for j in range(2)]
        calls += [(("k7", j), f.knn_query, (Q[j], 7)) for j in range(2, 4)]
        out = _submit_all(f, calls)
        m = f.metrics()
    want_r = setup.want.range()
    for j in range(4):
        _same_range([out[("r", j)]], [want_r[j]])
    for j in range(2):
        _same_knn_row(out[("k3", j)], setup.want.knn(3), j)
        _same_knn_row(out[("k7", j + 2)], setup.want.knn(7), j + 2)
    assert m["batches"] == 3                 # range, k=3, k=7 — never mixed
    assert m["coalesced_batches"] == 3
    assert m["batch_size_mean"] > 2.0


def test_frontend_sheds_on_overload(setup):
    """Admission control: a submit that finds the bounded queue full
    fails immediately with FrontendOverload; queued requests still
    complete exactly."""
    Q = setup.Q
    with ServingFrontend(QueryExecutor(setup.snap), max_batch=4,
                         slo_ms=20.0, max_queue=2) as f:
        f.pause()
        results = {}
        threads = [threading.Thread(
            target=lambda j=j: results.update({j: f.knn_query(Q[j], 5)}))
            for j in range(2)]
        for t in threads:
            t.start()
        _wait_pending(f, 2)
        t0 = time.monotonic()
        with pytest.raises(FrontendOverload):
            f.knn_query(Q[2], 5)             # queue full → shed, no queueing
        assert time.monotonic() - t0 < 5.0
        f.resume()
        _join(threads)
        m = f.metrics()
    assert m["shed"] == 1 and m["submitted"] == 2
    assert m["shed_rate"] == pytest.approx(1 / 3, abs=1e-4)
    for j in range(2):
        _same_knn_row(results[j], setup.want.knn(5), j)


def test_frontend_tracks_engine_generation():
    """The frontend rebuilds its replica set when the engine publishes a
    new snapshot generation — batches never mix generations, and queries
    after a refresh see the refreshed index."""
    Xe = gauss_mix(800, D, seed=21)
    ixe = LIMSIndex(MetricSpace(Xe, "l2"), n_clusters=4, m=3, n_rings=8)
    se = ServingEngine(ixe, refresh_every=0, device=CPU)
    with se.frontend(max_batch=4, slo_ms=5.0) as f:
        q = Xe[5]
        ids0, _ = f.knn_query(q, 3)
        r0 = f._router_obj
        assert f._gen == se.generation
        p_new = Xe[5] + 1e-7                 # near-duplicate insert
        gid = se.insert(p_new)
        se.refresh()
        assert se.generation == f._gen + 1
        ids1, ds1 = f.knn_query(q, 3)
        assert f._gen == se.generation
        assert f._router_obj is not r0       # replica set rebuilt
        assert f._router_obj.replicas.snapshot is se.snapshot
        assert gid in ids1                   # new generation is served
        ref_ids, ref_ds = se.executor.knn_query_batch(q[None], 3)
        assert np.array_equal(ids1, ref_ids[0])
        h_ids, h_ds, _ = ixe.knn_query(q, 3)
        assert np.array_equal(ds1, h_ds)
        assert set(map(int, ids1)) == set(map(int, h_ids))
    assert ids0 is not None


def test_frontend_paged_backend(setup):
    """Frontend → router → replicas over the paged tier: equal to the
    reference, pins fully drained after every batch."""
    Q = setup.Q[:5]
    paged = LIMSSnapshot.load(setup.path, store=True, cache_pages=8,
                              device=CPU)
    with ServingFrontend(QueryExecutor(paged), n_replicas=2, max_batch=8,
                         slo_ms=50.0) as f:
        f.pause()
        out = _submit_all(f, [(j, f.knn_query, (Q[j], 7))
                              for j in range(len(Q))])
        m = f.metrics()
    for j in range(len(Q)):
        _same_knn_row(out[j], setup.want.knn(7), j)
    assert m["coalesced_batches"] >= 1
    assert paged.store.cache.pinned == 0


def test_frontend_lifecycle(setup):
    """close() drains and rejects later submits; errors inside a batch
    reach every submitter of that batch."""
    X = setup.X
    f = ServingFrontend(QueryExecutor(setup.snap), max_batch=4, slo_ms=5.0)
    ids, ds = f.knn_query(X[0], 2)
    assert len(ids) == 2
    f.close()
    assert not f._batcher.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        f.knn_query(X[0], 2)
    with pytest.raises(ValueError):
        ServingFrontend(QueryExecutor(setup.snap), max_batch=0)
    with ServingFrontend(QueryExecutor(setup.snap), max_batch=4,
                         slo_ms=50.0) as g:
        g.knn_query(X[0], 2)                 # builds the router
        for m in g._router_obj.replicas.members:
            def boom(Q, plan):
                raise RuntimeError("kernel failed")
            m.ex.execute_knn = boom
        g.pause()
        errs = {}

        def submit(j):
            try:
                g.knn_query(X[j], 2)
            except RuntimeError as e:
                errs[j] = str(e)
        threads = [threading.Thread(target=submit, args=(j,))
                   for j in range(3)]
        for t in threads:
            t.start()
        _wait_pending(g, 3)
        g.resume()
        _join(threads)
    assert errs == {j: "kernel failed" for j in range(3)}


# ------------------------------------------------------- the launch counter
class _YieldingCounts(dict):
    """A launch table whose reads give up the GIL, so that an increment
    that is not under a lock interleaves with the other threads'."""

    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        time.sleep(0)
        return value


def test_launch_counter_is_atomic_under_threads(monkeypatch):
    """Threads launching through ``_cuda.launch`` at once lose no count
    (the router launches from one thread per replica).  The kernel table
    and the device queries are stubbed, so the counting path runs here
    as it does on the card."""
    monkeypatch.setattr(_cuda, "_FUNCS",
                        {("pdist", None): lambda *a: 0})
    monkeypatch.setattr(_cuda, "current_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_cuda, "LAUNCHES", _YieldingCounts(_cuda.LAUNCHES))
    card = torch.device("cuda", 0)
    threads_n, per = (os.cpu_count() or 4) + 4, 1000   # more than cores
    _cuda.reset_launches()
    start = threading.Barrier(threads_n)

    def work():
        start.wait()
        for _ in range(per):
            _cuda.launch("pdist", 1, 2, device=card)
    threads = [threading.Thread(target=work) for _ in range(threads_n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        _join(threads, timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
    assert _cuda.LAUNCHES["pdist"] == threads_n * per


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_frontend_on_card_equals_cpu():
    """A 2-replica frontend on the card (replicas on ``cuda:0``, or on
    the cards in turn where there are several) answers as the CPU port
    does, ids and f64 distances, with each query-path kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    X = gauss_mix(N, D, seed=13)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=5, m=3, n_rings=8)
    card = LIMSSnapshot.build(ix, device="cuda")
    cpu = QueryExecutor(LIMSSnapshot.build(ix, device=CPU))
    Q = _queries(X, 24, seed=5)
    rs = _radii(X, Q)
    want_r = cpu.range_query_batch(Q, rs)
    want_k = cpu.knn_query_batch(Q, 7)
    _cuda.reset_launches()
    with ServingFrontend(QueryExecutor(card), n_replicas=2, max_batch=32,
                         slo_ms=50.0) as f:
        f.pause()
        calls = [(("r", j), f.range_query, (Q[j], rs[j]))
                 for j in range(len(Q))]
        calls += [(("k", j), f.knn_query, (Q[j], 7)) for j in range(len(Q))]
        out = _submit_all(f, calls)
        devices = [m.device for m in f._router_obj.replicas.members]
    torch.cuda.synchronize()
    assert all(d.type == "cuda" for d in devices)
    for j in range(len(Q)):
        _same_range([out[("r", j)]], [want_r[j]])
        _same_knn_row(out[("k", j)], want_k, j)
    for name in ("pdist", "range_filter", "pdist_rankeval"):
        assert _cuda.LAUNCHES[name] > 0, name
