"""The port's serving engine (``repro_torch.serving.ServingEngine``)
against the reference's, on the CPU.

Twins of ``tests/test_serving.py``'s five engine tests (update-then-
snapshot consistency, auto refresh at the threshold, the atomic swap for
in-flight batches, async refresh, incremental deletes), run with
``device="cpu"`` so every snapshot generation goes through the kernels'
plain versions.  Then: one seeded sequence of inserts, deletes, a
retrain and refreshes replayed on a reference ``repro.serving.
ServingEngine`` and on the port's, with every batch after each refresh
identical (ids and f64 distances, ``atol=0``) and ``generation`` /
``pending_mutations`` equal after every step; an async refresh under a
concurrent query thread (bounded joins); the memory contract of the
swap (a dropped generation is freed by reference counting alone); and
the ``NotImplementedError`` of each part that waits for its slice.
"""
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from repro.core import LIMSIndex as RefIndex
from repro.core import MetricSpace as RefSpace
from repro.serving import ServingEngine as RefEngine
from repro_torch.core import LIMSIndex, MetricSpace, make_executor
from repro_torch.core.batched import BatchedLIMS
from repro_torch.core.metrics import dist_one_to_many
from repro_torch.core.serving import ServingEngine
from repro_torch.data.datasets import gauss_mix

D = 6
CPU = "cpu"


def _index(n, seed, K, m=3, rings=8):
    X = gauss_mix(n, D, seed=seed)
    return X, LIMSIndex(MetricSpace(X, "l2"), n_clusters=K, m=m,
                        n_rings=rings)


def _radii(X, Q, sel=0.02):
    return np.array([float(np.quantile(dist_one_to_many(q, X, "l2"), sel))
                     for q in Q])


def _ids(hits) -> set:
    return set(map(int, hits[0]))


# ------------------------------------------------- twins of test_serving.py
def test_update_then_snapshot_consistency():
    """insert/delete/retrain_cluster on the host index, rebuild via
    refresh(), and batch results stay identical to the host — tombstoned
    rows excluded, buffer rows included."""
    rng = np.random.default_rng(0)
    X, ix = _index(1400, 5, K=5, rings=10)
    se = ServingEngine(ix, refresh_every=0, device=CPU)  # manual refresh
    new_rows = X[rng.choice(1400, 20)] + rng.normal(0, 0.02, (20, D))
    gids = [se.insert(r) for r in new_rows]
    assert se.delete(X[3]) == 1                 # stored row → tombstone
    assert se.delete(new_rows[0]) == 1          # buffered row → tombstone
    se.retrain_cluster(0)                       # fold cluster 0's buffer in
    assert ix.last_retrain_backend == "host"    # auto, a small cluster
    se.refresh()
    Q = np.concatenate([new_rows[:4], X[rng.choice(1400, 4)]]) \
        + rng.normal(0, 0.003, (8, D))
    rs = _radii(X, Q)
    for (ids, ds), q, r in zip(se.range_query_batch(Q, rs), Q, rs):
        h_ids, h_ds, _ = ix.range_query(q, r)
        assert set(map(int, ids)) == set(map(int, h_ids))
        np.testing.assert_allclose(np.sort(ds), np.sort(h_ds), atol=0)
    ids, ds = se.knn_query_batch(Q, 5)
    for b, q in enumerate(Q):
        h_ids, h_ds, _ = ix.knn_query(q, 5)
        np.testing.assert_allclose(np.sort(ds[b]), np.sort(h_ds), atol=0)
    assert gids[1] in _ids(se.range_query(new_rows[1], 1e-9))
    assert gids[0] not in _ids(se.range_query(new_rows[0], 1e-9))


def test_auto_refresh_after_threshold():
    X, ix = _index(900, 9, K=4)
    se = ServingEngine(ix, refresh_every=6, device=CPU)
    rng = np.random.default_rng(1)
    rows = X[rng.choice(900, 6)] + rng.normal(0, 0.02, (6, D))
    for r in rows[:5]:
        se.insert(r)
    assert se.generation == 0 and se.pending_mutations == 5
    gid = se.insert(rows[5])                    # 6th mutation → refresh
    assert se.generation == 1 and se.pending_mutations == 0
    assert gid in _ids(se.range_query(rows[5], 1e-9))


def test_swap_is_atomic_for_inflight_batches():
    """A batch that grabbed the active executor keeps its snapshot across
    a refresh; new batches see the new generation."""
    X, ix = _index(900, 3, K=4)
    se = ServingEngine(ix, refresh_every=0, device=CPU)
    old_exec = se.executor
    old_snap = se.snapshot
    gid = se.insert(X[11] + 0.5)
    se.refresh()
    assert se.executor is not old_exec          # swapped
    assert se._standby is old_exec              # double-buffered pair
    assert gid not in _ids(old_exec.range_query(X[11] + 0.5, 1e-9))
    assert old_exec.snap is old_snap
    assert gid in _ids(se.range_query(X[11] + 0.5, 1e-9))


def test_async_refresh_lands():
    X, ix = _index(700, 13, K=4)
    se = ServingEngine(ix, refresh_every=3, async_refresh=True, device=CPU)
    rng = np.random.default_rng(2)
    rows = X[rng.choice(700, 3)] + rng.normal(0, 0.02, (3, D))
    gids = [se.insert(r) for r in rows]
    se.wait_refresh()
    assert se.generation >= 1
    assert gids[-1] in _ids(se.range_query(rows[-1], 1e-9))


def test_delete_keeps_live_mask_incremental():
    """The live mask mirrors tombstones∩store without isin rescans,
    extents shrink to the surviving rows, and deleted rows are gone from
    the host index, a device snapshot and a refreshed engine."""
    X, ix = _index(600, 21, K=3)
    se = ServingEngine(ix, refresh_every=0, device=CPU)
    before = {ci.cid: ci.live_mask.sum() for ci in ix.clusters}
    victims = [4, 99, 250]
    for v in victims:
        assert se.delete(X[v]) == 1
    assert se.pending_mutations == len(victims)
    after = {ci.cid: ci.live_mask.sum() for ci in ix.clusters}
    assert sum(before.values()) - sum(after.values()) == len(victims)
    for ci in ix.clusters:
        dead_here = [g for g in victims if g in set(ci.store_ids.tolist())]
        for g in dead_here:
            assert not ci.live_mask[np.where(ci.store_ids == g)[0][0]]
        if ci.live_mask.any():
            pd = ci.pivot_d_stored[ci.live_mask]
            np.testing.assert_allclose(ci.mapping.dist_min, pd.min(axis=0))
            np.testing.assert_allclose(ci.mapping.dist_max, pd.max(axis=0))
    se.refresh()
    bx = BatchedLIMS(ix, device=CPU)
    for v in victims:
        assert v not in _ids(ix.range_query(X[v], 1e-9))
        assert v not in _ids(bx.range_query(X[v], 1e-9))
        assert v not in _ids(se.range_query(X[v], 1e-9))


# ------------------------------------------- replayed against the reference
N_REPLAY = 1400


def _replay_steps(X, rng):
    """A seeded sequence of engine operations: ("insert", row),
    ("delete", row) of stored and of buffered rows, one
    ("retrain", cluster) and explicit ("refresh", None)."""
    steps = []
    for rnd in range(3):
        rows = X[rng.choice(N_REPLAY, 9)] + rng.normal(0, 0.01, (9, D))
        steps += [("insert", r) for r in rows]
        steps += [("delete", X[int(g)])
                  for g in rng.choice(N_REPLAY, 3, replace=False)]
        steps.append(("delete", rows[0]))            # a buffered row
        if rnd == 1:
            steps.append(("retrain", 2))
        steps.append(("refresh", None))
    return steps


def test_replayed_sequence_equals_reference():
    """The same seeded sequence on the reference engine and the port's:
    every batch after each refresh identical (ids and f64 distances,
    atol=0), generation and pending_mutations equal after every step."""
    X = gauss_mix(N_REPLAY, D, seed=17)
    kw = dict(n_clusters=5, m=3, n_rings=10)
    ref = RefEngine(RefIndex(RefSpace(X, "l2"), **kw), refresh_every=7)
    port = ServingEngine(LIMSIndex(MetricSpace(X, "l2"), **kw),
                         refresh_every=7, device=CPU)
    rng = np.random.default_rng(23)
    Q = X[rng.choice(N_REPLAY, 6)] + rng.normal(0, 0.004, (6, D))
    rs = _radii(X, Q)
    gen = -1
    compared = 0
    for op, arg in _replay_steps(X, np.random.default_rng(29)):
        if op == "insert":
            assert port.insert(arg) == ref.insert(arg)
        elif op == "delete":
            assert port.delete(arg) == ref.delete(arg)
        elif op == "retrain":
            port.retrain_cluster(arg)
            ref.retrain_cluster(arg)
            assert port.index.last_retrain_backend == \
                ref.index.last_retrain_backend == "host"
        else:
            port.refresh()
            ref.refresh()
        assert port.generation == ref.generation
        assert port.pending_mutations == ref.pending_mutations
        if port.generation != gen:
            gen = port.generation
            for (pi, pd), (ri, rd) in zip(port.range_query_batch(Q, rs),
                                          ref.range_query_batch(Q, rs)):
                assert np.array_equal(pi, ri)
                np.testing.assert_allclose(pd, rd, rtol=0, atol=0)
            pi, pd = port.knn_query_batch(Q, 7)
            ri, rd = ref.knn_query_batch(Q, 7)
            assert np.array_equal(pi, ri)
            np.testing.assert_allclose(pd, rd, rtol=0, atol=0)
            compared += 1
    assert gen >= 5 and compared == gen + 1


# ------------------------------------------------------ concurrency, memory
def test_async_refresh_under_concurrent_queries():
    """A query thread serves batches while the main thread mutates with
    async refresh on: each batch grabs ``engine.executor`` once and must
    equal an f64 brute-force scan over that executor's snapshot's live
    rows; every requested refresh lands.  Joins are bounded."""
    X, ix = _index(900, 31, K=4)
    se = ServingEngine(ix, refresh_every=4, async_refresh=True, device=CPU)
    rng = np.random.default_rng(3)
    Q = X[rng.choice(900, 4)] + rng.normal(0, 0.004, (4, D))
    stop = threading.Event()
    errors, served = [], []

    def queries():
        try:
            while not stop.is_set() or len(served) < 4:
                ex = se.executor
                s = ex.snap
                live = np.nonzero(s.valid_np)[0]
                rows, gids = s.rows_np[live], s.gids_np[live]
                for b, (ids, ds) in enumerate(ex.range_query_batch(Q, 0.1)):
                    dist = dist_one_to_many(Q[b], rows, "l2")
                    hit = dist <= 0.1
                    assert set(map(int, ids)) == set(map(int, gids[hit]))
                k_ids, k_ds = ex.knn_query_batch(Q, 5)
                for b in range(len(Q)):
                    dist = dist_one_to_many(Q[b], rows, "l2")
                    np.testing.assert_allclose(
                        k_ds[b], np.sort(dist)[:5], rtol=0, atol=0)
                served.append(s)
        except BaseException as e:          # reported on the main thread
            errors.append(e)

    t = threading.Thread(target=queries)
    t.start()
    try:
        rows = X[rng.choice(900, 16)] + rng.normal(0, 0.02, (16, D))
        for i, r in enumerate(rows):
            se.insert(r)
            if i % 3 == 0:
                se.delete(X[int(rng.integers(900))])
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive()
    assert not errors, errors[0]
    worker = se._refresh_thread
    se.wait_refresh()
    if worker is not None:
        worker.join(timeout=60)
        assert not worker.is_alive()
    assert se.generation >= 1 and se.pending_mutations < 4
    assert served


def test_failed_async_refresh_surfaces(monkeypatch):
    """A background refresh that raises does not leave wait_refresh
    waiting forever: it raises, and the last published snapshot keeps
    serving."""
    X, ix = _index(600, 37, K=3)
    se = ServingEngine(ix, refresh_every=1, async_refresh=True, device=CPU)
    before = se.executor

    def broken():
        raise MemoryError("no room for a new generation")

    monkeypatch.setattr(se, "_build_executor", broken)
    se.insert(X[0] + 0.01)
    with pytest.raises(RuntimeError, match="background refresh"):
        se.wait_refresh()
    se.wait_refresh()                           # the error is reported once
    assert se.executor is before and se.generation == 0


def test_dropped_generation_is_freed_without_the_cycle_collector():
    """An executor holds no reference cycle (its planner and backend hold
    it weakly), so the generation a swap drops is freed by reference
    counting alone: with the cycle collector off, generation 0's
    snapshot is gone after two swaps."""
    X, ix = _index(600, 41, K=3)
    se = ServingEngine(ix, refresh_every=0, device=CPU)
    se.range_query(X[0], 0.05)
    se.knn_query(X[0], 3)
    first = weakref.ref(se.snapshot)
    gc.disable()
    try:
        se.refresh()
        assert first() is not None              # standby keeps it
        se.refresh()
        assert first() is None
    finally:
        gc.enable()


# ------------------------------------------------------------- not ported
def test_later_slices_raise(monkeypatch):
    X, ix = _index(600, 43, K=3)
    with pytest.raises(NotImplementedError, match="A7"):
        ServingEngine(ix, storage="paged", device=CPU)
    monkeypatch.setenv("REPRO_STORAGE", "paged")
    with pytest.raises(NotImplementedError, match="A7"):
        ServingEngine(ix, device=CPU)
    monkeypatch.setenv("REPRO_STORAGE", "")
    with pytest.raises(NotImplementedError, match="A9"):
        ServingEngine(ix, sharded=True, device=CPU)
    with pytest.raises(NotImplementedError, match="A9"):
        ServingEngine(ix, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="A7"):
        ServingEngine.from_spill("/nonexistent")
    se = ServingEngine(ix, device=CPU)
    with pytest.raises(NotImplementedError, match="A7"):
        se.compact()
    with pytest.raises(NotImplementedError, match="A10"):
        se.frontend()
    with pytest.raises(NotImplementedError, match="A9"):
        make_executor(se.snapshot, sharded=True)
    assert make_executor(se.snapshot).snap is se.snapshot


def test_engine_defaults_to_the_card():
    """No fallback hides the card: without ``device`` the engine builds
    on ``cuda`` and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device works")
    X, ix = _index(600, 47, K=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(ix)


def test_attach_index_serves_the_next_refresh():
    X, ix = _index(600, 53, K=3)
    se = ServingEngine(ix, refresh_every=0, device=CPU)
    X2, ix2 = _index(500, 59, K=3)
    se.attach_index(ix2)
    assert se.index is ix2
    se.refresh()
    assert se.snapshot.live == 500 and se.generation == 1
    se.attach_index(None)
    with pytest.raises(RuntimeError, match="no host index"):
        se.refresh()
