"""The port's paged storage tier against the reference's, on the CPU.

Twin of ``tests/test_storage.py``: the port runs with ``device="cpu"``
(each kernel's plain version); the reference runs its Pallas kernels in
interpret mode.  Each test holds the port to the reference on the same
seeded data: layout math and scheduler plans, the spill format (an
atomic publish, a ``pages.bin`` byte-identical to the reference's,
equal metadata arrays, stores of either package served by the other),
store-backed range/kNN results bit-identical to the resident path, to
the host index and to the reference, the IO counters (``last_io``,
``CacheStats``, the ``storage.*`` obs counters, ``QueryProfile``'s
paged fields, ``host_syncs``) equal to the reference's at a squeezed
cache, LRU and pin semantics, serving writeback with extent reuse,
in-flight executors across writebacks and compactions, cold start,
async prefetch and its shutdown, and ``drop_os_cache``.
"""
import os

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.core import LIMSIndex as RefIndex
from repro.core import MetricSpace as RefSpace
from repro.core import ServingEngine as RefEngine
from repro.core.executor import QueryExecutor as RefExecutor
from repro.core.snapshot import LIMSSnapshot as RefSnapshot
from repro.storage import LRUPageCache as RefLRU
from repro.storage import PageLayout as RefLayout
from repro.storage import plan_batch as ref_plan_batch
from repro.storage import rows_per_page as ref_rows_per_page
from repro_torch import obs
from repro_torch.convert import FIELDS, snapshot_from_reference
from repro_torch.core import LIMSIndex, MetricSpace, ServingEngine
from repro_torch.core.executor import QueryExecutor
from repro_torch.core.metrics import dist_one_to_many
from repro_torch.core.snapshot import DEVICE_FIELDS, LIMSSnapshot
from repro_torch.data.datasets import gauss_mix
from repro_torch.storage import (LRUPageCache, Manifest, PageLayout,
                                 PagedStore, load_meta, page_runs,
                                 plan_batch, rows_per_page)

N, D = 1600, 6
CPU = "cpu"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's fixture, in both packages: the port's index and
    snapshot spilled to ``path``, the reference's to ``ref_path``."""
    X = gauss_mix(N, D, seed=7)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
    snap = LIMSSnapshot.build(ix, device=CPU)
    path = str(tmp_path_factory.mktemp("store"))
    snap.spill(path)
    ref_ix = RefIndex(RefSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
    ref_snap = RefSnapshot.build(ref_ix)
    ref_path = str(tmp_path_factory.mktemp("ref_store"))
    ref_snap.spill(ref_path)
    return {"X": X, "ix": ix, "snap": snap, "path": path,
            "ref_ix": ref_ix, "ref_snap": ref_snap, "ref_path": ref_path}


def _queries(X, n_q, seed=2, scale=0.004):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n_q)] + rng.normal(0, scale, (n_q, D))


def _radii(X, Q, sel=0.02):
    return np.array([float(np.quantile(dist_one_to_many(q, X, "l2"), sel))
                     for q in Q])


def _load(path, **kw):
    return LIMSSnapshot.load(path, device=CPU, **kw)


def _same_range(a, b):
    assert len(a) == len(b)
    for (ai, ad), (bi, bd) in zip(a, b):
        assert np.array_equal(ai, bi) and np.array_equal(ad, bd)


def _same_knn(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _host_range(ix, got, Q, rs):
    for (ids, ds), q, r in zip(got, Q, rs):
        h_ids, h_ds, _ = ix.range_query(q, r)
        assert set(map(int, ids)) == set(map(int, h_ids))
        np.testing.assert_allclose(np.sort(ds), np.sort(h_ds), atol=0)


def _assert_snapshots_equal(a: LIMSSnapshot, b: LIMSSnapshot):
    for f in DEVICE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x.numpy(), y.numpy()), f
    assert (a.K, a.m, a.n_rings, a.n_max, a.live) == \
        (b.K, b.m, b.n_rings, b.n_max, b.live)
    assert np.array_equal(a.gids_np, b.gids_np)
    assert np.array_equal(a.rows_np, b.rows_np)
    assert np.array_equal(a.valid_np, b.valid_np)
    for f in vars(a.tables_np):
        assert np.array_equal(getattr(a.tables_np, f),
                              getattr(b.tables_np, f)), f


# ----------------------------------------------------------- layout/plan
def test_layout_math_and_alignment():
    rpp = rows_per_page(4096, 8)            # 64 f64 records of d=8
    assert rpp == 64
    assert rows_per_page(65536, 8) == 1024  # > 128 rows → 128-aligned
    assert rows_per_page(65536, 7) % 128 == 0
    for pb in (64, 512, 4096, 65536, 1 << 20):
        for d in (1, 6, 7, 8, 128):
            assert rows_per_page(pb, d) == ref_rows_per_page(pb, d)
    lay = PageLayout(page_bytes=512, rows_per_page=8, d=8, n_max=20,
                     extents=(0, 3, 10))
    ref = RefLayout(page_bytes=512, rows_per_page=8, d=8, n_max=20,
                    extents=(0, 3, 10))
    assert lay.pages_per_cluster == ref.pages_per_cluster == 3
    # slot 0 of cluster 1 starts at its extent; slot 19 is in its 3rd page
    slots = np.array([20, 39, 45])
    pages, offs = lay.slot_locations(slots)
    assert pages.tolist() == [3, 5, 10] and offs.tolist() == [0, 3, 5]
    rp, ro = ref.slot_locations(slots)
    assert np.array_equal(pages, rp) and np.array_equal(offs, ro)
    assert lay.cluster_file_rows(2) == ref.cluster_file_rows(2)
    assert lay.page_stride_bytes == ref.page_stride_bytes


def test_scheduler_dedupes_and_coalesces():
    lay = PageLayout(page_bytes=512, rows_per_page=8, d=8, n_max=16,
                     extents=(0, 2))
    cand = np.zeros((2, 32), bool)
    cand[0, [0, 1, 9]] = True          # cluster 0, pages 0 and 1
    cand[1, [1, 16, 31]] = True        # shares page 0; cluster 1 pages 2+3
    plan = plan_batch(cand, lay)
    assert plan.pages.tolist() == [0, 1, 2, 3]      # deduped across queries
    assert plan.runs == ((0, 4),)                   # coalesced to one run
    assert plan.pages_per_query.tolist() == [2, 3]
    assert plan.cand_per_query.tolist() == [3, 3]
    assert page_runs(np.array([0, 1, 5, 7, 8])) == ((0, 2), (5, 6), (7, 9))
    # random masks over a sparse layout: the port's plans are the
    # reference's, with and without an exclusion mask
    rng = np.random.default_rng(0)
    ext = (0, 9, 30, 31 + 4)
    lay = PageLayout(page_bytes=256, rows_per_page=4, d=8, n_max=13,
                     extents=ext)
    ref = RefLayout(page_bytes=256, rows_per_page=4, d=8, n_max=13,
                    extents=ext)
    for _ in range(5):
        cand = rng.random((7, 52)) < 0.15
        excl = rng.random(52) < 0.3
        for kw in ({}, {"per_query": False}, {"exclude": excl}):
            a, b = plan_batch(cand, lay, **kw), ref_plan_batch(cand, ref,
                                                               **kw)
            assert a.summary() == b.summary()
            assert np.array_equal(a.slots, b.slots)
            assert np.array_equal(a.pages, b.pages) and a.runs == b.runs


# ------------------------------------------------------------- round trip
def test_spill_load_resident_roundtrip(setup):
    loaded = _load(setup["path"])
    assert loaded.store is None
    _assert_snapshots_equal(setup["snap"], loaded)


def test_spill_is_atomic_no_temp_litter(setup):
    for path in (setup["path"], setup["ref_path"]):
        assert Manifest.exists(path)
        assert not [f for f in os.listdir(path) if ".tmp" in f]
    # the two packages publish the same manifest for the same corpus
    a, b = Manifest.load(setup["path"]), Manifest.load(setup["ref_path"])
    assert vars(a) == vars(b)


def test_store_backed_results_bit_identical(setup):
    """Range and kNN through the paged store equal the in-memory
    executor and the reference's store-backed executor bit for bit; a
    store-backed snapshot holds no row on the device."""
    X, snap = setup["X"], setup["snap"]
    mem = QueryExecutor(snap)
    st = QueryExecutor(_load(setup["path"], store=True))
    ref = RefExecutor(RefSnapshot.load(setup["ref_path"], store=True))
    assert st.snap.store is not None
    assert tuple(st.snap.rows.shape) == (snap.K, 0, D)
    assert st.snap.device_nbytes() == \
        snap.device_nbytes() - snap.rows.nbytes
    Q = _queries(X, 8, seed=3)
    rs = _radii(X, Q)
    rs[0] = 1e-12                               # provably empty query
    a = mem.range_query_batch(Q, rs)
    b = st.range_query_batch(Q, rs)
    assert len(b[0][0]) == 0
    _same_range(a, b)
    _same_range(b, ref.range_query_batch(Q, rs))
    for k in (6, N + 99):   # k > live clamps identically (and terminates)
        ka, kb = mem.knn_query_batch(Q[:4], k), st.knn_query_batch(Q[:4], k)
        assert kb[0].shape == (4, min(k, N))
        _same_knn(ka, kb)
        _same_knn(kb, ref.knn_query_batch(Q[:4], k))
    assert st.last_knn["driver"] == "paged"


def test_store_reports_page_and_candidate_counts(setup):
    X = setup["X"]
    ex = QueryExecutor(_load(setup["path"], store=True))
    ref = RefExecutor(RefSnapshot.load(setup["ref_path"], store=True))
    Q = _queries(X, 5, seed=9)
    rs = _radii(X, Q)
    ex.range_query_batch(Q, rs)
    ref.range_query_batch(Q, rs)
    stats = ex.snap.store.stats.snapshot()
    assert stats == ref.snap.store.stats.snapshot()
    assert stats["queries"] == 5
    assert stats["pages_per_query"] > 0
    assert stats["candidates_per_query"] > 0
    assert stats["requests"] == stats["hits"] + stats["misses"]
    # a single batch on a cold cache is all misses: the gather behind a
    # planned fetch must not re-count resident pages as hits
    assert stats["hits"] == 0 and stats["misses"] == stats["requests"]
    io = ex.last_io
    assert io == ref.last_io
    assert io["pages"] <= ex.snap.store.manifest.total_pages
    assert len(io["pages_per_query"]) == 5
    # candidate pages are a fraction of the corpus: batch union strictly
    # under a scan
    assert io["pages"] < ex.snap.store.manifest.total_pages


def test_lru_eviction_stays_exact(setup):
    """A 4-page cache thrashes constantly; results must not change, the
    counters stay consistent and equal to the reference's."""
    X = setup["X"]
    tiny = QueryExecutor(_load(setup["path"], store=True, cache_pages=4))
    ref = RefExecutor(RefSnapshot.load(setup["ref_path"], store=True,
                                       cache_pages=4))
    mem = QueryExecutor(setup["snap"])
    Q = _queries(X, 6, seed=11)
    rs = _radii(X, Q)
    b = tiny.range_query_batch(Q, rs)
    _same_range(mem.range_query_batch(Q, rs), b)
    _same_range(b, ref.range_query_batch(Q, rs))
    st = tiny.snap.store
    assert len(st.cache) <= 4
    assert st.stats.evictions > 0
    assert st.stats.requests == st.stats.hits + st.stats.misses
    assert st.stats.snapshot() == ref.snap.store.stats.snapshot()


# ------------------------------------------------ state across packages
def test_reference_spill_serves_in_port(setup):
    """A store the reference spilled loads in the port, store-backed and
    resident, and serves the reference's results."""
    X = setup["X"]
    ref_path = setup["ref_path"]
    ref = RefExecutor(setup["ref_snap"])
    Q = _queries(X, 6, seed=19)
    rs = _radii(X, Q)
    want_r = ref.range_query_batch(Q, rs)
    want_k = ref.knn_query_batch(Q, 7)
    resident = _load(ref_path)
    assert resident.store is None
    for f in ("rows_np", "gids_np", "valid_np"):
        assert np.array_equal(getattr(resident, f),
                              getattr(setup["ref_snap"], f)), f
    for f in DEVICE_FIELDS:
        assert np.array_equal(getattr(resident, f).numpy(),
                              np.asarray(getattr(setup["ref_snap"], f))), f
    for snap in (resident, _load(ref_path, store=True)):
        ex = QueryExecutor(snap)
        _same_range(ex.range_query_batch(Q, rs), want_r)
        _same_knn(ex.knn_query_batch(Q, 7), want_k)


def test_port_spill_of_carried_snapshot_is_byte_identical(setup,
                                                          tmp_path):
    """The port's spill of a snapshot carried over from the reference
    writes the reference's ``pages.bin`` byte for byte, equal metadata
    arrays and an equal manifest; and the reference serves it."""
    ref_snap = setup["ref_snap"]
    carried = snapshot_from_reference(
        {f: np.asarray(getattr(ref_snap, f)) for f in FIELDS}, CPU)
    path = str(tmp_path / "carried")
    carried.spill(path)
    with open(os.path.join(path, "pages.bin"), "rb") as f:
        ours = f.read()
    with open(os.path.join(setup["ref_path"], "pages.bin"), "rb") as f:
        theirs = f.read()
    assert ours == theirs and len(ours) > 0
    meta, man = load_meta(path)
    ref_meta, ref_man = load_meta(setup["ref_path"])
    assert sorted(meta) == sorted(ref_meta)
    for k in meta:
        assert meta[k].dtype == ref_meta[k].dtype, k
        assert np.array_equal(meta[k], ref_meta[k]), k
    assert vars(man) == vars(ref_man)
    X = setup["X"]
    Q = _queries(X, 4, seed=37)
    _same_knn(RefExecutor(RefSnapshot.load(path, store=True))
              .knn_query_batch(Q, 5),
              RefExecutor(ref_snap).knn_query_batch(Q, 5))


def _storage_counters(registry) -> dict:
    return {m.name: m.value for m in registry.metrics()
            if m.name.startswith("storage.") and m.kind == "counter"}


@pytest.mark.parametrize("cache_pages", [1, 3, 4096])
@pytest.mark.parametrize("kind", ["range", "knn"])
def test_io_counters_equal_reference(setup, kind, cache_pages):
    """On one store (the reference's spill) at one cache capacity, the
    port's ``last_io``, ``CacheStats``, ``storage.*`` counters and the
    profile's paged fields and ``host_syncs`` equal the reference's over
    the same batches — also with the cache squeezed below a batch's
    pinned working set, where the pins overflow the cache (at 1 and 3
    pages: both caches grow past capacity to the same peak, every
    resident page pinned)."""
    X = setup["X"]
    obs.configure("on")
    ref_obs.configure("on")
    ex = QueryExecutor(_load(setup["ref_path"], store=True,
                             cache_pages=cache_pages), prefetch="off")
    ref = RefExecutor(RefSnapshot.load(setup["ref_path"], store=True,
                                       cache_pages=cache_pages),
                      prefetch="off")
    peaks = []
    for cache in (ex.snap.store.cache, ref.snap.store.cache):
        peak = [0]

        def put(pid, block, cache=cache, peak=peak, real=cache.put):
            out = real(pid, block)
            peak[0] = max(peak[0], len(cache))
            return out

        cache.put = put
        peaks.append(peak)
    before = (_storage_counters(obs.REGISTRY),
              _storage_counters(ref_obs.REGISTRY))
    for seed in (5, 6):
        Q = _queries(X, 8, seed=seed)
        if kind == "range":
            _same_range(ex.range_query_batch(Q, _radii(X, Q)),
                        ref.range_query_batch(Q, _radii(X, Q)))
        else:
            _same_knn(ex.knn_query_batch(Q, 9), ref.knn_query_batch(Q, 9))
            assert ex.last_knn == ref.last_knn
        assert ex.last_io == ref.last_io
        p, rp = ex.last_profile, ref.last_profile
        for f in ("storage", "backend", "driver", "pages",
                  "pages_per_query", "host_syncs", "rounds",
                  "candidates_per_query", "clusters_per_query"):
            assert getattr(p, f) == getattr(rp, f), f
        assert p.storage == "paged"
    assert ex.snap.store.stats.snapshot() == ref.snap.store.stats.snapshot()
    after = (_storage_counters(obs.REGISTRY),
             _storage_counters(ref_obs.REGISTRY))
    ours = {k: v - before[0].get(k, 0) for k, v in after[0].items()}
    theirs = {k: v - before[1].get(k, 0) for k, v in after[1].items()}
    assert {k for k, v in ours.items() if v} == \
        {k for k, v in theirs.items() if v}
    for k, v in ours.items():
        assert v == theirs.get(k, 0), k
    assert ours["storage.page_reads"] > 0
    assert peaks[0] == peaks[1]
    assert (peaks[0][0] > cache_pages) == (cache_pages < 4096)


# ----------------------------------------------------- serving + writeback
def test_serving_paged_writeback_and_extent_reuse(tmp_path):
    """A refresh after updates publishes a new generation atomically;
    clusters whose row bytes are unchanged keep their extents, dirty
    ones append new pages — the same manifests as the reference's engine
    on the same sequence."""
    X = gauss_mix(1200, D, seed=5)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=5, m=3, n_rings=10)
    ref_ix = RefIndex(RefSpace(X, "l2"), n_clusters=5, m=3, n_rings=10)
    path, ref_path = str(tmp_path / "store"), str(tmp_path / "ref")
    se = ServingEngine(ix, refresh_every=0, storage="paged",
                       storage_path=path, device=CPU)
    rse = RefEngine(ref_ix, refresh_every=0, storage="paged",
                    storage_path=ref_path)
    man0 = Manifest.load(path)
    assert se.executor.snap.store is not None
    # a delete only flips validity (metadata): row bytes unchanged
    # everywhere → every extent reused.  Target the smallest cluster so
    # the later retrain can't shrink the global n_max (full rewrite).
    victim = int(np.argmin([ci.n for ci in ix.clusters]))
    dead = int(ix.clusters[victim].store_ids[0])
    for eng in (se, rse):
        assert eng.delete(X[dead]) == 1
        eng.refresh()
    man1 = Manifest.load(path)
    assert man1.generation == man0.generation + 1
    assert man1.extents == man0.extents
    assert man1.total_pages == man0.total_pages
    # retrain the dirtied cluster: it drops the tombstone, so its rows
    # change — exactly its extent is rewritten (appended)
    for eng in (se, rse):
        eng.retrain_cluster(victim)     # refresh_every=0 gates auto-refresh
        eng.refresh()                   # → trigger manually
    man2 = Manifest.load(path)
    assert man2.generation > man1.generation
    assert man2.n_max == man1.n_max     # smallest cluster can't set n_max
    changed = [k for k in range(man2.K)
               if man2.extents[k] != man1.extents[k]]
    assert changed == [victim]
    assert man2.total_pages > man1.total_pages
    ref_man = Manifest.load(ref_path)
    assert (man2.extents, man2.total_pages, man2.cluster_sha1) == \
        (ref_man.extents, ref_man.total_pages, ref_man.cluster_sha1)
    # post-writeback results still match the host and the reference
    Q = _queries(X, 6, seed=13)
    rs = _radii(X, Q)
    got = se.range_query_batch(Q, rs)
    _host_range(ix, got, Q, rs)
    _same_range(got, rse.range_query_batch(Q, rs))
    # and a fresh resident load of the swapped store round-trips the
    # current snapshot bit-for-bit (post-retrain manifest swap)
    _assert_snapshots_equal(LIMSSnapshot.build(ix, device=CPU), _load(path))


def test_serving_paged_update_consistency():
    """Insert/delete/retrain through a paged engine: store-backed batch
    results stay bit-identical to the host and to the reference's paged
    engine after the refresh folds the updates in (buffer rows included,
    tombstones excluded)."""
    rng = np.random.default_rng(0)
    X = gauss_mix(1100, D, seed=9)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=4, m=3, n_rings=8)
    ref_ix = RefIndex(RefSpace(X, "l2"), n_clusters=4, m=3, n_rings=8)
    se = ServingEngine(ix, refresh_every=0, storage="paged", device=CPU)
    rse = RefEngine(ref_ix, refresh_every=0, storage="paged")
    new_rows = X[rng.choice(1100, 12)] + rng.normal(0, 0.02, (12, D))
    for eng in (se, rse):
        gids = [eng.insert(r) for r in new_rows]
        assert eng.delete(X[3]) == 1
        assert eng.delete(new_rows[0]) == 1
        eng.retrain_cluster(0)
        eng.refresh()
    Q = np.concatenate([new_rows[:3], X[rng.choice(1100, 3)]]) \
        + rng.normal(0, 0.003, (6, D))
    rs = _radii(X, Q)
    got = se.range_query_batch(Q, rs)
    _host_range(ix, got, Q, rs)
    _same_range(got, rse.range_query_batch(Q, rs))
    ids, ds = se.knn_query_batch(Q, 5)
    for b, q in enumerate(Q):
        h_ids, h_ds, _ = ix.knn_query(q, 5)
        np.testing.assert_allclose(np.sort(ds[b]), np.sort(h_ds), atol=0)
    _same_knn((ids, ds), rse.knn_query_batch(Q, 5))
    hit_ids, _ = se.range_query(new_rows[1], 1e-9)
    assert gids[1] in set(map(int, hit_ids))
    dead_ids, _ = se.range_query(new_rows[0], 1e-9)
    assert gids[0] not in set(map(int, dead_ids))


def test_inflight_executor_survives_writeback(tmp_path):
    """An executor serving generation g keeps returning generation-g
    results after refreshes publish later generations into the same
    store: its ``StoreView`` froze g's extents, and append-only page ids
    keep them byte-valid."""
    X = gauss_mix(1000, D, seed=3)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=4, m=3, n_rings=8)
    se = ServingEngine(ix, refresh_every=0, storage="paged",
                       storage_path=str(tmp_path / "s"), device=CPU)
    old_ex = se.executor
    Q = _queries(X, 5, seed=23)
    rs = _radii(X, Q)
    before_r = old_ex.range_query_batch(Q, rs)
    before_k = old_ex.knn_query_batch(Q, 5)
    # the reference's answers on the same generation
    ref = RefExecutor(RefSnapshot.build(RefIndex(
        RefSpace(X, "l2"), n_clusters=4, m=3, n_rings=8)))
    _same_range(before_r, ref.range_query_batch(Q, rs))
    _same_knn(before_k, ref.knn_query_batch(Q, 5))
    rng = np.random.default_rng(1)
    for row in X[rng.choice(1000, 8)] + rng.normal(0, 0.02, (8, D)):
        se.insert(row)
    for c in range(ix.K):            # rewrite every cluster's extent
        se.retrain_cluster(c)
    se.refresh()
    assert se.executor is not old_ex
    _same_range(before_r, old_ex.range_query_batch(Q, rs))
    _same_knn(before_k, old_ex.knn_query_batch(Q, 5))


def test_cold_start_from_spill(setup):
    """A replica cold-starts from the spilled directory: serves exact
    results immediately (the reference's on the same batches), is
    read-only until an index is attached, and keeps its warm page cache
    across the first refresh."""
    X, ix, snap, path = setup["X"], setup["ix"], setup["snap"], \
        setup["path"]
    cold = ServingEngine.from_spill(path, device=CPU)
    ref_cold = RefEngine.from_spill(setup["ref_path"])
    warm = QueryExecutor(snap)
    Q = _queries(X, 5, seed=17)
    rs = _radii(X, Q)
    a = warm.range_query_batch(Q, rs)
    b = cold.range_query_batch(Q, rs)
    _same_range(a, b)
    _same_range(b, ref_cold.range_query_batch(Q, rs))
    kb = cold.knn_query_batch(Q, 4)
    _same_knn(warm.knn_query_batch(Q, 4), kb)
    _same_knn(kb, ref_cold.knn_query_batch(Q, 4))
    assert cold.store.stats.misses > 0          # pages faulted in on demand
    assert cold.store.stats.snapshot() == ref_cold.store.stats.snapshot()
    with pytest.raises(RuntimeError, match="read-only"):
        cold.insert(X[0])
    with pytest.raises(RuntimeError, match="read-only"):
        cold.refresh()
    cold.attach_index(ix)
    store_before = cold.store
    cold.refresh()
    assert cold.store is store_before           # warm reader carried over
    _same_range(a, cold.range_query_batch(Q, rs))


def test_geometry_mismatch_rejected(setup):
    """Mixing record formats in one store file must be refused — also
    for a store the reference spilled."""
    for path in (setup["path"], setup["ref_path"]):
        with pytest.raises(ValueError, match="geometry"):
            setup["snap"].spill(path, page_bytes=64)


# -------------------------------------------------------------- compaction
def test_compact_reclaims_garbage_extents(tmp_path):
    """Repeated retrain writebacks append new extents and orphan the old
    ones; ``compact()`` rewrites the live extents into a fresh pages
    file (atomic manifest swap) and the garbage is reclaimed — while an
    executor bound to the pre-compaction generation keeps serving
    bit-identically through its ``StoreView``.  The reference's engine
    on the same sequence reclaims the same bytes."""
    X = gauss_mix(1000, D, seed=21)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=4, m=3, n_rings=8)
    ref_ix = RefIndex(RefSpace(X, "l2"), n_clusters=4, m=3, n_rings=8)
    path = str(tmp_path / "store")
    se = ServingEngine(ix, refresh_every=0, storage="paged",
                       storage_path=path, device=CPU)
    rse = RefEngine(ref_ix, refresh_every=0, storage="paged",
                    storage_path=str(tmp_path / "ref"))
    Q = _queries(X, 5, seed=31)
    rs = _radii(X, Q)
    old_ex = se.executor
    before_r = old_ex.range_query_batch(Q, rs)
    before_k = old_ex.knn_query_batch(Q, 5)
    for eng in (se, rse):
        rng = np.random.default_rng(7)
        for _ in range(2):              # two dirty writeback generations
            for row in X[rng.choice(1000, 6)] + rng.normal(0, 0.02,
                                                           (6, D)):
                eng.insert(row)
            eng.retrain_cluster(0)
            eng.refresh()
    man_dirty = Manifest.load(path)
    live_pages = man_dirty.K * man_dirty.layout().pages_per_cluster
    assert man_dirty.total_pages > live_pages       # garbage accumulated
    size_dirty = se.store.nbytes_file()
    man_c = se.compact()
    ref_c = rse.compact()
    assert man_c.generation == man_dirty.generation + 1
    assert man_c.total_pages == live_pages          # dense again
    assert man_c.pages_file != man_dirty.pages_file
    assert se.store.nbytes_file() < size_dirty      # bytes reclaimed
    assert se.store.nbytes_file() == rse.store.nbytes_file()
    assert (man_c.extents, man_c.total_pages, man_c.pages_file) == \
        (ref_c.extents, ref_c.total_pages, ref_c.pages_file)
    assert not os.path.exists(os.path.join(path, man_dirty.pages_file))
    # compaction moved rows, not results: current, pre-compaction and
    # freshly loaded readers all still serve exactly
    got = se.range_query_batch(Q, rs)
    _host_range(ix, got, Q, rs)
    _same_range(got, rse.range_query_batch(Q, rs))
    _same_range(before_r, old_ex.range_query_batch(Q, rs))
    _same_knn(before_k, old_ex.knn_query_batch(Q, 5))
    _assert_snapshots_equal(LIMSSnapshot.build(ix, device=CPU), _load(path))
    # and the next dirty writeback appends into the compacted file
    se.insert(X[0] + 0.01)
    se.refresh()
    man_next = Manifest.load(path)
    assert man_next.pages_file == man_c.pages_file
    assert man_next.total_pages > man_c.total_pages
    assert ServingEngine(ix, storage=None, device=CPU).compact() is None


def test_compact_through_stale_reader_is_safe(tmp_path):
    """compact() copies through the *latest published* manifest's file
    size, not the calling reader's possibly older mmap — a writeback
    since the reader's last refresh() appends extents past that mmap."""
    X = gauss_mix(700, D, seed=13)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=3, m=2, n_rings=6)
    path = str(tmp_path / "s")
    LIMSSnapshot.build(ix, device=CPU).spill(path)
    stale = PagedStore(path)            # mmap sized to generation 0
    # a writeback this reader never refresh()ed into: dirty every
    # cluster so new extents land beyond the stale reader's mmap
    for c in range(ix.K):
        ix.retrain_cluster(c)
    ix.insert(X[0] + 0.01)
    snap1 = LIMSSnapshot.build(ix, device=CPU)
    snap1.spill(path)
    assert Manifest.load(path).total_pages > stale.manifest.total_pages
    man_c = stale.compact()             # must read the NEW extents fully
    assert man_c.generation == Manifest.load(path).generation
    _assert_snapshots_equal(snap1, _load(path))


def test_repeated_compaction_converges(tmp_path):
    """compact() after compact() is stable: no garbage → same size."""
    X = gauss_mix(600, D, seed=2)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=3, m=2, n_rings=6)
    path = str(tmp_path / "s")
    LIMSSnapshot.build(ix, device=CPU).spill(path)
    store = PagedStore(path)
    m1 = store.compact()
    size1 = store.nbytes_file()
    m2 = store.compact()
    assert m2.generation == m1.generation + 1
    assert store.nbytes_file() == size1
    assert m2.extents == m1.extents


def test_compaction_releases_retired_mmaps(tmp_path):
    """An unlinked pages file stays mapped only while a live StoreView
    pins it; once the last view dies, the next compaction drops the
    mmap (releasing the unlinked file's disk blocks)."""
    X = gauss_mix(600, D, seed=8)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=3, m=2, n_rings=6)
    path = str(tmp_path / "s")
    snap = LIMSSnapshot.build(ix, device=CPU)
    snap.spill(path)
    store = PagedStore(path)
    v0 = store.view()                   # pins generation 0's file
    f0 = v0.file
    store.compact()
    assert f0 in store._maps            # v0 alive → old mmap retained
    rows_pinned = v0.gather(np.arange(4))
    assert np.array_equal(rows_pinned, snap.rows_np[:4])  # post-unlink
    del v0, rows_pinned
    store.compact()                     # next adoption prunes it
    assert f0 not in store._maps
    assert len(store._maps) == 1        # only the current file mapped


def test_dropped_generation_frees_its_view(tmp_path):
    """The paged backend holds its executor weakly, so dropping the last
    reference to an executor frees its snapshot's ``StoreView`` at once
    (no cycle collection) and the next refresh unmaps a retired file."""
    import weakref
    X = gauss_mix(600, D, seed=4)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=3, m=2, n_rings=6)
    path = str(tmp_path / "s")
    LIMSSnapshot.build(ix, device=CPU).spill(path)
    store = PagedStore(path)
    ex = QueryExecutor(_load(path, store=store), prefetch="async")
    f0 = ex.snap.store.file
    ex.knn_query_batch(_queries(X, 2, seed=1), 3)
    view = weakref.ref(ex.snap.store)
    store.compact()
    assert f0 in store._maps
    del ex
    assert view() is None
    store.refresh()
    assert f0 not in store._maps


# ---------------------------------------------------------- async prefetch
def test_prefetch_async_bit_identical_and_overlaps(setup):
    """``REPRO_PREFETCH=async`` is an IO-scheduling change only: kNN
    results stay bit-identical to the synchronous paged path (and the
    reference's), and the prefetcher demonstrably overlaps rounds."""
    X, snap, path = setup["X"], setup["snap"], setup["path"]
    sync_ex = QueryExecutor(_load(path, store=True), prefetch="off")
    pre_ex = QueryExecutor(_load(path, store=True), prefetch="async")
    ref_ex = RefExecutor(RefSnapshot.load(setup["ref_path"], store=True),
                         prefetch="async")
    assert sync_ex.prefetcher is None
    pf = pre_ex.prefetcher
    assert pf is not None
    # each demand waits for its pending ticket, so the overlap assertion
    # does not depend on the worker being scheduled in time
    orig_note = pf.note_demand

    def patient_note(pages, ticket=None):
        if ticket is not None:
            assert ticket.wait(timeout=60)
        orig_note(pages, ticket)

    pf.note_demand = patient_note
    # querying AT pivot rows collapses the seed radii to the guard band:
    # round-0 masks are tiny and each doubling adds slots incrementally
    Q = snap.pivots.numpy().astype(np.float64).reshape(-1, D)[:8]
    ids_a, ds_a = sync_ex.knn_query_batch(Q, 8)
    ids_b, ds_b = pre_ex.knn_query_batch(Q, 8)
    _same_knn((ids_a, ds_a), (ids_b, ds_b))
    _same_knn((ids_b, ds_b), ref_ex.knn_query_batch(Q, 8))
    assert pre_ex.last_knn["rounds"] >= 2       # tiny seed → multi-round
    assert pre_ex.last_knn["rounds"] == ref_ex.last_knn["rounds"]
    pf.drain()          # settle in-flight tickets before reading stats
    stats = pf.snapshot()
    assert stats["pages_submitted"] > 0
    assert stats["pages_fetched"] == stats["pages_submitted"]
    assert stats["overlapped_rounds"] >= 1
    assert 0.0 <= stats["hit_rate"] <= 1.0
    st = pre_ex.snap.store.stats
    assert st.prefetch_reads == stats["pages_fetched"]
    # range results are single-round (nothing to prefetch) but must be
    # unaffected by the prefetcher's presence
    rs = _radii(X, Q)
    _same_range(sync_ex.range_query_batch(Q, rs),
                pre_ex.range_query_batch(Q, rs))


def test_prefetch_engine_wiring(tmp_path):
    """ServingEngine(prefetch="async") threads the mode through refresh
    generations; results stay exact."""
    X = gauss_mix(900, D, seed=17)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=4, m=3, n_rings=8)
    se = ServingEngine(ix, refresh_every=0, storage="paged",
                       storage_path=str(tmp_path / "s"), prefetch="async",
                       device=CPU)
    assert se.executor.prefetcher is not None
    Q = _queries(X, 4, seed=3)
    ids, ds = se.knn_query_batch(Q, 5)
    for b, q in enumerate(Q):
        h_ids, h_ds, _ = ix.knn_query(q, 5)
        np.testing.assert_allclose(np.sort(ds[b]), np.sort(h_ds), atol=0)
    se.refresh()
    assert se.executor.prefetcher is not None   # survives the swap


# -------------------------------------------------------- schedule pinning
def _cache_trace(cls):
    """The reference test's pin/evict sequence on one cache class:
    every return value and residency check, in order."""
    c = cls(capacity_pages=2)
    blk = np.zeros((1, 1))
    out = [c.put("a", blk), c.put("b", blk)]
    c.pin(["a"])
    out.append(c.put("c", blk))                 # "b" (coldest unpinned)
    out += [c.peek("a") is not None, c.peek("b") is None]
    c.pin(["c"])
    # "a"/"c" pinned → the only evictable page is "d" itself
    out.append(c.put("d", blk))
    out += [c.peek("a") is not None, c.peek("c") is not None]
    c.pin(["d", "e"])                           # pin non-resident pages
    c.put("d", blk)
    out += [len(c), c.pinned]                   # all pinned: overflowed
    out.append(c.put("e", blk))                 # nothing evictable
    out.append(len(c))
    out.append(c.unpin(["a", "c", "d", "e"]))   # shrink back to capacity
    out += [len(c), c.pinned]
    return out


def test_pinned_pages_survive_cache_squeeze():
    """Unit pin/evict semantics: capacity eviction takes the coldest
    *unpinned* page; an all-pinned cache overflows instead of breaking
    a hold; releasing the pins shrinks back under capacity — step for
    step as the reference's cache."""
    trace = _cache_trace(LRUPageCache)
    assert trace == [0, 0, 1, True, True, 1, True, True, 3, 4, 0, 4, 2,
                     2, 0]
    assert trace == _cache_trace(RefLRU)


@pytest.mark.parametrize("capacity", [1, 4, 16, None])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ops_equal_reference_cache(seed, capacity):
    """A seeded random sequence of put / touch / pin / unpin / clear on
    the port's cache and the reference's: equal return values, ``len``,
    ``pinned``, recency order and residency after every step, with pins
    that overflow the capacity (the port's count of unpinned pages must
    end the victim search exactly where the reference's walk does)."""
    rng = np.random.default_rng(seed)
    ours, theirs = LRUPageCache(capacity), RefLRU(capacity)
    blk = np.zeros((1, 1))
    for step in range(3000):
        op = rng.choice(["put", "put", "touch", "pin", "unpin", "unpin",
                         "clear"], p=[.3, .1, .2, .2, .1, .09, .01])
        if op in ("put", "touch"):
            pid = int(rng.integers(40))
            out = [getattr(c, op)(pid, blk) if op == "put"
                   else c.touch(pid) for c in (ours, theirs)]
        elif op in ("pin", "unpin"):
            pids = rng.integers(40, size=int(rng.integers(1, 12))).tolist()
            out = [getattr(c, op)(pids) for c in (ours, theirs)]
        else:
            out = [c.clear() for c in (ours, theirs)]
        assert out[0] == out[1], (step, op)
        assert len(ours) == len(theirs) and ours.pinned == theirs.pinned
        assert list(ours._pages) == list(theirs._pages), step
        assert ours._unpinned == sum(k not in ours._pins
                                     for k in ours._pages)


def test_all_pinned_overflow_insert_is_constant_time():
    """20,000 pinned inserts over a 16-page cache: each insert past
    capacity finds every resident page pinned.  The reference's walk
    makes that quadratic (tens of seconds here); the port's count of
    unpinned pages ends the search at once.  Releasing the pins shrinks
    the cache back to its 16 hottest pages."""
    import time
    c = LRUPageCache(capacity_pages=16)
    blk = np.zeros((1, 1))
    t0 = time.perf_counter()
    for pid in range(20_000):
        c.pin([pid])
        assert c.put(pid, blk) == 0
    assert len(c) == c.pinned == 20_000
    assert c.unpin(range(20_000)) == 20_000 - 16
    assert time.perf_counter() - t0 < 5.0
    assert list(c._pages) == list(range(20_000 - 16, 20_000))


def test_unpin_restores_lru_order():
    """A pinned page earns recency like any other; after unpin it is
    evicted exactly when plain LRU would evict it."""
    for cls in (LRUPageCache, RefLRU):
        c = cls(capacity_pages=3)
        blk = np.zeros((1, 1))
        for k in ("a", "b", "c"):
            c.put(k, blk)
        c.pin(["a"])
        c.touch("a")                            # "a" now hottest
        c.unpin(["a"])
        c.put("d", blk)                         # plain LRU: "b" goes
        assert c.peek("b") is None
        assert all(c.peek(k) is not None for k in ("a", "c", "d"))


def test_plan_pins_released_after_batch(setup, monkeypatch):
    """A batch pins its planned pages for its whole execution (fetch →
    gather → exact refinement) and releases them all afterwards — on
    success AND when the executor errors mid-batch."""
    X = setup["X"]
    ex = QueryExecutor(_load(setup["path"], store=True, cache_pages=4))
    ref = RefExecutor(RefSnapshot.load(setup["ref_path"], store=True,
                                       cache_pages=4))
    store = ex.snap.store
    Q = _queries(X, 5, seed=23)
    rs = _radii(X, Q)
    mem = QueryExecutor(setup["snap"])
    b = ex.range_query_batch(Q, rs)
    _same_range(mem.range_query_batch(Q, rs), b)
    _same_range(b, ref.range_query_batch(Q, rs))
    assert ex.last_io["pinned_pages"] > 0
    assert ex.last_io["pinned_pages"] == ref.last_io["pinned_pages"]
    assert store.cache.pinned == 0              # fully released
    assert len(store.cache) <= 4                # overflow cleared too
    ids_m, _ = mem.knn_query_batch(Q, 6)
    ids_p, _ = ex.knn_query_batch(Q, 6)
    assert np.array_equal(ids_m, ids_p)
    assert ex.last_io["pinned_pages"] > 0
    assert store.cache.pinned == 0

    # executor error mid-refinement: the finally still drains the plan
    def boom(idx):
        raise RuntimeError("refinement died")

    monkeypatch.setattr(ex, "_refine_rows", boom)
    with pytest.raises(RuntimeError, match="refinement died"):
        ex.range_query_batch(Q, rs)
    assert store.cache.pinned == 0
    with pytest.raises(RuntimeError, match="refinement died"):
        ex.knn_query_batch(Q, 6)
    assert store.cache.pinned == 0


def test_pin_mode_off_is_blind_lru(setup, monkeypatch):
    """``REPRO_CACHE_PIN=off`` takes no holds at all — and results are
    unchanged either way."""
    X = setup["X"]
    monkeypatch.setenv("REPRO_CACHE_PIN", "off")
    ex = QueryExecutor(_load(setup["path"], store=True, cache_pages=4))
    ref = RefExecutor(RefSnapshot.load(setup["ref_path"], store=True,
                                       cache_pages=4))
    Q = _queries(X, 4, seed=29)
    got = ex.knn_query_batch(Q, 5)
    assert ex.last_io["pinned_pages"] == 0
    assert ex.snap.store.cache.pinned == 0
    _same_knn(got, QueryExecutor(setup["snap"]).knn_query_batch(Q, 5))
    _same_knn(got, ref.knn_query_batch(Q, 5))
    assert ex.snap.store.stats.snapshot() == ref.snap.store.stats.snapshot()


# -------------------------------------------------------- prefetch shutdown
def test_prefetch_shutdown_drops_and_counts(setup):
    """The prefetch daemon stops deliberately — queued plans are dropped
    (not drained), the drop is visible in the prefetcher's stats, and a
    post-shutdown submit degrades to an immediate counted drop."""
    import repro_torch.storage.prefetch as pfm
    from repro_torch.storage import PagePrefetcher, shutdown_prefetch
    store = PagedStore(setup["path"])
    pf = PagePrefetcher(store)
    try:
        t = pf.submit(np.arange(3, dtype=np.int64))
        assert t.wait(5.0)
        assert pf.pages_fetched == 3
        assert shutdown_prefetch(timeout=5.0)   # joined within timeout
        t2 = pf.submit(np.arange(4, dtype=np.int64))
        assert t2.done()                        # completes at once...
        snap_d = pf.snapshot()
        assert snap_d["dropped_plans"] == 1     # ...but dropped, counted
        assert snap_d["pages_dropped"] == 4
        assert pf.pages_fetched == 3            # nothing fetched for it
        pf.drain()                              # no-op, must not hang
        assert shutdown_prefetch()              # idempotent
    finally:
        pfm._restart_for_tests()                # rest of the suite
    t3 = pf.submit(np.arange(2, dtype=np.int64))
    assert t3.wait(5.0)
    assert pf.pages_fetched == 5
    # pages 0-1 were cached by the first plan: only page reads count
    assert store.stats.prefetch_reads == 3 and store.stats.misses == 0


# ----------------------------------------------------------------- real IO
def test_drop_os_cache_best_effort(setup):
    """Dropping the OS page cache is advisory and never changes results
    (it only makes the next cold read honest)."""
    X = setup["X"]
    ex = QueryExecutor(_load(setup["path"], store=True))
    Q = _queries(X, 4, seed=41)
    rs = _radii(X, Q)
    a = ex.range_query_batch(Q, rs)
    supported = ex.snap.store.drop_os_cache()
    assert supported == hasattr(os, "posix_fadvise")
    ex.snap.store.cache.clear()
    _same_range(a, ex.range_query_batch(Q, rs))


def test_maybe_paged_and_batched_lims(monkeypatch):
    """``REPRO_STORAGE=paged`` turns ``BatchedLIMS`` into a store-backed
    executor with a self-cleaning spill, with the resident results."""
    from repro_torch.core.batched import BatchedLIMS
    X = gauss_mix(500, D, seed=6)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=3, m=2, n_rings=6)
    Q = _queries(X, 3, seed=2)
    resident = BatchedLIMS(ix, device=CPU)
    assert resident.snap.store is None
    monkeypatch.setenv("REPRO_STORAGE", "paged")
    paged = BatchedLIMS(ix, device=CPU)
    assert paged.snap.store is not None
    path = paged.snap.store.root
    assert os.path.isdir(path)
    _same_knn(resident.knn_query_batch(Q, 4), paged.knn_query_batch(Q, 4))
    del paged
    import gc
    gc.collect()
    assert not os.path.exists(path)


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_paged_path_on_card_equals_cpu(tmp_path):
    """The store-backed executor on the card: the gathered rows go
    through the pinned staging buffer to ``range_filter`` and ``pdist``,
    the round masks through ``pdist_rankeval``; results equal the CPU
    port's (held to the reference by the tests above), and so do the IO
    counters, ``host_syncs`` included, at a squeezed cache.  Uses the
    port alone, so it runs where no reference is installed."""
    import torch

    from repro_torch.kernels import _cuda
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    X = gauss_mix(N, D, seed=7)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
    path = str(tmp_path / "s")
    ix.spill(path, page_bytes=4096, device=CPU)
    card = QueryExecutor(LIMSSnapshot.load(path, store=True, cache_pages=5,
                                           device="cuda"), prefetch="off")
    cpu = QueryExecutor(_load(path, store=True, cache_pages=5),
                        prefetch="off")
    _cuda.reset_launches()
    for seed in (1, 2):
        Q = _queries(X, 16, seed=seed)
        rs = _radii(X, Q)
        got = card.range_query_batch(Q, rs)
        _same_range(got, cpu.range_query_batch(Q, rs))
        _host_range(ix, got, Q, rs)
        assert card.last_io == cpu.last_io
        assert card.last_profile.host_syncs == cpu.last_profile.host_syncs
        _same_knn(card.knn_query_batch(Q, 7), cpu.knn_query_batch(Q, 7))
        assert card.last_io == cpu.last_io
        assert card.last_knn == cpu.last_knn
    assert card.snap.store.stats.snapshot() == \
        cpu.snap.store.stats.snapshot()
    for name in ("pdist", "range_filter", "pdist_rankeval"):
        assert _cuda.LAUNCHES[name] > 0, name
    staging = card.backend._tls.staging
    assert staging.is_pinned() and staging.dtype == torch.float32
