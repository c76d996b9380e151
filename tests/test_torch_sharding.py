"""The port's cluster-sharded executor against the reference, on the CPU.

Twin of the sharded cases of ``tests/test_serving.py``,
``tests/test_layout.py``, ``tests/test_storage.py`` and
``tests/test_obs.py``, on the 6-cluster GaussMix index of
``tests/test_serving.py`` (N = 1,800, d = 6).  The port's
``ShardedExecutor`` runs S shards on ``Mesh(devices=(cpu,) * S)``, each
kernel through its plain version; the reference runs its Pallas kernels
in interpret mode.  Checked: ``pad_clusters`` equal to the reference's
field by field (the bf16 plane and the host mirrors too) and inert;
range (with an empty r = 1e-12 query) and kNN ids and f64 distances at
S = 1, 2, 3, 4, 6 identical to the reference's single-device executor
and to the host index, with plan masks and routing equal to the port's
single-device plan and ``last_knn`` rounds and host syncs equal; the
bf16 plane with compaction on giving the f32 baseline with every
filter launch over f32 rows; a store-backed sharded executor with IO
counters equal to the reference's; the profile's ``n_shards``; each
kernel launched S times a batch; the logical rules; shards that are
views of the snapshot's tensors; the errors of a mesh without a card.
One test pins the port to the reference's real ``shard_map`` path: it
runs the reference's ``ShardedExecutor`` over 4 fake XLA host devices
in a subprocess (the flag cannot be set in a process whose JAX is up)
and compares plan masks, routing and results with the port at S = 4.
The ``gpu`` test runs S = 4 on ``cuda:0``; it skips where there is no
card.
"""
import gc
import os
import subprocess
import sys
import weakref
from pathlib import Path

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.convert import FIELDS, snapshot_from_reference
from repro_torch.core import (LIMSIndex, LIMSSnapshot, MetricSpace,
                              QueryExecutor, ShardedExecutor, make_executor)
from repro_torch.core.metrics import dist_one_to_many
from repro_torch.core.snapshot import DEVICE_FIELDS, host_tables
from repro_torch.data.datasets import gauss_mix
from repro_torch.kernels import ops
from repro_torch.serving import ServingEngine
from repro_torch.sharding import (Mesh, default_rules, serving_mesh,
                                  shardable, spec_for)

N, D = 1800, 6
CPU = torch.device("cpu")
SHARDS = (1, 2, 3, 4, 6)
SRC = Path(__file__).resolve().parents[1] / "src"
TABLES = ("rids", "pivots", "coef", "model_lo", "model_hi", "model_n",
          "rank_err", "in_ring")


def _mesh(S: int) -> Mesh:
    return Mesh((CPU,) * S)


@pytest.fixture(scope="module")
def ref():
    """The reference package, imported here so that the ``gpu`` test
    runs where JAX is absent."""
    core = pytest.importorskip("repro.core")
    from repro.core.executor import QueryExecutor
    from repro.core.snapshot import LIMSSnapshot
    from repro.sharding import logical
    return SimpleNamespace(core=core, Executor=QueryExecutor,
                           Snapshot=LIMSSnapshot, logical=logical)


@pytest.fixture(scope="module")
def env(ref):
    X = gauss_mix(N, D, seed=7)
    ref_ix = ref.core.LIMSIndex(ref.core.MetricSpace(X, "l2"),
                                n_clusters=6, m=3, n_rings=10)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
    ref_snap = ref.Snapshot.build(ref_ix)
    snap = LIMSSnapshot.build(ix, device=CPU)
    return {"X": X, "ref_ix": ref_ix, "ix": ix, "ref_snap": ref_snap,
            "snap": snap, "ref_ex": ref.Executor(ref_snap),
            "single": QueryExecutor(snap)}


def _queries(X, n_q, seed=2, scale=0.004):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n_q)] + rng.normal(0, scale, (n_q, D))


def _radii(X, Q, sel=0.02):
    rs = np.array([float(np.quantile(dist_one_to_many(q, X, "l2"), sel))
                   for q in Q])
    rs[0] = 1e-12                               # provably empty
    return rs


def _same_range(a, b):
    assert len(a) == len(b)
    for (ai, ad), (bi, bd) in zip(a, b):
        assert np.array_equal(ai, bi) and np.array_equal(ad, bd)


def _same_knn(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _carried(ref_snap, **extra):
    arrays = {f: np.asarray(getattr(ref_snap, f)) for f in FIELDS}
    arrays.update(extra)
    return snapshot_from_reference(arrays, CPU)


# ------------------------------------------------------------- padding
def test_pad_clusters_equals_reference(env, ref, monkeypatch):
    """Field by field the reference's ``pad_clusters`` on the carried
    snapshot, the bf16 plane (as bits) and the host mirrors included;
    ``lp_eps`` unchanged; ``self`` untouched."""
    monkeypatch.setenv("REPRO_ROWS_DTYPE", "bf16")
    built = ref.Snapshot.build(env["ref_ix"])
    bits = np.asarray(built.rows_lp).view(np.uint16)
    port = _carried(built, rows_lp=bits, rows_lp_dtype="bf16",
                    lp_eps=built.lp_eps)
    K = port.K
    ref_pad, pad = built.pad_clusters(K + 3), port.pad_clusters(K + 3)
    assert port.K == K and port.rows.shape[0] == K
    assert pad.pad_clusters(pad.K) is pad
    for f in ("K", "m", "n_rings", "n_max", "live"):
        assert getattr(pad, f) == getattr(ref_pad, f), f
    for f in DEVICE_FIELDS:
        a, b = getattr(pad, f).numpy(), np.asarray(getattr(ref_pad, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("gids_np", "rows_np", "valid_np"):
        assert np.array_equal(getattr(pad, f), getattr(ref_pad, f)), f
    assert np.array_equal(
        pad.rows_lp.view(torch.int16).numpy().view(np.uint16),
        np.asarray(ref_pad.rows_lp).view(np.uint16))
    assert pad.lp_eps == ref_pad.lp_eps == port.lp_eps
    want = host_tables(*(np.asarray(getattr(ref_pad, f)) for f in TABLES))
    for f, a in vars(pad.tables_np).items():
        b = getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    with pytest.raises(ValueError, match="K_new"):
        port.pad_clusters(K - 1)


def test_pad_clusters_is_inert(env):
    """Padded clusters hold no live slot and change no result through
    the plain executor."""
    X, snap = env["X"], env["snap"]
    pad = snap.pad_clusters(snap.K + 3)
    P = snap.n_slots
    assert pad.live == snap.live and not pad.valid_np[P:].any()
    assert (pad.gids_np[P:] == -1).all()
    Q = _queries(X, 5)
    rs = _radii(X, Q)
    a, b = QueryExecutor(snap), QueryExecutor(pad)
    _same_range(a.range_query_batch(Q, rs), b.range_query_batch(Q, rs))
    _same_knn(a.knn_query_batch(Q, 6), b.knn_query_batch(Q, 6))


def test_pad_clusters_store_backed_keeps_no_rows(env, tmp_path):
    """A store-backed snapshot pads its tables and keeps no row payload;
    no padded slot is ever valid, so none maps to a page."""
    path = str(tmp_path / "s")
    env["snap"].spill(path)
    st = LIMSSnapshot.load(path, store=True, device=CPU)
    pad = st.pad_clusters(st.K + 2)
    assert pad.rows.shape == (st.K + 2, 0, st.d)
    assert pad.rows_np.shape == (0, st.d)
    assert pad.store is st.store and pad.valid_np.size == pad.n_slots
    assert not pad.valid_np[st.n_slots:].any()


# ------------------------------------------------------- sharded results
@pytest.mark.parametrize("S", SHARDS)
def test_sharded_equals_reference_and_host(env, S, monkeypatch):
    """Range and kNN ids and f64 distances identical to the reference's
    single-device executor and to the host index; the kNN rounds and
    host syncs equal the port's single-device executor's, both under the
    host-driven rounds (the loop's case is the test below)."""
    monkeypatch.setenv("REPRO_KNN_DRIVER", "rounds")
    X, ref_ix = env["X"], env["ref_ix"]
    sx = ShardedExecutor(env["snap"], mesh=_mesh(S))
    assert sx.n_shards == S and sx.snap.K % S == 0
    Q = _queries(X, 8, seed=3)
    rs = _radii(X, Q)
    got = sx.range_query_batch(Q, rs)
    assert len(got[0][0]) == 0
    _same_range(got, env["ref_ex"].range_query_batch(Q, rs))
    for (ids, ds), q, r in zip(got, Q, rs):
        h_ids, h_ds, _ = ref_ix.range_query(q, r)
        assert set(map(int, ids)) == set(map(int, h_ids))
        np.testing.assert_allclose(np.sort(ds), np.sort(h_ds), atol=0)
    single = env["single"]
    for k in (6, 500, N + 99):
        kk = sx.knn_query_batch(Q, k)
        _same_knn(kk, env["ref_ex"].knn_query_batch(Q, k))
        _same_knn(kk, single.knn_query_batch(Q, k))
        for key in ("rounds", "host_syncs", "driver"):
            assert sx.last_knn[key] == single.last_knn[key], key
        assert sx.last_driver == "rounds"
    for b, q in enumerate(Q):
        h_ids, h_ds, _ = ref_ix.knn_query(q, 6)
        kk = sx.knn_query_batch(q[None], 6)
        np.testing.assert_allclose(kk[1][0], np.sort(h_ds), atol=0)
        assert set(map(int, kk[0][0])) == set(map(int, h_ids))


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_loop_equals_reference_and_host(env, S, monkeypatch):
    """The same under the device-resident loop (``auto`` picks it for a
    sharded executor on the CPU, as the reference does): kNN ids and f64
    distances identical to the reference's and to the host index, and
    rounds, host syncs and driver equal to the single-device loop's."""
    X, ref_ix = env["X"], env["ref_ix"]
    sx = ShardedExecutor(env["snap"], mesh=_mesh(S))
    Q = _queries(X, 8, seed=3)
    single = env["single"]
    for k in (6, 500, N + 99):
        monkeypatch.delenv("REPRO_KNN_DRIVER", raising=False)
        kk = sx.knn_query_batch(Q, k)
        assert sx.last_driver == ("loop" if S > 1 else "rounds")
        monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
        _same_knn(kk, sx.knn_query_batch(Q, k))
        _same_knn(kk, env["ref_ex"].knn_query_batch(Q, k))
        _same_knn(kk, single.knn_query_batch(Q, k))
        for key in ("rounds", "host_syncs", "driver"):
            assert sx.last_knn[key] == single.last_knn[key], key
        assert sx.last_driver == "loop" and sx.last_knn["host_syncs"] == 2
    for q in Q[:3]:
        h_ids, h_ds, _ = ref_ix.knn_query(q, 6)
        kk = sx.knn_query_batch(q[None], 6)
        np.testing.assert_allclose(kk[1][0], np.sort(h_ds), atol=0)
        assert set(map(int, kk[0][0])) == set(map(int, h_ids))


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_plan_equals_single_device(env, S, monkeypatch):
    """The sharded plan's mask and routing are the single-device plan's
    in the padded snapshot's slot order (padding all False), the kNN
    seed radii are equal, and a range batch syncs as often as the
    single-device one with compaction off."""
    monkeypatch.setenv("REPRO_COMPACT", "off")
    X, snap, single = env["X"], env["snap"], env["single"]
    sx = ShardedExecutor(snap, mesh=_mesh(S))
    Q = _queries(X, 8, seed=6)
    rs = _radii(X, Q)
    P, K = snap.n_slots, snap.K
    a, b = single.planner.plan_range(Q, rs), sx.planner.plan_range(Q, rs)
    assert np.array_equal(b.mask[:, :P], a.mask) and not b.mask[:, P:].any()
    assert np.array_equal(b.routing[:, :K], a.routing)
    assert not b.routing[:, K:].any()
    ka, kb = single.planner.plan_knn(Q, 6, 64), sx.planner.plan_knn(Q, 6, 64)
    assert np.array_equal(ka.radii, kb.radii)
    single.range_query_batch(Q, rs)
    sx.range_query_batch(Q, rs)
    assert sx.last_compact is None
    assert sx.last_profile.host_syncs == single.last_profile.host_syncs


def test_bf16_plane_with_compaction_gives_f32_baseline(env, monkeypatch):
    """bf16 plane + compaction on the sharded executor still returns the
    f32 baseline bit for bit (test_layout.py's sharded case): the
    sharded filter streams the shards' f32 rows, with eps 0, and does
    not compact."""
    X = env["X"]
    Q = _queries(X, 5, seed=7)
    rs = _radii(X, Q)
    base_r = env["single"].range_query_batch(Q, rs)
    base_k = env["single"].knn_query_batch(Q, 9)
    monkeypatch.setenv("REPRO_ROWS_DTYPE", "bf16")
    monkeypatch.setenv("REPRO_COMPACT", "on")
    snap = LIMSSnapshot.build(env["ix"], device=CPU)
    assert snap.rows_lp is not None and snap.lp_eps > 0.0
    seen = []
    for name in ("pdist", "range_filter"):
        real = getattr(ops, name)

        def spy(q, p, *a, real=real, **k):
            seen.append(p.dtype)
            return real(q, p, *a, **k)

        monkeypatch.setattr(ops, name, spy)
    sx = ShardedExecutor(snap, mesh=_mesh(4))
    _same_range(sx.range_query_batch(Q, rs), base_r)
    _same_knn(sx.knn_query_batch(Q, 9), base_k)
    assert sx.last_compact is None
    assert seen and set(seen) == {torch.float32}


# ------------------------------------------------------------ store mode
@pytest.mark.parametrize("S", (2, 4))
def test_store_backed_sharded_io_equals_reference(env, ref, tmp_path, S):
    """A store-backed sharded executor (only the plan runs sharded)
    equals the reference's store-backed executor on the same spill:
    results, ``last_io``, ``last_knn``, cache stats and the profile's
    host syncs, at a cache squeezed below a batch."""
    X = env["X"]
    path = str(tmp_path / "s")
    env["ref_snap"].spill(path)
    rx = ref.Executor(ref.Snapshot.load(path, store=True, cache_pages=5),
                      prefetch="off")
    sx = ShardedExecutor(LIMSSnapshot.load(path, store=True, cache_pages=5,
                                           device=CPU),
                         mesh=_mesh(S), prefetch="off")
    assert sx.snap.store is not None and sx.backend.name == "paged"
    for seed in (3, 4):
        Q = _queries(X, 8, seed=seed)
        rs = _radii(X, Q)
        got = sx.range_query_batch(Q, rs)
        _same_range(got, rx.range_query_batch(Q, rs))
        assert len(got[0][0]) == 0
        assert sx.last_io == rx.last_io
        assert sx.last_profile.host_syncs == rx.last_profile.host_syncs
        _same_knn(sx.knn_query_batch(Q, 6), rx.knn_query_batch(Q, 6))
        assert sx.last_io == rx.last_io
        assert sx.last_knn == rx.last_knn
    ids, ds = sx.knn_query_batch(Q[:2], N + 99)
    assert ids.shape == (2, N)
    _same_knn((ids, ds), rx.knn_query_batch(Q[:2], N + 99))
    assert sx.snap.store.stats.snapshot() == rx.snap.store.stats.snapshot()


# --------------------------------------------------------- observability
def test_profile_sharded_complete(env, monkeypatch):
    """The sharded profile reads ``n_shards == S`` (the single-device
    executor's reads 1) and is complete (test_obs.py's sharded case),
    under the host-driven rounds."""
    from repro_torch import obs
    obs.configure("on")
    monkeypatch.setenv("REPRO_KNN_DRIVER", "rounds")
    X = env["X"]
    Q = _queries(X, 4, seed=9)
    sx = ShardedExecutor(env["snap"], mesh=_mesh(3))
    sx.knn_query_batch(Q, 5)
    p = sx.last_profile
    assert p.n_shards == 3 and p.kind == "knn" and p.driver == "rounds"
    assert p.backend == "resident" and p.storage == "resident"
    assert p.n_clusters == sx.snap.K and p.candidates_per_query > 0
    sx.range_query_batch(Q, _radii(X, Q))
    assert sx.last_profile.n_shards == 3
    env["single"].knn_query_batch(Q, 5)
    assert env["single"].last_profile.n_shards == 1


def test_profile_sharded_loop_complete(env, monkeypatch):
    """The same profile under ``auto``, which picks the loop for the
    sharded executor: ``driver`` reads "loop", two host syncs."""
    from repro_torch import obs
    obs.configure("on")
    monkeypatch.delenv("REPRO_KNN_DRIVER", raising=False)
    X = env["X"]
    Q = _queries(X, 4, seed=9)
    sx = ShardedExecutor(env["snap"], mesh=_mesh(3))
    sx.knn_query_batch(Q, 5)
    p = sx.last_profile
    assert p.n_shards == 3 and p.kind == "knn" and p.driver == "loop"
    assert p.backend == "resident" and p.host_syncs == 2
    assert p.n_clusters == sx.snap.K and p.candidates_per_query > 0


@pytest.mark.parametrize("S", (2, 4))
def test_sharded_runs_each_kernel_per_shard(env, monkeypatch, S):
    """Each kernel of the query path runs once a shard where the
    single-device executor runs it once (a spy on ``ops``; on the CPU
    the plan is the staged pdist + rankeval chain)."""
    monkeypatch.setenv("REPRO_COMPACT", "off")
    calls = {"pdist": 0, "rankeval": 0, "range_filter": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, name=name, real=real, **k):
            calls[name] += 1
            return real(*a, **k)

        monkeypatch.setattr(ops, name, spy)
    X = env["X"]
    Q = _queries(X, 6, seed=11)
    rs = _radii(X, Q)
    sx = ShardedExecutor(env["snap"], mesh=_mesh(S))
    counts = []
    for ex in (env["single"], sx):
        got = {}
        for kind in ("range", "knn"):
            for name in calls:
                calls[name] = 0
            if kind == "range":
                ex.range_query_batch(Q, rs)
            else:
                ex.knn_query_batch(Q, 6)
            got[kind] = dict(calls)
        counts.append(got)
    single, sharded = counts
    assert single["range"] == {"pdist": 1, "rankeval": 1, "range_filter": 1}
    assert single["knn"]["pdist"] == 2 + sx.last_knn["rounds"]
    for kind in ("range", "knn"):
        for name in calls:
            assert sharded[kind][name] == S * single[kind][name], \
                (kind, name)


# ----------------------------------------------------------- the mesh
def test_logical_rules_equal_reference(ref):
    """``default_rules``, ``spec_for`` and ``shardable`` equal the
    reference's on a 1-device mesh (specs as tuples)."""
    ref_logical = ref.logical
    ref_mesh = ref_logical.serving_mesh(1)
    mesh = _mesh(1)
    assert mesh.shape == dict(ref_mesh.shape)
    assert mesh.axis_names == tuple(ref_mesh.axis_names)
    for kw in ({}, {"fsdp": True}, {"seq_shard": True},
               {"kv_heads_shardable": False}):
        assert default_rules(**kw) == ref_logical.default_rules(**kw)
    rules = default_rules(fsdp=True)
    cases = [(("clusters", None, None), None), (("clusters",), (7,)),
             (("batch", "seq", "embed"), None),
             (("batch", "embed"), (3, 8)), (("heads", "mlp"), (8, 8)),
             ((None, "vocab"), None), (("embed", "embed"), (4, 4))]
    for axes, shape in cases:
        want = ref_logical.spec_for(axes, rules, ref_mesh, shape)
        assert spec_for(axes, rules, mesh, shape) == tuple(want), axes
    for dim, axis in ((8, "data"), (7, "data"), (8, "model")):
        assert shardable(dim, mesh, axis) == \
            ref_logical.shardable(dim, ref_mesh, axis)
    assert shardable(8, None) is False


@pytest.mark.parametrize("S", (3, 4))
def test_shards_are_views_of_the_snapshot(env, S):
    """On the snapshot's own device a shard is a view of the (padded)
    snapshot's cluster-major tensor, not a copy: it shares its storage,
    at the shard's cluster offset."""
    snap = env["snap"]
    sx = ShardedExecutor(snap, mesh=_mesh(S))
    if snap.K % S == 0:
        assert sx.snap is snap                  # no padding, no copy
    kl = sx.snap.K // S
    for f in DEVICE_FIELDS:
        whole = getattr(sx.snap, f)
        step = whole[0].numel() * whole.element_size()
        for i, sh in enumerate(sx._parts):
            part = getattr(sh, f)
            assert part.untyped_storage().data_ptr() == \
                whole.untyped_storage().data_ptr(), f
            assert part.data_ptr() == whole.data_ptr() + i * kl * step, f


def test_mesh_and_factory(env):
    """``make_executor`` shards when given a mesh (or ``sharded=True``
    with one), stays single-device on the CPU without one, and a 1-device
    mesh is the plain path; a mesh naming ``cuda`` raises where there is
    no card, and ``serving_mesh`` never falls back to the CPU."""
    snap = env["snap"]
    ex = make_executor(snap, mesh=_mesh(2))
    assert isinstance(ex, ShardedExecutor) and ex.n_shards == 2
    assert isinstance(make_executor(snap, sharded=True, mesh=_mesh(3)),
                      ShardedExecutor)
    plain = make_executor(snap)
    assert type(plain) is QueryExecutor and plain.snap is snap
    one = ShardedExecutor(snap, mesh=_mesh(1))
    assert one.n_shards == 1 and one.snap is snap and one._parts[0] is snap \
        and len(one._parts) == 1
    assert Mesh(("cpu", CPU)).devices == (CPU, CPU)
    with pytest.raises(ValueError):
        Mesh((CPU,), axis_names=("data", "model"))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh(("cuda", "cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_executor(snap, sharded=True)


def test_dropped_sharded_generation_is_freed(env):
    """The sharded executor holds no reference cycle either: with the
    cycle collector off, a sharded engine's generation 0 (its padded
    snapshot and the shard views into it) is gone after two swaps."""
    X, ix = env["X"], env["ix"]
    se = ServingEngine(ix, refresh_every=0, mesh=_mesh(4), device=CPU)
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
    assert isinstance(se.executor, ShardedExecutor)
    assert se.executor.mesh == _mesh(4)


# --------------------------------------- the reference's shard_map path
_REF_SHARD_MAP = r"""
import sys
import numpy as np
import jax
from repro.core import LIMSIndex, MetricSpace
from repro.core.executor import ShardedExecutor
from repro.core.metrics import dist_one_to_many
from repro.core.snapshot import LIMSSnapshot
from repro.data.datasets import gauss_mix
from repro_torch.convert import FIELDS

assert jax.device_count() == 4, jax.devices()
X = gauss_mix(1800, 6, seed=7)
ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
snap = LIMSSnapshot.build(ix)
sx = ShardedExecutor(snap)
assert sx.n_shards == 4 and sx.snap.K == 8
rng = np.random.default_rng(3)
Q = X[rng.choice(1800, 8)] + rng.normal(0, 0.004, (8, 6))
rs = np.array([float(np.quantile(dist_one_to_many(q, X, "l2"), 0.02))
               for q in Q])
rs[0] = 1e-12
plan = sx.planner.plan_range(Q, rs)
rr = sx.range_query_batch(Q, rs)
ids, ds = sx.knn_query_batch(Q, 6)
out = {f: np.asarray(getattr(snap, f)) for f in FIELDS}
out.update(Q=Q, rs=rs, mask=np.asarray(plan.mask),
           routing=np.asarray(plan.routing),
           range_n=np.array([len(a) for a, _ in rr]),
           range_ids=np.concatenate([a for a, _ in rr]),
           range_ds=np.concatenate([b for _, b in rr]),
           knn_ids=ids, knn_ds=ds, knn_rounds=sx.last_knn["rounds"],
           knn_driver=sx.last_knn["driver"])
np.savez(sys.argv[1], **out)
"""


def test_plans_equal_reference_shard_map(ref, tmp_path):
    """The reference's ``ShardedExecutor`` over 4 fake XLA host devices
    (its real ``shard_map`` path, K = 6 padded to 8) in a subprocess;
    the port at S = 4 on the same snapshot (carried over) gives the same
    plan mask and routing, range results, kNN results and rounds."""
    out = tmp_path / "ref.npz"
    env_ = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", _REF_SHARD_MAP, str(out)],
                         env=env_, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    want = dict(np.load(out))
    assert str(want["knn_driver"]) == "loop"
    snap = snapshot_from_reference({f: want[f] for f in FIELDS}, CPU)
    sx = ShardedExecutor(snap, mesh=_mesh(4))
    assert sx.snap.K == 8
    Q, rs = want["Q"], want["rs"]
    plan = sx.planner.plan_range(Q, rs)
    assert np.array_equal(plan.mask, want["mask"])
    assert np.array_equal(plan.routing, want["routing"])
    got = sx.range_query_batch(Q, rs)
    assert np.array_equal([len(a) for a, _ in got], want["range_n"])
    assert np.array_equal(np.concatenate([a for a, _ in got]),
                          want["range_ids"])
    assert np.array_equal(np.concatenate([b for _, b in got]),
                          want["range_ds"])
    _same_knn(sx.knn_query_batch(Q, 6), (want["knn_ids"], want["knn_ds"]))
    assert sx.last_knn["rounds"] == int(want["knn_rounds"])
    assert sx.last_knn["driver"] == "loop"


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_sharded_on_card_equals_host(monkeypatch):
    """S = 4 shards on the card (a mesh naming ``cuda:0`` four times; on
    a machine with several cards, the cards in turn): range and kNN
    equal the host index's and the CPU port's single-device executor's,
    with the same rounds and host syncs under the host-driven rounds,
    and each query-path kernel launched four times where one device
    launches it once."""
    from repro_torch.kernels import _cuda
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    monkeypatch.setenv("REPRO_KNN_DRIVER", "rounds")
    X = gauss_mix(N, D, seed=7)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
    card = LIMSSnapshot.build(ix, device="cuda")
    cpu = QueryExecutor(LIMSSnapshot.build(ix, device=CPU))
    cards = torch.cuda.device_count()
    sx = ShardedExecutor(card, mesh=Mesh(tuple(
        torch.device("cuda", i % cards) for i in range(4))))
    one = QueryExecutor(card)
    Q = _queries(X, 16, seed=1)
    rs = _radii(X, Q)
    monkeypatch.setenv("REPRO_COMPACT", "off")
    tallies = []
    for ex in (one, sx):
        _cuda.reset_launches()
        got = ex.range_query_batch(Q, rs)
        kk = ex.knn_query_batch(Q, 7)
        tallies.append(dict(_cuda.LAUNCHES))
        _same_range(got, cpu.range_query_batch(Q, rs))
        _same_knn(kk, cpu.knn_query_batch(Q, 7))
        assert ex.last_knn["rounds"] == cpu.last_knn["rounds"]
        assert ex.last_knn["host_syncs"] == cpu.last_knn["host_syncs"]
    for q, r, (ids, ds) in zip(Q, rs, got):
        h_ids, h_ds, _ = ix.range_query(q, r)
        assert set(map(int, ids)) == set(map(int, h_ids))
        np.testing.assert_allclose(np.sort(ds), np.sort(h_ds), atol=0)
    for name in ("pdist", "range_filter", "pdist_rankeval"):
        assert tallies[1][name] == 4 * tallies[0][name] > 0, name


@pytest.mark.gpu
def test_sharded_loop_on_card_equals_host(monkeypatch):
    """S = 4 shards on ``cuda:0`` four times under the loop (``auto``
    picks it on a mesh of one card): kNN equal to the host index's and
    the CPU port's single-device loop, the same rounds and host syncs,
    and ``pdist_rankeval`` counted four times a replayed round."""
    from repro_torch.kernels import _cuda
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    monkeypatch.delenv("REPRO_KNN_DRIVER", raising=False)
    X = gauss_mix(N, D, seed=7)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
    card = LIMSSnapshot.build(ix, device="cuda")
    cpu = QueryExecutor(LIMSSnapshot.build(ix, device=CPU))
    sx = ShardedExecutor(card, mesh=Mesh((torch.device("cuda", 0),) * 4))
    one = QueryExecutor(card)
    Q = _queries(X, 16, seed=1)
    for ex, S in ((one, 1), (sx, 4)):
        _cuda.reset_launches()
        kk = ex.knn_query_batch(Q, 7)
        n = dict(_cuda.LAUNCHES)
        assert ex.last_driver == "loop"
        monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
        _same_knn(kk, cpu.knn_query_batch(Q, 7))
        monkeypatch.delenv("REPRO_KNN_DRIVER")
        assert ex.last_knn["rounds"] == cpu.last_knn["rounds"]
        assert ex.last_knn["host_syncs"] == cpu.last_knn["host_syncs"] == 2
        assert n["pdist_rankeval"] == S * ex.last_knn["rounds"]
        assert n["knn_loop_cond"] == ex.last_knn["rounds"]
    for q, (ids, ds) in zip(Q, zip(*kk)):
        h_ids, h_ds, _ = ix.knn_query(q, 7)
        np.testing.assert_allclose(ds, np.sort(h_ds), atol=0)
        assert set(map(int, ids)) == set(map(int, h_ids))
