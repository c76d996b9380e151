"""The port's reduced-precision filter plane against the reference's.

Twin of the filter-plane tests of ``tests/test_layout.py``: with
``REPRO_ROWS_DTYPE=bf16|f16`` the snapshot keeps a 2-byte copy of its
row plane, ``rows_lp``, with the certified margin ``lp_eps`` =
max‖x_f32 − x_lp‖ (f64), and ``pdist`` / ``range_filter`` filter on it
with radii widened by ``lp_eps``.  The port runs with ``device="cpu"``
(each kernel's plain version); the reference runs its Pallas kernels in
interpret mode with ``REPRO_KNN_DRIVER=rounds``, the host-driven kNN
rounds the port has.  Checked, on the same seeded corpus: the plane's
bits (uint16 views: torch's and jnp's round-to-nearest-even agree) and
``lp_eps`` equal the reference's, also in f16 past 65,504 where a
coordinate rounds to inf and the margin is inf; range and kNN ids and
f64 distances equal the reference's and the f32 baseline's under off,
f32, bf16 and f16 with ``REPRO_COMPACT`` on and off; the ε-widened
filter never drops a true result (a 200-seed sweep, a hypothesis
property and the executor's own ball filter); ``snapshot_from_reference``
carries the plane; a ``ServingEngine`` keeps it across refreshes.  The
``gpu`` test holds the bf16 / f16 entry points of the ``pdist`` and
``range_filter`` kernels to their plain versions bit for bit; it skips
where there is no card.  The reference is imported inside a fixture, so
that test also runs where JAX is absent.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro_torch.convert import FIELDS, snapshot_from_reference
from repro_torch.core import LIMSIndex, MetricSpace, QueryExecutor
from repro_torch.core.metrics import dist_one_to_many
from repro_torch.core.planner import _BALL_ABS, _R_REL
from repro_torch.core.snapshot import LP_DTYPES, LIMSSnapshot, lp_quant_eps
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels.pdist import pdist_plain
from repro_torch.kernels.range_filter import range_filter_plain
from repro_torch.serving import ServingEngine

N, D = 1200, 6
CPU = "cpu"
# f16's largest finite value is 65,504; this scale puts coordinates past it
F16_OVERFLOW_SCALE = 3e4


def _data(scale: float = 1.0) -> np.ndarray:
    # test_layout.py's corpus: one Gaussian blob, unevenly clustered
    return np.random.default_rng(23).normal(size=(N, D)) * scale


@pytest.fixture(scope="module")
def ref():
    """The reference package's index, executor, snapshot and margin."""
    core = pytest.importorskip("repro.core")
    from repro.core.executor import QueryExecutor as RefExecutor
    from repro.core.snapshot import LIMSSnapshot as RefSnapshot
    from repro.core.snapshot import lp_quant_eps as ref_lp_quant_eps
    return SimpleNamespace(
        index=lambda X: core.LIMSIndex(core.MetricSpace(X, "l2"),
                                       n_clusters=8, m=3, n_rings=10),
        Executor=RefExecutor, Snapshot=RefSnapshot,
        lp_quant_eps=ref_lp_quant_eps)


@pytest.fixture(scope="module")
def corpus(ref):
    """Both packages' index of the same corpus, and the port's f32
    baseline results."""
    X = _data()
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=8, m=3, n_rings=10)
    ref_ix = ref.index(X)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("REPRO_ROWS_DTYPE", raising=False)
        base = _run_queries(QueryExecutor(LIMSSnapshot.build(ix, device=CPU)),
                            X)
    return {"X": X, "ix": ix, "ref_ix": ref_ix, "base": base}


@pytest.fixture
def ref_lane(monkeypatch, ref):
    """The reference in its interpret lane with the host-driven kNN
    rounds, the driver the port has."""
    monkeypatch.setenv("REPRO_INTERPRET", "on")
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_KNN_DRIVER", "rounds")
    return ref


def _queries(X, n_q, seed=2, scale=0.004):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n_q)] + rng.normal(0, scale, (n_q, D))


def _radii(X, Q, sel=0.02):
    return np.array([float(np.quantile(dist_one_to_many(q, X, "l2"), sel))
                     for q in Q])


def _run_queries(ex, X):
    """One range + one kNN batch (test_layout.py's)."""
    Q = _queries(X, 5, seed=7)
    rr = ex.range_query_batch(Q, _radii(X, Q))
    kk = ex.knn_query_batch(Q, 9)
    return rr, kk


def _assert_same(a, b):
    assert len(a[0]) == len(b[0])
    for (ai, ad), (bi, bd) in zip(a[0], b[0]):
        assert np.array_equal(ai, bi)
        assert np.array_equal(ad, bd)
    assert np.array_equal(a[1][0], b[1][0])
    assert np.array_equal(a[1][1], b[1][1])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _ref_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


# ---------------------------------------------------------------- the plane
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_rounding_bits_equal_jnp(dtype):
    """``tensor.to(bf16 / f16)`` and ``jnp.astype`` round every f32 to
    the same bits: ties to even, subnormals, overflow to inf."""
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(3)
    x = rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(
        -8, 6, 4096)
    u = x.view(np.uint32)
    # exact ties at bf16's and at f16's rounding point, both parities
    ties = np.concatenate([(u[:64] & 0xFFFF0000) | 0x8000,
                           (u[64:128] & 0xFFFFE000) | 0x1000]
                          ).astype(np.uint32).view(np.float32)
    x = np.concatenate([x, ties, np.float32([0.0, -0.0, 65504.0, 65519.0,
                                             65520.0, 1e5, -1e5, 3e-8,
                                             np.inf, -np.inf])])
    got = _bits(torch.from_numpy(x).to(LP_DTYPES[dtype]))
    want = _ref_bits(jnp.asarray(x).astype(
        {"bf16": jnp.bfloat16, "f16": jnp.float16}[dtype]))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype,scale", [("bf16", 1.0), ("f16", 1.0),
                                         ("bf16", F16_OVERFLOW_SCALE),
                                         ("f16", F16_OVERFLOW_SCALE)])
def test_plane_bits_and_eps_equal_reference(monkeypatch, ref_lane, dtype,
                                            scale):
    """The plane's bits and ``lp_eps`` equal the reference's; past f16's
    65,504 a coordinate rounds to inf, both margins are inf, and the
    port answers as the reference does there, also at queries beside
    the rows that overflowed (every radius widened to inf, no kNN round
    certifies; a row with an inf coordinate has a NaN distance on the
    plane, which the ball drops in both packages)."""
    X = _data(scale)
    assert scale == 1.0 or np.abs(X).max() > 65504.0
    monkeypatch.setenv("REPRO_ROWS_DTYPE", dtype)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=8, m=3, n_rings=10)
    snap = LIMSSnapshot.build(ix, device=CPU)
    ref = ref_lane.Snapshot.build(ref_lane.index(X))
    assert snap.rows_lp.dtype == LP_DTYPES[dtype]
    assert np.array_equal(_bits(snap.rows_lp), _ref_bits(ref.rows_lp))
    assert snap.lp_eps == ref.lp_eps
    assert snap.lp_eps == lp_quant_eps(snap.rows, snap.rows_lp)
    overflow = dtype == "f16" and scale > 1.0
    assert np.isinf(snap.lp_eps) == overflow
    monkeypatch.setenv("REPRO_ROWS_DTYPE", "off")
    no_plane = LIMSSnapshot.build(ix, device=CPU)
    assert snap.device_nbytes() == \
        no_plane.device_nbytes() + snap.rows_lp.nbytes
    if overflow:
        ex, ref_ex = QueryExecutor(snap), ref_lane.Executor(ref)
        _assert_same(_run_queries(ex, X), _run_queries(ref_ex, X))
        Q = X[np.abs(X).max(axis=1) > 65504.0][:6] + 1.0
        rs = _radii(X, Q)
        _assert_same((ex.range_query_batch(Q, rs), ex.knn_query_batch(Q, 5)),
                     (ref_ex.range_query_batch(Q, rs),
                      ref_ex.knn_query_batch(Q, 5)))


@pytest.mark.parametrize("metric", ["l2", "sql2", "l1", "linf"])
def test_lp_quant_eps_equals_reference(ref, metric):
    rng = np.random.default_rng(11)
    rows = torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32))
    for lp in LP_DTYPES.values():
        q = rows.to(lp)
        want = ref.lp_quant_eps(rows.numpy(),
                                q.to(torch.float64).numpy(), metric)
        assert lp_quant_eps(rows, q, metric) == want
    with pytest.raises(ValueError, match="unknown metric"):
        lp_quant_eps(rows, rows, "cosine")
    with pytest.raises(ValueError, match="unknown metric"):
        ref.lp_quant_eps(rows.numpy(), rows.numpy(), "cosine")
    assert lp_quant_eps(rows[:0], rows[:0], metric) == 0.0


def test_plane_off_is_default_and_absent(monkeypatch, corpus):
    monkeypatch.delenv("REPRO_ROWS_DTYPE", raising=False)
    snap = LIMSSnapshot.build(corpus["ix"], device=CPU)
    assert snap.rows_lp is None and snap.lp_eps == 0.0
    rows, eps = snap.filter_rows()
    assert rows is snap.rows and eps == 0.0
    monkeypatch.setenv("REPRO_ROWS_DTYPE", "f32")
    assert LIMSSnapshot.build(corpus["ix"], device=CPU).rows_lp is None
    monkeypatch.setenv("REPRO_ROWS_DTYPE", "bf17")
    with pytest.raises(ValueError, match="REPRO_ROWS_DTYPE"):
        LIMSSnapshot.build(corpus["ix"], device=CPU)


# ---------------------------------------------------------------- results
@pytest.mark.parametrize("compact", ["on", "off"])
@pytest.mark.parametrize("dtype", ["off", "f32", "bf16", "f16"])
def test_results_equal_reference_and_baseline(monkeypatch, ref_lane,
                                              corpus, dtype, compact):
    """Range and kNN ids and f64 distances equal the reference
    executor's on its own plane and the port's f32 baseline."""
    X = corpus["X"]
    monkeypatch.setenv("REPRO_ROWS_DTYPE", dtype)
    monkeypatch.setenv("REPRO_COMPACT", compact)
    snap = LIMSSnapshot.build(corpus["ix"], device=CPU)
    ref = ref_lane.Snapshot.build(corpus["ref_ix"])
    assert (snap.rows_lp is None) == (dtype in ("off", "f32"))
    assert snap.lp_eps == ref.lp_eps
    ex = QueryExecutor(snap)
    got = _run_queries(ex, X)
    _assert_same(got, _run_queries(ref_lane.Executor(ref), X))
    _assert_same(got, corpus["base"])
    assert ex.last_driver == "rounds"


def test_snapshot_from_reference_carries_plane(monkeypatch, ref_lane,
                                               corpus):
    X = corpus["X"]
    for dtype in ("bf16", "f16"):
        monkeypatch.setenv("REPRO_ROWS_DTYPE", dtype)
        ref = ref_lane.Snapshot.build(corpus["ref_ix"])
        arrays = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
        arrays.update(rows_lp=_ref_bits(ref.rows_lp), rows_lp_dtype=dtype,
                      lp_eps=ref.lp_eps)
        carried = snapshot_from_reference(arrays, CPU)
        assert carried.rows_lp.dtype == LP_DTYPES[dtype]
        assert np.array_equal(_bits(carried.rows_lp), _ref_bits(ref.rows_lp))
        assert carried.filter_rows() == (carried.rows_lp, ref.lp_eps)
        _assert_same(_run_queries(QueryExecutor(carried), X),
                     corpus["base"])
    arrays["rows_lp"] = np.asarray(ref.rows_lp, np.float32)
    with pytest.raises(TypeError, match="uint16"):
        snapshot_from_reference(arrays, CPU)


def test_paged_tier_drops_the_plane(monkeypatch, corpus, tmp_path):
    """A store-backed snapshot keeps no rows on the device, the plane
    included (the reference's ``with_store`` and cold ``load``); a
    resident load makes the plane again."""
    monkeypatch.setenv("REPRO_ROWS_DTYPE", "bf16")
    snap = LIMSSnapshot.build(corpus["ix"], device=CPU)
    snap.spill(str(tmp_path))
    cold = LIMSSnapshot.load(str(tmp_path), store=True, device=CPU)
    assert cold.rows_lp is None and cold.lp_eps == 0.0
    view = snap.with_store(cold.store)
    assert view.rows_lp is None and view.lp_eps == 0.0
    res = LIMSSnapshot.load(str(tmp_path), device=CPU)
    assert torch.equal(res.rows_lp, snap.rows_lp)
    assert res.lp_eps == snap.lp_eps
    _assert_same(_run_queries(QueryExecutor(cold), corpus["X"]),
                 corpus["base"])


# ------------------------------------------------------- never drops a hit
def _lp_never_drops(seed: int) -> None:
    """For rows quantized to bf16, d(q, x_lp) ≤ d(q, x) + eps, so the
    ε-widened ball keeps every true result of the exact ball."""
    rng = np.random.default_rng(seed)
    n, d = int(rng.integers(4, 200)), int(rng.integers(1, 12))
    scale = 10.0 ** rng.integers(-3, 4)
    rows = rng.normal(scale=scale, size=(n, d))
    rows32 = torch.from_numpy(rows.astype(np.float32))
    lp = rows32.to(torch.bfloat16)
    eps = lp_quant_eps(rows32, lp, "l2")
    q = rng.normal(scale=scale, size=d)
    d_true = dist_one_to_many(q, rows, "l2")
    d_lp = np.sqrt(((q - lp.to(torch.float64).numpy()) ** 2).sum(axis=1))
    r = float(np.quantile(d_true, rng.uniform(0.05, 0.95)))
    assert not ((d_true <= r) & ~(d_lp <= r + eps)).any(), seed


def test_widened_filter_never_drops_sweep():
    for seed in range(200):
        _lp_never_drops(seed)


@settings(max_examples=200, deadline=None)
@given(st.integers(min_value=0, max_value=10_000_000))
def test_widened_filter_never_drops_property(seed):
    _lp_never_drops(seed)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_ball_filter_is_superset_of_exact_ball(monkeypatch, corpus, dtype):
    """The executor's ε-widened ball filter over the plane holds every
    live row inside each query's exact ball."""
    X = corpus["X"]
    monkeypatch.setenv("REPRO_ROWS_DTYPE", dtype)
    snap = LIMSSnapshot.build(corpus["ix"], device=CPU)
    ex = QueryExecutor(snap)
    Q = _queries(X, 6, seed=13)
    rs = _radii(X, Q, sel=0.05)
    ball = ex._ball_filter(torch.from_numpy(Q.astype(np.float32)),
                           torch.from_numpy(rs.astype(np.float32))).numpy()
    rows = snap.rows_np.reshape(-1, D)
    for b, q in enumerate(Q):
        inside = (np.sqrt(((q - rows) ** 2).sum(axis=1)) <= rs[b]) \
            & snap.valid_np
        assert inside.any() and not (inside & ~ball[b]).any()


# ----------------------------------------------------------------- serving
def test_serving_refresh_keeps_plane(monkeypatch):
    """Each generation an engine builds under the knob carries a plane
    of its own rows and answers as the host index does."""
    monkeypatch.setenv("REPRO_ROWS_DTYPE", "bf16")
    rng = np.random.default_rng(5)
    X = _data()
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=8, m=3, n_rings=10)
    se = ServingEngine(ix, refresh_every=0, device=CPU)
    for _ in range(2):
        new = X[rng.choice(N, 10)] + rng.normal(0, 0.02, (10, D))
        for row in new:
            se.insert(row)
        se.delete(X[int(rng.integers(N))])
        se.refresh()
        snap = se.snapshot
        assert snap.rows_lp is not None
        assert torch.equal(snap.rows_lp, snap.rows.to(torch.bfloat16))
        assert snap.lp_eps == lp_quant_eps(snap.rows, snap.rows_lp)
        Q = _queries(X, 6, seed=int(rng.integers(100)))
        rs = _radii(X, Q)
        for (ids, ds), q, r in zip(se.range_query_batch(Q, rs), Q, rs):
            h_ids, h_ds, _ = ix.range_query(q, r)
            assert set(map(int, ids)) == set(map(int, h_ids))
            assert np.array_equal(np.sort(ds), np.sort(h_ds))
        ids, ds = se.knn_query_batch(Q, 5)
        for b, q in enumerate(Q):
            assert np.array_equal(ds[b], ix.knn_query(q, 5)[1])


# ------------------------------------------------------------- on the card
# (d, np, offset): the register bodies (d 8, 32) and the body for any
# other width (1, 4, 33, 128), point counts that are not multiples of 4
# or of 128, and at d 8 a plane 2 bytes off the 16-B grid (offset 1),
# which takes the body for any width
LP_CARD_CASES = ([(d, n, 0) for d in (1, 4, 8, 32, 33, 128)
                  for n in (1, 127, 1001, 4099)]
                 + [(8, 1001, 1), (8, 4099, 1)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("d,npts,offset", LP_CARD_CASES)
def test_lp_kernels_match_plain_on_card(dtype, d, npts, offset):
    """The bf16 / f16 entry points of ``pdist`` and ``range_filter``
    against their plain versions bit for bit, with a NaN and a far row
    among the points, through ``ops`` (range_filter padded to whole
    tiles) and through the kernel's own wrapper with each radius set
    exactly at one of its query's cells; only the 2-byte entries
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import range_filter as rf_mod
    dev = torch.device("cuda")
    lp = LP_DTYPES[dtype]
    rng = np.random.default_rng(10 * npts + d)
    nq = 37
    q = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32)).to(dev)
    flat = torch.from_numpy(rng.normal(size=npts * d + offset).astype(
        np.float32)).to(dev).to(lp)
    p = flat[offset:].view(npts, d)
    if npts >= 3:
        p[npts // 2, d // 2] = float("nan")
        p[npts - 2] = ops.far_rows(1, p)[0]
    _cuda.reset_launches()
    d2 = ops.pdist(q, p)
    want = pdist_plain(q, p)
    nan = torch.isnan(want)
    assert d2.dtype == torch.float32 and torch.equal(torch.isnan(d2), nan)
    assert torch.equal(torch.where(nan, 0.0, d2), torch.where(nan, 0.0, want))
    rows = torch.arange(nq, device=dev)
    j = torch.from_numpy(rng.integers(0, npts, nq)).to(dev)
    r2 = want[rows, j]
    r2 = torch.where(torch.isfinite(r2), r2, torch.ones_like(r2))
    mask, cnt = rf_mod.range_filter(q, p, r2)
    m_p, c_p = range_filter_plain(q, p, r2)
    assert torch.equal(mask, m_p) and torch.equal(cnt, c_p)
    r = torch.from_numpy(rng.uniform(1.0, 4.0, nq).astype(np.float32)).to(
        dev) * (1.0 + _R_REL) + _BALL_ABS
    mask, cnt = ops.range_filter(q, p, r)
    m_p, c_p = range_filter_plain(q, p, r * r)
    assert torch.equal(mask, m_p) and torch.equal(cnt, c_p)
    torch.cuda.synchronize()
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
        f"pdist_{dtype}": 1, f"range_filter_{dtype}": 2}
