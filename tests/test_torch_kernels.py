"""The port's kernel layer against the reference's, on the same inputs.

Inputs are made with numpy from a seed and handed to both packages: the
reference runs ``repro.kernels.ops`` through its Pallas kernels in
interpret mode (``REPRO_INTERPRET=on``) plus ``repro.kernels.ref``; the
port runs ``repro_torch.kernels.ops`` on CPU tensors, i.e. each
kernel's plain PyTorch version.  The hand-written CUDA kernels
themselves are held against those plain versions by the ``gpu``-marked
test at the end, which skips where there is no card.  The reference is
imported inside fixtures, so that test also runs where JAX is absent.
"""
import ctypes
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels.fused import pdist_rankeval_plain
from repro_torch.kernels.pdist import (METRICS, gram_sq_plain,
                                       pdist_l1_plain, pdist_linf_plain,
                                       pdist_plain)
from repro_torch.kernels.range_filter import range_filter_plain
from repro_torch.kernels.rankeval import rank_math_plain


@pytest.fixture
def ref_ops(monkeypatch):
    """The reference's kernel wrappers, run through its Pallas kernels
    in interpret mode."""
    monkeypatch.setenv("REPRO_INTERPRET", "on")
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    return pytest.importorskip("repro.kernels.ops")


@pytest.fixture
def ref_ref():
    """The reference's jnp oracles."""
    return pytest.importorskip("repro.kernels.ref")


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rank_inputs(g, b, c, seed=3):
    rng = np.random.default_rng(seed)
    coef = (rng.normal(size=(g, c)) * 10).astype(np.float32)
    x = rng.uniform(0.0, 2.0, size=(g, b)).astype(np.float32)
    lo = np.zeros(g, np.float32)
    hi = np.full(g, 2.0, np.float32)
    n = np.full(g, 500.0, np.float32)
    return x, coef, lo, hi, n


# ---------------------------------------------------------------- pdist
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nq,npts,d", [(64, 128, 8), (137, 301, 33),
                                       (1, 257, 128), (128, 128, 4),
                                       (137, 4099, 8), (65, 1001, 8)])
def test_pdist_matches_reference(ref_ops, nq, npts, d, bf16):
    q = _normal((nq, d), 1)
    p = _normal((npts, d), 2)
    if bf16:        # both sides see the same bf16-rounded values
        q = _t(q).to(torch.bfloat16).float().numpy()
        p = _t(p).to(torch.bfloat16).float().numpy()
    want = np.asarray(ref_ops.pdist(q, p, "sql2"))
    got = ops.pdist(_t(q), _t(p)).numpy()
    # the reference's own kernel-vs-oracle tolerance (test_kernels.py)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * d)
    np.testing.assert_allclose(got, ref.pdist_ref(_t(q), _t(p)).numpy(),
                               rtol=1e-4, atol=1e-4 * d)
    assert (got >= 0).all()


@pytest.mark.parametrize("metric", ["l1", "linf"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nq,npts,d", [(64, 128, 8), (137, 301, 33),
                                       (1, 257, 128), (128, 128, 4)])
def test_pdist_lp_matches_reference(ref_ops, ref_ref, nq, npts, d, bf16,
                                    metric):
    """L1 and L-infinity against the reference's Pallas bodies and both
    oracles.  linf is a max of exact differences, so it is equal; l1
    sums d nonnegative f32 terms in another order, so the two differ by
    at most d * 2**-24 relative."""
    q = _normal((nq, d), 1)
    p = _normal((npts, d), 2)
    if bf16:
        q = _t(q).to(torch.bfloat16).float().numpy()
        p = _t(p).to(torch.bfloat16).float().numpy()
    got = ops.pdist(_t(q), _t(p), metric).numpy()
    for want in (np.asarray(ref_ops.pdist(q, p, metric)),
                 np.asarray(ref_ref.pdist_ref(q, p, metric)),
                 ref.pdist_ref(_t(q), _t(p), metric).numpy()):
        if metric == "linf":
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=d * 2.0 ** -24)


@pytest.fixture
def ref_jnp():
    return pytest.importorskip("jax.numpy")


@pytest.mark.parametrize("metric", ["sql2", "l1", "linf"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nq,npts,d", [(64, 128, 8), (137, 301, 33),
                                       (1, 257, 128), (128, 128, 4)])
def test_pdist_operand_types_match_reference(ref_ops, ref_jnp, metric,
                                             dtype, nq, npts, d):
    """``ops.pdist`` on operands of the type itself (bf16 tensors in the
    port, jnp bf16 arrays in the reference), at the shapes and
    tolerances of ``tests/test_kernels.py::test_pdist_matches_ref``:
    1e-4 in f32, 5e-2 in bf16 (relative, and times d absolute)."""
    q, p = _normal((nq, d), 1), _normal((npts, d), 2)
    types = {"f32": (torch.float32, ref_jnp.float32),
             "bf16": (torch.bfloat16, ref_jnp.bfloat16)}[dtype]
    got = ops.pdist(_t(q).to(types[0]), _t(p).to(types[0]), metric)
    want = ref_ops.pdist(ref_jnp.asarray(q, types[1]),
                         ref_jnp.asarray(p, types[1]), metric)
    tol = 1e-4 if dtype == "f32" else 5e-2
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * d)


@settings(max_examples=25, deadline=None)
@given(nq=st.integers(1, 200), npts=st.integers(1, 300),
       d=st.integers(1, 64),
       metric=st.sampled_from(["sql2", "l1", "linf"]))
def test_pdist_property_matches_reference(nq, npts, d, metric):
    """``tests/test_kernels.py::test_pdist_property`` for the port: f32
    at any shape within 1e-4 relative / 1e-3 absolute of the
    reference's oracle, and never negative."""
    ref_ref = pytest.importorskip("repro.kernels.ref")
    q, p = _normal((nq, d), nq), _normal((npts, d), npts + 1)
    got = ops.pdist(_t(q), _t(p), metric).numpy()
    want = np.asarray(ref_ref.pdist_ref(q, p, metric))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert (got >= -1e-6).all()


@pytest.mark.parametrize("metric", ["l1", "linf"])
def test_pdist_lp_nan_rows(ref_ops, metric):
    """A NaN operand gives NaN in its row and column, as ``jnp.sum`` and
    ``jnp.max`` give; a max written with fmaxf would drop it."""
    q = _normal((5, 8), 3)
    p = _normal((40, 8), 4)
    q[1, 6] = np.nan
    p[17, 0] = np.nan
    want = np.asarray(ref_ops.pdist(q, p, metric))
    got = ops.pdist(_t(q), _t(p), metric).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and np.isnan(got[:, 17]).all()
    assert np.isnan(got).sum() == 40 + 5 - 1
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=8 * 2.0 ** -24)


def test_pdist_unknown_metric_rejected():
    with pytest.raises(ValueError, match="metric"):
        ops.pdist(torch.zeros(2, 3), torch.zeros(4, 3), "l3")


@pytest.mark.parametrize("metric", ["l1", "linf"])
@pytest.mark.parametrize("G,nq,npts,d", [(3, 5, 40, 8), (4, 37, 301, 33),
                                         (2, 1, 129, 202)])
def test_pdist_grouped_matches_per_group(ref_ops, G, nq, npts, d, metric):
    """The grouped plain version (``ops.pdist_grouped`` on the CPU)
    equals the per-group plain version bit for bit, NaN cells included,
    and each group equals the reference's ``pdist_pallas`` at the
    tolerances of test_pdist_lp_matches_reference: linf equal, l1 within
    d * 2**-24 relative (another summation order)."""
    q = _normal((G, nq, d), 5)
    p = _normal((G, npts, d), 6)
    p[G - 1, npts // 2, d // 2] = np.nan
    q[0, nq - 1, 0] = np.nan
    got = ops.pdist_grouped(_t(q), _t(p), metric)
    assert got.shape == (G, nq, npts) and got.dtype == torch.float32
    plain = METRICS[metric][1]
    for g in range(G):
        assert _same(got[g], plain(_t(q[g]), _t(p[g])))
        want = np.asarray(ref_ops.pdist(q[g], p[g], metric))
        mine = got[g].numpy()
        assert np.array_equal(np.isnan(mine), np.isnan(want))
        ok = ~np.isnan(want)
        if metric == "linf":
            assert np.array_equal(mine[ok], want[ok])
        else:
            np.testing.assert_allclose(mine[ok], want[ok],
                                       rtol=d * 2.0 ** -24)
    assert torch.isnan(got[G - 1, :, npts // 2]).all()
    assert torch.isnan(got[0, nq - 1]).all()


@pytest.mark.parametrize("metric", ["sql2", "l2", "cosine", "l3"])
def test_pdist_grouped_rejects_other_metrics(metric):
    with pytest.raises(ValueError, match="metric"):
        ops.pdist_grouped(torch.zeros(2, 3, 4), torch.zeros(2, 5, 4), metric)


@pytest.mark.parametrize("q_shape,p_shape", [((3, 4), (5, 4)),
                                             ((2, 3, 4), (3, 5, 4)),
                                             ((2, 3, 4), (2, 5, 6))])
def test_pdist_grouped_rejects_mismatched_groups(q_shape, p_shape):
    with pytest.raises(ValueError, match="pdist_grouped"):
        ops.pdist_grouped(torch.zeros(q_shape), torch.zeros(p_shape), "l1")


def test_gram_clamp_keeps_nan():
    """``v < 0 ? 0 : v`` keeps a NaN cell NaN (an fmaxf-style clamp
    would turn it into 0), and a far padding row gives +inf."""
    q = np.array([[np.inf, 0.0], [0.5, 0.5]], np.float32)
    p = np.array([[1.0, 1.0], [ops.FAR, ops.FAR]], np.float32)
    d2 = gram_sq_plain(_t(q), _t(p)).numpy()
    assert np.isnan(d2[0, 0])
    assert d2[1, 1] == np.inf
    assert d2[1, 0] == pytest.approx(0.5)


# -------------------------------------------------------------- rankeval
@pytest.mark.parametrize("g,b,c", [(8, 128, 5), (13, 200, 9), (1, 1, 21),
                                   (32, 512, 2)])
def test_rankeval_matches_reference(ref_ops, ref_ref, g, b, c):
    x, coef, lo, hi, n = _rank_inputs(g, b, c)
    rk_ref, rid_ref = (np.asarray(a) for a in
                       ref_ops.rankeval(x, coef, lo, hi, n, n_rings=20))
    rk, rid = (a.numpy() for a in
               ops.rankeval(_t(x), _t(coef), _t(lo), _t(hi), _t(n), 20))
    # Both run rank_math's operation sequence in f32, but XLA may
    # contract a multiply and an add into one FMA, which the port never
    # does; a value that then lands on the other side of a .5 boundary
    # rounds to a neighbouring rank.  So an entry may differ by one
    # rank (and its ring id by one), and only rarely.
    assert np.abs(rk - rk_ref).max() <= 1
    assert np.abs(rid - rid_ref).max() <= 1
    assert np.mean(rk != rk_ref) <= 0.01
    # the independent T_k-recurrence oracle, both packages
    rk_o, rid_o = (a.numpy() for a in
                   ref.rankeval_ref(_t(x), _t(coef), _t(lo), _t(hi), _t(n)))
    rk_oo, _ = ref_ref.rankeval_ref(x, coef, lo, hi, n)
    assert np.abs(rk - rk_o).max() <= 1 and np.abs(rid - rid_o).max() <= 1
    assert np.abs(rk_o - np.asarray(rk_oo)).max() <= 1


def test_rankeval_matches_host_model():
    """Kernel model inference == the host PolyRankModel used by LIMS."""
    from repro_torch.core.rankmodel import PolyRankModel
    rng = np.random.default_rng(0)
    col = np.sort(rng.gamma(2.0, 1.0, size=1000))
    model = PolyRankModel.fit(col, degree=8)
    xs = rng.uniform(col[0], col[-1], size=128)
    want = np.array([model.predict_scalar(float(v)) for v in xs])
    coef = np.asarray(model.coef, np.float32)[None]
    rk, _ = ops.rankeval(_t(xs[None].astype(np.float32)), _t(coef),
                         torch.tensor([model.lo], dtype=torch.float32),
                         torch.tensor([model.hi], dtype=torch.float32),
                         torch.tensor([model.n], dtype=torch.float32))
    assert np.abs(rk.numpy()[0] - want).max() <= 1   # f32 vs f64 rounding


# ----------------------------------------------------------- range_filter
@pytest.mark.parametrize("nq,npts,d", [(64, 256, 16), (137, 301, 33),
                                       (5, 45, 8), (3, 1, 4),
                                       (137, 4099, 8), (65, 1001, 8)])
def test_range_filter_matches_reference(ref_ops, ref_ref, nq, npts, d):
    """Mask equal to the reference kernel's; counts equal to the
    reference oracle's per 128-point tile, including the last tile,
    which is partly padding unless npts is a multiple of 128."""
    q = _normal((nq, d), 5)
    p = _normal((npts, d), 6)
    r = np.random.default_rng(7).uniform(1.0, 8.0, size=nq).astype(
        np.float32)
    mask, cnt = (a.numpy() for a in ops.range_filter(_t(q), _t(p), _t(r)))
    ref_mask, _ = ref_ops.range_filter(q, p, r)
    _, ref_cnt = ref_ref.range_filter_ref(q, p, r, bp=128)
    assert mask.dtype == np.uint8 and mask.shape == (nq, npts)
    assert cnt.shape == (nq, -(-npts // 128))
    assert np.array_equal(mask, np.asarray(ref_mask))
    assert np.array_equal(cnt, np.asarray(ref_cnt))
    per_tile = np.pad(mask, ((0, 0), (0, (-npts) % 128))).reshape(
        nq, -1, 128).sum(-1)
    assert np.array_equal(cnt, per_tile)
    # the port's own oracle agrees too
    o_mask, o_cnt = ref.range_filter_ref(_t(q), _t(p), _t(r))
    assert np.array_equal(mask, o_mask.numpy())
    assert np.array_equal(cnt, o_cnt.numpy())


def test_range_filter_far_and_nan_rows_never_hit():
    """Rows at the far padding value and rows whose distance is NaN are
    never hits, whatever the radius, and never counted."""
    q = _normal((4, 8), 8)
    p = _normal((200, 8), 9)
    p[10] = ops.FAR
    p[150, 3] = np.nan
    r = np.full(4, 1e6, np.float32)         # every finite row is a hit
    mask, cnt = (a.numpy() for a in ops.range_filter(_t(q), _t(p), _t(r)))
    assert (mask[:, 10] == 0).all() and (mask[:, 150] == 0).all()
    assert mask.sum() == 4 * 198
    assert cnt.tolist() == [[127, 71]] * 4
    m_plain, c_plain = range_filter_plain(_t(q), _t(p), _t(r * r))
    assert np.array_equal(mask, m_plain.numpy())
    assert np.array_equal(cnt, c_plain.numpy())


# ---------------------------------------------------- fused vs staged
def _plan_inputs(B=37, G=30, d=8, C=9, seed=10):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, (B, d)).astype(np.float32)
    piv = rng.uniform(0, 1, (G, d)).astype(np.float32)
    coef = (rng.normal(size=(G, C)) * 50).astype(np.float32)
    coef[:, 0] += 250.0
    lo = rng.uniform(0, 0.2, G).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 1.5, G)).astype(np.float32)
    n = rng.integers(1, 600, G).astype(np.float32)
    rg = rng.uniform(0.0, 0.3, B).astype(np.float32)
    return q, piv, coef, lo, hi, n, rg


def _staged(q, piv, coef, lo, hi, n, rg):
    """The planner's staged chain: pdist -> sqrt -> rankeval on the
    (G, 2B) boundary matrix, split back into halves."""
    B = q.shape[0]
    dq = torch.sqrt(torch.clamp(ops.pdist(q, piv), min=0.0))
    x = torch.cat([(dq - rg[:, None]).T, (dq + rg[:, None]).T], dim=1)
    rank, _ = ops.rankeval(x, coef, lo, hi, n, n_rings=20)
    return dq, rank[:, :B], rank[:, B:]


def test_fused_matches_staged_bitwise():
    args = [_t(a) for a in _plan_inputs()]
    fused = ops.pdist_rankeval(*args, n_rings=20)
    staged = _staged(*args)
    for f, s in zip(fused, staged):
        assert f.dtype == s.dtype
        assert torch.equal(f, s)
    assert fused[0].shape == (37, 30) and fused[1].shape == (30, 37)


def test_fused_matches_reference_fused(ref_ops):
    """The port's fused stage against the reference's fused Pallas
    kernel: dq allclose (different Gram accumulation order), ranks
    within one (see test_rankeval_matches_reference)."""
    a = _plan_inputs(seed=12)
    dq_r, lo_r, hi_r = (np.asarray(v) for v in
                        ref_ops.pdist_rankeval(*a, n_rings=20))
    dq, lo, hi = (v.numpy() for v in
                  ops.pdist_rankeval(*[_t(x) for x in a], n_rings=20))
    np.testing.assert_allclose(dq, dq_r, rtol=1e-5, atol=1e-5)
    assert np.abs(lo - lo_r).max() <= 1 and np.abs(hi - hi_r).max() <= 1


# ----------------------------------- NaN, infinite and far distances
# Distances the planner can meet besides finite ones: NaN (the Gram cell
# of a NaN or infinite coordinate, which the clamp keeps, see
# test_gram_clamp_keeps_nan), +-inf and far values.
ODD = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, np.nan], np.float32)


def _odd_rank_inputs(g, b, c):
    x, coef, lo, hi, n = _rank_inputs(g, b, c, seed=7)
    cells = np.random.default_rng(8).choice(g * b, size=min(g * b, 24),
                                            replace=False)
    x.flat[cells] = np.resize(ODD, len(cells))
    x[0, :min(b, len(ODD))] = ODD[:b]
    return x, coef, lo, hi, n


def _assert_ranks_like_reference(got, want, nan):
    """NaN cells rank 0 in ring 0, exactly as the reference's (XLA turns
    a NaN into int32 0); every other cell within one rank, as in
    test_rankeval_matches_reference."""
    assert nan.any()
    for a, r in zip(got, want):
        assert (r[nan] == 0).all()
        assert np.array_equal(a[nan], r[nan])
        assert np.abs(a.astype(np.int64) - r).max() <= 1


@pytest.mark.parametrize("g,b,c", [(8, 128, 9), (13, 200, 2), (3, 7, 1)])
def test_rankeval_odd_distances_match_reference(ref_ops, g, b, c):
    """rankeval on NaN, +-inf and 1e30 distances against the reference's
    Pallas kernel: a NaN ranks 0 in ring 0 (the port used to give
    INT_MIN here), +-inf and 1e30 clip to the model's ends."""
    x, coef, lo, hi, n = _odd_rank_inputs(g, b, c)
    want = [np.asarray(a) for a in
            ref_ops.rankeval(x, coef, lo, hi, n, n_rings=20)]
    got = [a.numpy() for a in
           ops.rankeval(_t(x), _t(coef), _t(lo), _t(hi), _t(n), 20)]
    _assert_ranks_like_reference(got, want, np.isnan(x))


def test_fused_odd_queries_match_reference(ref_ops):
    """pdist_rankeval against the reference's fused Pallas kernel with a
    NaN coordinate (NaN dq), an infinite one (inf - inf: NaN dq), 1e30
    coordinates (dq = inf) and an infinite radius: dq equal where NaN or
    infinite, a NaN dq ranks 0 at both ends, the rest within one rank."""
    q, piv, coef, lo, hi, n, rg = _plan_inputs(seed=13)
    q[0, 3] = np.nan
    q[1, :] = 1e30
    q[2, 5] = np.inf
    rg[3] = np.inf
    dq_r, lo_r, hi_r = (np.asarray(v) for v in ref_ops.pdist_rankeval(
        q, piv, coef, lo, hi, n, rg, n_rings=20))
    dq, rk_lo, rk_hi = (v.numpy() for v in ops.pdist_rankeval(
        *[_t(a) for a in (q, piv, coef, lo, hi, n, rg)], n_rings=20))
    np.testing.assert_allclose(dq, dq_r, rtol=1e-5, atol=1e-5)
    assert np.isnan(dq[[0, 2]]).all() and np.isposinf(dq[1]).all()
    _assert_ranks_like_reference([rk_lo, rk_hi], [lo_r, hi_r],
                                 np.isnan(dq_r).T)


# ------------------------------------------------------ launch counters
def test_cpu_tensors_launch_nothing():
    """On CPU tensors every wrapper takes the plain version: no kernel
    is built or launched, so the launch counters stay put."""
    before = dict(_cuda.LAUNCHES)
    a = [_t(x) for x in _plan_inputs()]
    ops.pdist(a[0], a[1])
    ops.pdist(a[0], a[1], "l1")
    ops.pdist(a[0], a[1], "linf")
    ops.pdist_grouped(a[0][None], a[1][None], "l1")
    ops.pdist_grouped(a[0][None], a[1][None], "linf")
    ops.range_filter(a[0], a[1], a[6])
    for lp in (torch.bfloat16, torch.float16):
        ops.pdist(a[0], a[1].to(lp))
        ops.range_filter(a[0], a[1].to(lp), a[6])
    ops.pdist_rankeval(*a)
    _staged(*a)
    q = torch.from_numpy(_normal((1, 4, 100, 16), 1))
    ops.flash_attention(q, q[:, :2], q[:, :2])
    assert _cuda.LAUNCHES == before
    assert set(_cuda.LAUNCHES) == {"pdist", "pdist_bf16", "pdist_f16",
                                   "rankeval", "range_filter",
                                   "range_filter_bf16", "range_filter_f16",
                                   "pdist_rankeval", "pdist_l1",
                                   "pdist_linf", "flash_attention"}


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: where nvcc cannot be found, building (and so any
    CUDA launch) raises instead of quietly running a plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda, "CUDA_ROOTS", ())
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build(build_dir=tmp_path / "build")


class _FakeCudaDevice:
    """Stands in for ``torch.cuda.device``: records entry and exit."""
    log: list = []

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.log.append(("enter", self.device))

    def __exit__(self, *exc):
        self.log.append(("exit", self.device))
        return False


@pytest.mark.parametrize("current", [0, 1])
@pytest.mark.parametrize("err", [0, 1])
def test_launch_enters_operands_device(monkeypatch, err, current):
    """``_cuda.launch`` hands the entry point the current stream of the
    operands' device (cuda:1) with that device current: inside the
    device's context where another device is current (``current`` 0),
    and with no device switch where it is current already (1).  It
    counts a launch only when the entry point returns 0, and leaves the
    context either way.  ``torch.cuda.device``, ``current_device`` and
    ``current_stream`` are mocked (PyTorch's raw-stream call removed, so
    ``_cuda.current_stream`` asks ``torch.cuda.current_stream``) and the
    entry point is a fake one in ``_FUNCS``, so no card is needed."""
    log = []
    monkeypatch.setattr(_FakeCudaDevice, "log", log)
    monkeypatch.setattr(torch.cuda, "device", _FakeCudaDevice)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream",
                        raising=False)

    def current_stream(device=None):
        log.append(("stream", device))
        return SimpleNamespace(cuda_stream=1000 + torch.device(
            "cuda", device).index)

    def entry(*args):
        log.append(("call", args))
        return err

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setitem(_cuda._FUNCS, ("pdist_l1", None), entry)
    monkeypatch.setitem(_cuda.LAUNCHES, "pdist_l1", 0)
    dev = torch.device("cuda", 1)
    args = (11, 12, 13, 1, 2, 3, 4)
    if err:
        with pytest.raises(RuntimeError, match="pdist_l1"):
            _cuda.launch("pdist_l1", *args, device=dev)
    else:
        _cuda.launch("pdist_l1", *args, device=dev)
    inner = [("stream", 1), ("call", args + (1001,))]
    assert log == ([("enter", 1), *inner, ("exit", 1)] if current == 0
                   else inner)
    assert _cuda.LAUNCHES["pdist_l1"] == (0 if err else 1)


def test_current_stream_takes_the_raw_handle(monkeypatch):
    """Where PyTorch offers the raw ``cudaStream_t`` of a device's current
    stream, ``_cuda.current_stream`` returns it and builds no
    ``torch.cuda.Stream``."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 5000 + index, raising=False)

    def no_stream(*a, **k):
        raise AssertionError("torch.cuda.current_stream was called")

    monkeypatch.setattr(torch.cuda, "current_stream", no_stream)
    assert _cuda.current_stream(3) == 5003


def test_first_launch_loads_once_across_threads(monkeypatch, tmp_path):
    """Threads that launch their first kernels together (an async
    snapshot refresh beside a query thread) build the libraries once:
    ``build``, a slow stub here, runs one time, and no thread finds the
    entry-point table half filled.  ``ctypes.CDLL`` is a stub too, so no
    nvcc or card is needed."""
    builds = []

    def slow_build(*args, **kw):
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return {src: _cuda.Built(src, tmp_path / src, 0.0, "")
                for src in dict.fromkeys(_cuda.SOURCES.values())}

    class FakeLib:
        def __getattr__(self, symbol):
            def entry(*args):
                return 0
            return entry

    monkeypatch.setattr(_cuda, "build", slow_build)
    monkeypatch.setattr(_cuda, "ctypes", SimpleNamespace(
        CDLL=lambda path: FakeLib(), c_int=ctypes.c_int))
    monkeypatch.setattr(_cuda, "_FUNCS", {})
    want = {(name, v) for name in _cuda.SIGNATURES
            for v in _cuda.VARIANTS.get(name, (None,))}
    start = threading.Barrier(4)
    seen = []

    def first_launch():
        start.wait(timeout=10)
        _cuda._load()
        seen.append(set(_cuda._FUNCS))

    threads = [threading.Thread(target=first_launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(builds) == 1
    assert seen == [want] * 4


def test_mixed_devices_rejected():
    with pytest.raises(ValueError):
        ops.pdist(torch.zeros(2, 3), torch.zeros(4, 3, dtype=torch.float64,
                                                 device="meta"))


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the same card
    inputs, bit for bit (each shares its plain version's operation
    order): pdist sql2, l1 and linf, rankeval and range_filter, NaN rows
    included; fused vs staged bitwise; one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    _cuda.reset_launches()
    q, piv, coef, lo, hi, n, rg = (_t(a).to(dev) for a in _plan_inputs())
    p = _t(_normal((1000, 8), 2)).to(dev)
    assert torch.equal(ops.pdist(q, p), pdist_plain(q, p))
    p_nan = p.clone()
    p_nan[17, 3] = float("nan")
    for metric, plain in (("l1", pdist_l1_plain), ("linf", pdist_linf_plain)):
        got = ops.pdist(q, p_nan, metric)
        want = plain(q, p_nan)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.isnan(got[:, 17]).all()
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    x = torch.cat([q[:, :1].T.expand(30, -1), q[:, 1:2].T.expand(30, -1)],
                  dim=1).contiguous()
    rk, rid = ops.rankeval(x, coef, lo, hi, n)
    rk_p, rid_p = rank_math_plain(x, coef, lo, hi, n, 20)
    assert torch.equal(rk, rk_p) and torch.equal(rid, rid_p)
    r = torch.full((37,), 1.2, device=dev)
    mask, cnt = ops.range_filter(q, p, r)
    m_p, c_p = range_filter_plain(q, torch.cat(
        [p, torch.full((24, 8), ops.FAR, device=dev)]), r * r)
    assert torch.equal(mask, m_p[:, :1000]) and torch.equal(cnt, c_p)
    fused = ops.pdist_rankeval(q, piv, coef, lo, hi, n, rg)
    for f, s, pl in zip(fused, _staged(q, piv, coef, lo, hi, n, rg),
                        pdist_rankeval_plain(q, piv, coef, lo, hi, n, rg,
                                             20)):
        assert torch.equal(f, s) and torch.equal(f, pl)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {"pdist": 2, "rankeval": 2, "range_filter": 1,
                              "pdist_rankeval": 1, "pdist_l1": 1,
                              "pdist_linf": 1, "flash_attention": 0,
                              "pdist_bf16": 0, "pdist_f16": 0,
                              "range_filter_bf16": 0, "range_filter_f16": 0}


def _same(got, want):
    """Equal bit for bit, NaN where the other is NaN."""
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.nan_to_num(got, nan=-1.0),
                            torch.nan_to_num(want, nan=-1.0)))


# (nq, np, d) for the streaming pdist and range_filter: query counts on
# both sides of the 64-row chunk a block holds (65 and 137 cross it),
# point counts that are not multiples of 4 (rows not 16-B aligned) or of
# 128 (a partial count tile), the register bodies (d 8, 32) and the body
# for any other width (4, 16, 33, 128)
STREAM_CASES = ([(nq, n, 8) for nq in (1, 37, 48, 64, 65, 137)
                 for n in (1, 127, 192, 1001, 4099)]
                + [(37, n, d) for d in (4, 16, 32, 33, 128)
                   for n in (127, 4099)]
                + [(65, 1001, 32), (137, 4099, 32)])


@pytest.mark.gpu
@pytest.mark.parametrize("nq,npts,d", STREAM_CASES)
def test_streaming_kernels_match_plain_on_card(nq, npts, d):
    """pdist and range_filter against their plain versions, bit for bit,
    at ragged shapes, with a NaN point row and a ``FAR`` row: pdist's
    matrix, and range_filter's mask and counts through the kernel's own
    wrapper (no padding: np as given) with each query's squared radius
    set exactly at one of its cells' d2, so ``<=`` is tested on the
    boundary, and through ``ops.range_filter`` (padded to whole tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import range_filter as rf_mod
    dev = torch.device("cuda")
    rng = np.random.default_rng(1000 * nq + 10 * npts + d)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    p = rng.normal(size=(npts, d)).astype(np.float32)
    if npts >= 3:
        p[npts // 2, d // 2] = np.nan
        p[npts - 2] = ops.FAR
    q, p = _t(q).to(dev), _t(p).to(dev)
    _cuda.reset_launches()
    d2 = ops.pdist(q, p)
    want = pdist_plain(q, p)
    assert d2.shape == (nq, npts) and _same(d2, want)
    rows = torch.arange(nq, device=dev)
    j = torch.from_numpy(rng.integers(0, npts, nq)).to(dev)
    r2 = want[rows, j]
    r2 = torch.where(torch.isfinite(r2), r2, torch.ones_like(r2))
    mask, cnt = rf_mod.range_filter(q, p, r2)
    m_p, c_p = range_filter_plain(q, p, r2)
    assert mask.shape == (nq, npts) and cnt.shape == (nq, -(-npts // 128))
    assert torch.equal(mask, m_p) and torch.equal(cnt, c_p)
    on_edge = torch.isfinite(want[rows, j])
    assert bool((mask[rows, j][on_edge] == 1).all())
    r = torch.from_numpy(rng.uniform(1.0, 4.0, nq).astype(np.float32)).to(
        dev)
    mask, cnt = ops.range_filter(q, p, r)
    m_p, c_p = range_filter_plain(q, p, r * r)
    assert torch.equal(mask, m_p) and torch.equal(cnt, c_p)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["pdist"] == 1
    assert _cuda.LAUNCHES["range_filter"] == 2


# (G, nq, np, d) for the streaming pdist_l1 / pdist_linf: query counts
# on both sides of the 64-row chunk (65 and 137 cross it), point counts
# not multiples of 4 (rows not 16-B aligned, scalar stores) and a
# ragged last block, the register bodies (d 8, 32) and the body for any
# other width, up to widths whose old shared-memory tile failed to
# launch (d >= 202; 784 is MNIST's); G = 1 through ops.pdist, G > 1
# through ops.pdist_grouped, the builder's (64, 3, n_max) among them
LP_CASES = ([(1, nq, n, 8) for nq in (1, 37, 64, 65, 137)
             for n in (1, 127, 1001, 4099)]
            + [(1, 37, n, d) for d in (4, 32, 33, 128, 202, 256, 784)
               for n in (127, 1001)]
            + [(1, 137, 1001, 784), (1, 65, 4099, 202),
               (3, 3, 1001, 8), (64, 3, 1024, 8), (5, 65, 127, 33),
               (4, 37, 4099, 256), (2, 137, 257, 784), (7, 3, 512, 202),
               (3, 40, 2048, 32)])


@pytest.mark.gpu
@pytest.mark.parametrize("G,nq,npts,d", LP_CASES)
def test_lp_kernels_match_plain_on_card(G, nq, npts, d):
    """pdist_l1 and pdist_linf against their plain versions on the card,
    bit for bit with NaN cells equal, with a NaN point row and a NaN
    query row; one counted launch a call whatever G."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1000 * nq + 10 * npts + d + G)
    q = rng.normal(size=(G, nq, d)).astype(np.float32)
    p = rng.normal(size=(G, npts, d)).astype(np.float32)
    p[G - 1, npts // 2, d // 2] = np.nan
    if nq >= 2:
        q[0, 1, d - 1] = np.nan
    q, p = _t(q).to(dev), _t(p).to(dev)
    _cuda.reset_launches()
    for metric in ("l1", "linf"):
        kernel, plain = METRICS[metric]
        got = (ops.pdist(q[0], p[0], metric)[None] if G == 1
               else ops.pdist_grouped(q, p, metric))
        want = plain(q, p)
        assert got.shape == (G, nq, npts) and _same(got, want)
        assert torch.isnan(got[G - 1, :, npts // 2]).all()
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[kernel] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 32])
def test_lp_register_and_generic_bodies_agree_on_card(d):
    """At d 8 and 32 the same values 4 bytes past a 16-B boundary take
    the body for any width (Points<0>): bit for bit the register body's
    and the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q = _t(_normal((3, 37, d), 11)).to(dev)
    p = _t(_normal((3, 1001, d), 12)).to(dev)

    def offset(t):          # the same values, 4 bytes off a 16-B boundary
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    for metric in ("l1", "linf"):
        want = METRICS[metric][1](q, p)
        assert _same(ops.pdist_grouped(q, p, metric), want)
        assert _same(ops.pdist_grouped(offset(q), offset(p), metric), want)


@pytest.mark.gpu
def test_rankeval_many_groups_on_card():
    """rankeval at G = 70,000 groups, past the 65,535 a grid's y
    dimension allows: equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    x, coef, lo, hi, n = (_t(a).to(dev) for a in _rank_inputs(70_000, 300, 9))
    _cuda.reset_launches()
    rk, rid = ops.rankeval(x, coef, lo, hi, n, 20)
    rk_p, rid_p = rank_math_plain(x, coef, lo, hi, n, 20)
    assert torch.equal(rk, rk_p) and torch.equal(rid, rid_p)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["rankeval"] == 1


def _offset(t):
    """The same values in a view 4 bytes past a 16-B boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


# (G, B, C) for rankeval: every B % 4 (rows off the 16-B grid, partial
# first and last quads, B < 4), one block's 2,048 values and more,
# coefficient counts with a compiled body (1, 2, 9, 16) and past them (21)
RANK_CASES = ([(g, b, 9) for g in (1, 7, 192) for b in (1, 2, 3, 4, 5, 6,
                                                        7, 2047, 2048, 2053)]
              + [(5, b, c) for c in (1, 2, 16, 21) for b in (4, 1001)]
              + [(192, 71_998, 9)])


@pytest.mark.gpu
@pytest.mark.parametrize("G,B,C", RANK_CASES)
def test_rankeval_matches_plain_on_card(G, B, C):
    """rankeval on the card against rank_math_plain, bit for bit, with
    NaN, +-inf and 1e30 distances among the values, x aligned and in a
    view 4 bytes off the 16-B grid (the value-by-value path): one
    counted launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    x, coef, lo, hi, n = _rank_inputs(G, B, C, seed=G + B + C)
    cells = np.random.default_rng(C).choice(G * B, size=min(G * B, 64),
                                            replace=False)
    x.flat[cells] = np.resize(ODD, len(cells))
    x, coef, lo, hi, n = (_t(a).to(dev) for a in (x, coef, lo, hi, n))
    want = rank_math_plain(x, coef, lo, hi, n, 20)
    for xs in (x, _offset(x)):
        _cuda.reset_launches()
        got = ops.rankeval(xs, coef, lo, hi, n, 20)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["rankeval"] == 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("B,G,C", [(1, 1, 9), (37, 30, 9), (64, 192, 9),
                                   (137, 192, 9), (137, 301, 9),
                                   (64, 192, 21), (9, 17, 1)])
def test_fused_matches_staged_on_card(B, G, C):
    """The fused pdist_rankeval against the staged pdist -> sqrt ->
    rankeval chain and against pdist_rankeval_plain on the card at d =
    8, bit for bit, with a NaN query row (NaN dq) where B > 1: the
    streaming pdist and fused.cu share gram.cuh's operation order and
    rank_math.cuh; (64, 192) is the planner's shape.  One counted launch
    of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    a = _plan_inputs(B=B, G=G, C=C, seed=B + G)
    if B > 1:
        a[0][B // 2, 3] = np.nan
    args = [_t(v).to(dev) for v in a]
    _cuda.reset_launches()
    fused = ops.pdist_rankeval(*args, n_rings=20)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["pdist_rankeval"] == 1
    if B > 1:
        assert torch.isnan(fused[0][B // 2]).all()
    plain = pdist_rankeval_plain(*args, 20)
    for f, s, p in zip(fused, _staged(*args), plain):
        assert _same(f, s) and _same(f, p)
    assert _cuda.LAUNCHES["pdist"] == 1 and _cuda.LAUNCHES["rankeval"] == 1


# (B, Hq, Hk, Sq, Sk, D, causal): GQA and not, padded and not, causal
# with Sq != Sk, every head width the kernel is built for; each in f32
# and bf16
FLASH_CASES = [
    (2, 8, 2, 256, 256, 64, True),
    (1, 4, 4, 100, 100, 32, True),
    (2, 8, 4, 128, 384, 64, False),
    (1, 2, 1, 64, 300, 16, False),
    (2, 32, 8, 200, 200, 128, True),
    (1, 4, 2, 100, 300, 128, True),
    (1, 4, 2, 300, 100, 128, True),
]
# bf16 cases for the tensor-core body, (case, scale of q and k): several
# kv tiles with kv_len inside the last (2000 padded to 2048), Sq != Sk in
# both directions at whole 128-row tiles (the top-left origin), Hq/Hk = 4,
# and q, k scaled by 16 so the scaled scores have a standard deviation of
# ~256, where P holds near-1 and tiny entries and its bf16 hi/lo split
# matters
FLASH_TC_CASES = [
    ((1, 8, 2, 2000, 2000, 128, True), 1.0),
    ((1, 8, 2, 2000, 2000, 128, False), 1.0),
    ((1, 4, 1, 256, 640, 128, True), 1.0),
    ((1, 4, 1, 640, 256, 128, True), 1.0),
    ((2, 16, 4, 384, 384, 128, True), 1.0),
    ((1, 8, 2, 2000, 2000, 128, True), 16.0),
    ((2, 16, 4, 640, 640, 64, True), 16.0),
]
_FLASH_CARD = ([(c, 1.0, dt) for c in FLASH_CASES
                for dt in (torch.float32, torch.bfloat16)]
               + [(c, scale, torch.bfloat16) for c, scale in FLASH_TC_CASES])


@pytest.mark.gpu
@pytest.mark.parametrize("case,scale,dtype", _FLASH_CARD)
def test_flash_attention_matches_plain_on_card(case, scale, dtype):
    """The CUDA flash_attention kernel against its plain version
    (``ref.flash_attention_ref``, the same recurrence over 128-wide kv
    blocks) on the same card inputs, through ``ops.flash_attention``
    (padding, kv_len): f32 within 1e-4 absolute (summation order and kv
    tile width differ), bf16 within one bf16 ulp (rtol = atol = 2**-7:
    both round an f32 value to bf16 once; bf16 at D 64 and 128 runs on
    the tensor cores, with P split into bf16 hi + lo); one counted launch
    per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, hq, hk, sq, sk, d, causal = case
    dev = torch.device("cuda")
    _cuda.reset_launches()
    q, k, v = (_t(_normal(s, seed) * f).to(dev, dtype) for s, seed, f in
               (((b, hq, sq, d), 7, scale), ((b, hk, sk, d), 8, scale),
                ((b, hk, sk, d), 9, 1.0)))
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, hq, sq, d)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0
                               if dtype == torch.float32 else tol, atol=tol)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == 1


def _tc_body_emulation(q, k, v, causal, kv_len, p_split=True):
    """The tensor-core body's rounding steps in plain torch: S from the
    bf16 operands accumulated in f32 (each product exact), then scaled in
    f32 by log2(e)/sqrt(D) rounded once to f32; the online softmax over
    128-wide kv tiles in base 2 (exp2); P split into bf16 hi + lo for
    P V, or with ``p_split=False`` rounded once to bf16 (the one-pass
    alternative).  q, k, v padded bf16 (B, H, S, D) -> bf16."""
    b, hq, sq, d = q.shape
    _, hk, sk, _ = k.shape
    f32 = torch.float32
    qf = q.to(f32).reshape(b, hk, hq // hk, sq, d)
    scale2 = torch.tensor(np.log2(np.e) / np.sqrt(d), dtype=f32)
    m = torch.full((b, hk, hq // hk, sq), -1e30, dtype=f32)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hk, hq // hk, sq, d, dtype=f32)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, 128):
        kb, vb = (t[:, :, k0:k0 + 128].to(f32) for t in (k, v))
        s = torch.einsum("bkgqd,bktd->bkgqt", qf, kb) * scale2
        kpos = k0 + torch.arange(128)[None, :]
        ok = (kpos < kv_len) & ((qpos >= kpos) if causal else True)
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        m = m_new
        hi = p.to(torch.bfloat16).to(f32)
        parts = [hi, (p - hi).to(torch.bfloat16).to(f32)] if p_split else [hi]
        pv = sum(torch.einsum("bkgqt,bktd->bkgqd", x, vb) for x in parts)
        acc = acc * alpha[..., None] + pv
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(torch.bfloat16)


def test_tc_precision_plan_matches_reference(ref_ops):
    """The tensor-core body's precision plan (one bf16 pass for Q K^T,
    scale after, exp2, P as bf16 hi + lo for P V) emulated on the CPU
    against the Pallas kernel in interpret mode, bf16, at scores of
    standard deviation ~256 (q and k scaled by 16), Hq/Hk = 4 and
    Sq = Sk = 300 padded to 384 (kv_len inside the last tile): within
    the card check's 2**-7.  The one-pass-P alternative's error is
    printed beside it, not asserted."""
    import jax.numpy as jnp
    b, hq, hk, s, d = 1, 8, 2, 300, 128
    q, k, v = (_normal(sh, seed) * f for sh, seed, f in
               (((b, hq, s, d), 21, 16.0), ((b, hk, s, d), 22, 16.0),
                ((b, hk, s, d), 23, 1.0)))
    want = np.asarray(ref_ops.flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=True).astype(jnp.float32))
    qt, kt, vt = (torch.nn.functional.pad(
        _t(a).to(torch.bfloat16), (0, 0, 0, 84)) for a in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qt[:, :2].float(),
                          kt[:, :1].float()) / np.sqrt(d)
    assert 200.0 < float(scores[..., :s, :s].std()) < 320.0
    bar = 2.0 ** -7 * (1.0 + np.abs(want))
    got = {}
    for split in (True, False):
        out = _tc_body_emulation(qt, kt, vt, True, s, p_split=split)
        got[split] = out[:, :, :s].float().numpy()
    print("; ".join(
        f"{name}: max |emulation - reference| "
        f"{np.abs(got[split] - want).max():.4g}, max share of the bar "
        f"{(np.abs(got[split] - want) / bar).max():.4g}"
        for name, split in (("P as bf16 hi + lo", True),
                            ("P rounded once", False))))
    np.testing.assert_allclose(got[True], want, rtol=2.0 ** -7,
                               atol=2.0 ** -7)
