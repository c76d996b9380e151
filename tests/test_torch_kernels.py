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
import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels.fused import pdist_rankeval_plain
from repro_torch.kernels.pdist import gram_sq_plain, pdist_plain
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
                                       (1, 257, 128), (128, 128, 4)])
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
                                       (5, 45, 8), (3, 1, 4)])
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


# ------------------------------------------------------ launch counters
def test_cpu_tensors_launch_nothing():
    """On CPU tensors every wrapper takes the plain version: no kernel
    is built or launched, so the launch counters stay put."""
    before = dict(_cuda.LAUNCHES)
    a = [_t(x) for x in _plan_inputs()]
    ops.pdist(a[0], a[1])
    ops.range_filter(a[0], a[1], a[6])
    ops.pdist_rankeval(*a)
    _staged(*a)
    assert _cuda.LAUNCHES == before
    assert set(_cuda.LAUNCHES) == {"pdist", "rankeval", "range_filter",
                                   "pdist_rankeval"}


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: where nvcc cannot be found, building (and so any
    CUDA launch) raises instead of quietly running a plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda, "CUDA_ROOTS", ())
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build(build_dir=tmp_path / "build")


def test_mixed_devices_rejected():
    with pytest.raises(ValueError):
        ops.pdist(torch.zeros(2, 3), torch.zeros(4, 3, dtype=torch.float64,
                                                 device="meta"))


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the same card
    inputs: pdist within rtol 1e-5 / atol 1e-5*d, rankeval and
    range_filter exactly (they share the plain versions' operation
    order), fused vs staged bitwise; one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    _cuda.reset_launches()
    q, piv, coef, lo, hi, n, rg = (_t(a).to(dev) for a in _plan_inputs())
    p = _t(_normal((1000, 8), 2)).to(dev)
    got = ops.pdist(q, p)
    np.testing.assert_allclose(got.cpu().numpy(),
                               pdist_plain(q, p).cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * 8)
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
                              "pdist_rankeval": 1}
