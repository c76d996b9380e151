"""The port's host index stack against the reference's, bit for bit.

The host modules (metrics, clustering, pivots, mapping, rank models,
paging, K selection, the index itself, the datasets) are numpy copies
of ``repro``'s: for the same seeded data they must build the same
structures and answer every query identically.  Also here: the port
never imports ``jax`` or ``repro``, its entry points default to the
card and raise without one, and its one environment knob fails loudly.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import LIMSIndex as RefIndex
from repro.core import MetricSpace as RefSpace
from repro.core.kselect import select_k as ref_select_k
from repro.core.metrics import cdist as ref_cdist
from repro.core.metrics import dist_one_to_many as ref_dist
from repro.data import datasets as ref_datasets
from repro_torch import env
from repro_torch.core import LIMSIndex, MetricSpace
from repro_torch.core.batched import BatchedLIMS
from repro_torch.core.kselect import select_k
from repro_torch.core.metrics import cdist, dist_one_to_many
from repro_torch.core.snapshot import LIMSSnapshot
from repro_torch.data import datasets
from repro_torch.kernels.dispatch import resolve_device

N, D = 2500, 6
SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module")
def pair():
    X = datasets.gauss_mix(N, D, seed=4)
    ref = RefIndex(RefSpace(X, "l2"), n_clusters=10, m=3, n_rings=12)
    port = LIMSIndex(MetricSpace(X, "l2"), n_clusters=10, m=3, n_rings=12)
    return X, ref, port


def _queries(X, n_q, seed=2, scale=0.004):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n_q)] + rng.normal(0, scale, (n_q, D))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------ structures
@pytest.mark.parametrize("name,args", [
    ("gauss_mix", (700, 5)), ("skewed", (300, 4)),
    ("color_histogram_like", (200, 32)), ("forest_like", (300,)),
])
def test_datasets_equal(name, args):
    assert _eq(getattr(datasets, name)(*args, seed=3),
               getattr(ref_datasets, name)(*args, seed=3))


def test_signature_and_edit_distance_equal():
    s = datasets.signature(3, 20, seed=1)
    assert _eq(s, ref_datasets.signature(3, 20, seed=1))
    assert _eq(dist_one_to_many(s[0], s, "edit"), ref_dist(s[0], s, "edit"))


@pytest.mark.parametrize("metric", ["l2", "l1", "linf", "cosine"])
def test_metrics_equal(metric, pair):
    X = pair[0]
    q = X[7] + 0.01
    assert _eq(dist_one_to_many(q, X, metric), ref_dist(q, X, metric))
    got = cdist(torch.from_numpy(X[:50]), torch.from_numpy(X[50:90]),
                metric).numpy()
    want = np.asarray(ref_cdist(X[:50], X[50:90], metric))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_index_structures_equal(pair):
    """Members, pivots, sorted columns, rings, LIMS values, rank and
    position models, stored rows: all bitwise equal."""
    _, ref, port = pair
    assert (ref.K, ref.default_delta_r) == (port.K, port.default_delta_r)
    for f in ("center_idx", "assign", "dist_to_center"):
        assert _eq(getattr(port.clustering, f), getattr(ref.clustering, f))
    for a, b in zip(port.clusters, ref.clusters):
        for f in ("pivot_idx", "pivot_rows", "store_ids", "pivot_d_stored",
                  "live_mask"):
            assert _eq(getattr(a, f), getattr(b, f)), f
        for f in ("d_sorted", "rids", "lims", "order", "lims_sorted",
                  "dist_min", "dist_max"):
            assert _eq(getattr(a.mapping, f), getattr(b.mapping, f)), f
        for ma, mb in zip(a.rank_models + [a.pos_model],
                          b.rank_models + [b.pos_model]):
            assert _eq(ma.coef, mb.coef)
            assert (ma.lo, ma.hi, ma.n) == (mb.lo, mb.hi, mb.n)
        assert _eq(a.store.rows, b.store.rows)
        assert a.store.omega == b.store.omega


def test_select_k_equal(pair):
    X = pair[0][:600]
    a = select_k(MetricSpace(X, "l2"), [4, 8, 16], m=3)
    b = ref_select_k(RefSpace(X, "l2"), [4, 8, 16], m=3)
    assert a.best_k == b.best_k
    for f in ("overhead", "or_curve", "mae_curve"):
        assert _eq(getattr(a, f), getattr(b, f))


# --------------------------------------------------------------- queries
def test_range_knn_point_queries_equal(pair):
    X, ref, port = pair
    Q = _queries(X, 6)
    rng = np.random.default_rng(3)
    for q in Q:
        r = float(np.quantile(ref_dist(q, X, "l2"), rng.uniform(1e-3, 5e-2)))
        (ai, ad, ast), (bi, bd, bst) = port.range_query(q, r), \
            ref.range_query(q, r)
        assert _eq(ai, bi) and _eq(ad, bd)
        assert (ast.pages, ast.probes, ast.candidates) == \
            (bst.pages, bst.probes, bst.candidates)
        for k in (1, 9):
            (ai, ad, _), (bi, bd, _) = port.knn_query(q, k), \
                ref.knn_query(q, k)
            assert _eq(ai, bi) and _eq(ad, bd)
    for i in (0, 17, 2499):
        assert _eq(port.point_query(X[i])[0], ref.point_query(X[i])[0])


def test_updates_and_retrain_equal():
    """§5.3 inserts, deletes and a host retrain leave both indexes
    answering identically."""
    X = datasets.gauss_mix(900, D, seed=1)
    rng = np.random.default_rng(0)
    new = X[rng.choice(900, 12)] + rng.normal(0, 0.02, (12, D))
    idx = [LIMSIndex(MetricSpace(X, "l2"), n_clusters=5, m=3, n_rings=8),
           RefIndex(RefSpace(X, "l2"), n_clusters=5, m=3, n_rings=8)]
    for ix in idx:
        gids = [ix.insert(r) for r in new]
        assert ix.delete(X[3]) == 1 and ix.delete(new[0]) == 1
        ix.retrain_cluster(2, backend="host")
        ix.retrain_cluster(3, backend="auto")
    assert idx[0].last_retrain_backend == "host"
    assert gids == list(range(900, 912))
    for q in _queries(X, 4, seed=5):
        a, b = (ix.range_query(q, 0.08) for ix in idx)
        assert _eq(a[0], b[0]) and _eq(a[1], b[1])
        a, b = (ix.knn_query(q, 6) for ix in idx)
        assert _eq(a[0], b[0]) and _eq(a[1], b[1])


def test_device_builder_is_a_later_slice(pair):
    """The device builder (the port's second slice) runs on the card
    unless the caller names another device: without a card,
    ``backend="device"`` raises a clear error before any work, for a
    build and for a retrain."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device works")
    X = pair[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LIMSIndex(MetricSpace(X[:100], "l2"), n_clusters=2,
                  backend="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair[2].retrain_cluster(0, backend="device")
    with pytest.raises(ValueError, match="backend"):
        LIMSIndex(MetricSpace(X[:100], "l2"), n_clusters=2, backend="tpu")


def test_auto_retrain_without_card_takes_host():
    """``retrain_cluster(backend="auto")`` takes the device only for a
    present CUDA device and at least RETRAIN_AUTO_ROWS rows; on a
    machine without a card, or for a CPU target, it records "host"."""
    from repro_torch.core.index import RETRAIN_AUTO_ROWS
    assert RETRAIN_AUTO_ROWS == 4096
    X = datasets.gauss_mix(9000, 4, seed=2)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=2, m=3, n_rings=8)
    big = max(range(ix.K), key=lambda c: ix.clusters[c].n)
    assert ix.clusters[big].n >= RETRAIN_AUTO_ROWS
    ix.retrain_cluster(big, backend="auto", device="cpu")
    assert ix.last_retrain_backend == "host"
    if not torch.cuda.is_available():
        ix.retrain_cluster(big, backend="auto")
        assert ix.last_retrain_backend == "host"


# ------------------------------------------------------ package boundary
def test_port_imports_neither_jax_nor_repro():
    """Importing every port module with ``jax`` blocked must succeed
    and load no ``jax`` or ``repro`` module."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.env, repro_torch.convert\n"
        "import repro_torch.core, repro_torch.data.datasets\n"
        "import repro_torch.build\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.configs.registry\n"
        "import repro_torch.models.params, repro_torch.models.layers\n"
        "import repro_torch.models.transformer, repro_torch.models.zoo\n"
        "import repro_torch.obs, repro_torch.obs.export\n"
        "import repro_torch.serving, repro_torch.core.serving\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert bad == ['jax'], bad\n"
        "print('clean')\n")
    env_ = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env_,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_default_device_is_the_card(pair):
    """Entry points default to ``cuda`` and raise without a card; they
    never quietly run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LIMSSnapshot.build(pair[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedLIMS(pair[2])
    assert resolve_device("cpu") == torch.device("cpu")


def test_env_knob_fails_loudly(monkeypatch):
    monkeypatch.setenv("REPRO_COMPACT", "of")
    with pytest.raises(ValueError, match="REPRO_COMPACT"):
        env.get("REPRO_COMPACT")
    monkeypatch.setenv("REPRO_COMPACT", " OFF ")
    assert env.get("REPRO_COMPACT") == "off"
    monkeypatch.setenv("REPRO_COMPACT", "")
    assert env.get("REPRO_COMPACT") == "on"
