"""The port's device-resident kNN loop (``REPRO_KNN_DRIVER``) against the
reference's, on the CPU.

Twin of ``tests/test_planner.py``'s driver tests on the 6-cluster
GaussMix index of ``tests/test_serving.py`` (N = 1,800, d = 6).  The
reference runs its compiled ``lax.while_loop`` (``REPRO_KNN_DRIVER=loop``,
its Pallas kernels in interpret mode); the port runs the same round
(``core/executor.py``'s ``_knn_round``) in a Python loop over CPU
tensors, each kernel through its plain version, on the reference's
snapshot carried over (``snapshot_from_reference``).  Checked: the knob's
values and ``auto``'s rule; ``host_syncs`` constant over (k, nq) and at
most 3 for the resident and the sharded (S = 3) executor; ``loop`` and
``rounds`` bit-identical in ids and f64 distances with equal rounds;
the port's loop equal to the reference's loop, results and rounds,
also at ``max_rounds`` 1 and 2 where the batch reaches the full scan
(the plane's margin widened to 10.0: a looser bound stays certified
and takes at least 3 rounds), at k > live, on the bf16 and f16 planes and for
``ShardedExecutor`` at S = 2, 3, 4; the power-of-two batch padding
invisible at B = 1, 3, 5; the loop condition's plain version; the paged
backend host-driven.  The ``gpu`` tests run the loop's CUDA graph on the
card against the CPU port: results, rounds, host syncs, launches
counted per replayed round, device-to-host copies equal for a 1-round
and a several-round batch, at most 4 graphs on one memory pool, memory
returned when the executor is dropped, 4 threads at different B, and
the condition kernel against its plain version.  The reference is
imported in a fixture, so they collect where JAX is absent.
"""
import dataclasses
import gc
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import env as port_env
from repro_torch.convert import FIELDS, snapshot_from_reference
from repro_torch.core import (LIMSIndex, LIMSSnapshot, MetricSpace,
                              QueryExecutor, ShardedExecutor)
from repro_torch.core import executor as executor_mod
from repro_torch.data.datasets import gauss_mix
from repro_torch.kernels import _cuda
from repro_torch.kernels.graph_loop import loop_cond_plain, loop_rounds_plain
from repro_torch.sharding import Mesh

N, D = 1800, 6
CPU = torch.device("cpu")
# a filter-plane margin past the corpus' diameter (GaussMix lies in
# [0, 1]^6: √6): certified (a looser bound than the plane's own), and
# every query needs at least 3 rounds before the k-th ball fits inside
# r − eps (a start radius of at most √6, doubled twice, stays under it)
WIDE_EPS = 10.0
CASES = ((3, 4), (11, 8), (64, 2))          # (k, nq), tests/test_planner.py


@pytest.fixture(scope="module")
def ref():
    """The reference package, imported here so that the ``gpu`` tests
    run where JAX is absent."""
    core = pytest.importorskip("repro.core")
    from repro import env as ref_env
    from repro.core.executor import QueryExecutor as RefExecutor
    from repro.core.snapshot import LIMSSnapshot as RefSnapshot
    return SimpleNamespace(core=core, env=ref_env, Executor=RefExecutor,
                           Snapshot=RefSnapshot)


def _carried(ref_snap, **extra):
    arrays = {f: np.asarray(getattr(ref_snap, f)) for f in FIELDS}
    arrays.update(extra)
    return snapshot_from_reference(arrays, CPU)


@pytest.fixture(scope="module")
def env(ref):
    X = gauss_mix(N, D, seed=7)
    ref_ix = ref.core.LIMSIndex(ref.core.MetricSpace(X, "l2"),
                                n_clusters=6, m=3, n_rings=10)
    ref_snap = ref.Snapshot.build(ref_ix)
    snap = _carried(ref_snap)
    return {"X": X, "ref_ix": ref_ix, "ref_snap": ref_snap, "snap": snap,
            "ref_ex": ref.Executor(ref_snap), "single": QueryExecutor(snap)}


def _queries(X, n_q, seed=2, scale=0.004):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n_q)] + rng.normal(0, scale, (n_q, D))


def _mesh(S: int) -> Mesh:
    return Mesh((CPU,) * S)


def _same_knn(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _widened(snap, eps: float = WIDE_EPS):
    """``snap`` filtering on its own f32 rows with margin ``eps``: the
    same dataclass field change works on either package's snapshot."""
    return dataclasses.replace(snap, rows_lp=snap.rows, lp_eps=eps)


def _knn(ex, Q, k, driver, monkeypatch, max_rounds=64):
    monkeypatch.setenv("REPRO_KNN_DRIVER", driver)
    out = ex.knn_query_batch(Q, k, max_rounds=max_rounds)
    assert ex.last_knn["driver"] == driver
    return out, dict(ex.last_knn)


# ------------------------------------------------------------------ knob
@pytest.mark.parametrize("value", ["", "auto", "loop", "rounds", " Loop "])
def test_knob_values_equal_reference(ref, monkeypatch, value):
    monkeypatch.setenv("REPRO_KNN_DRIVER", value)
    assert port_env.get("REPRO_KNN_DRIVER") == ref.env.get(
        "REPRO_KNN_DRIVER")
    assert port_env.KNOBS["REPRO_KNN_DRIVER"].values == \
        ref.env.KNOBS["REPRO_KNN_DRIVER"].values
    assert port_env.KNOBS["REPRO_KNN_DRIVER"].default == "auto"


def test_unknown_knob_value_refused_as_reference(env, ref, monkeypatch):
    """An unknown value raises ``ValueError`` naming the valid ones, in
    both packages, and a kNN batch refuses it."""
    monkeypatch.setenv("REPRO_KNN_DRIVER", "fast")
    with pytest.raises(ValueError) as want:
        ref.env.get("REPRO_KNN_DRIVER")
    with pytest.raises(ValueError) as got:
        port_env.get("REPRO_KNN_DRIVER")
    assert "REPRO_KNN_DRIVER='fast'" in str(got.value)
    assert "'auto', 'loop', 'rounds'" in str(got.value)
    assert "'auto', 'loop', 'rounds'" in str(want.value)
    with pytest.raises(ValueError, match="REPRO_KNN_DRIVER"):
        env["single"].knn_query_batch(_queries(env["X"], 2), 3)


def test_auto_resolves_as_the_reference_rule(env, monkeypatch):
    """``auto``: ``rounds`` on a one-part CPU executor, ``loop`` on a
    sharded one (the reference's ``_knn_driver``); a mesh over several
    cards takes ``rounds`` (the loop's graph is captured on one)."""
    single = env["single"]
    sx = ShardedExecutor(env["snap"], mesh=_mesh(3))
    monkeypatch.delenv("REPRO_KNN_DRIVER", raising=False)
    assert executor_mod._knn_driver(single) == "rounds"
    assert executor_mod._knn_driver(sx) == "loop"
    for mode in ("loop", "rounds"):
        monkeypatch.setenv("REPRO_KNN_DRIVER", mode)
        assert executor_mod._knn_driver(single) == mode
        assert executor_mod._knn_driver(sx) == mode
    monkeypatch.setenv("REPRO_KNN_DRIVER", "auto")
    monkeypatch.setattr(executor_mod, "_cards", lambda ex: {0, 1})
    assert executor_mod._knn_driver(sx) == "rounds"
    monkeypatch.setattr(executor_mod, "_cards", lambda ex: {0})
    assert executor_mod._knn_driver(sx) == "loop"


# ------------------------------------------------------------ host syncs
@pytest.mark.parametrize("name", ["resident", "sharded"])
def test_knn_host_syncs_constant_in_loop(env, monkeypatch, name):
    """Twin of ``test_planner.py``'s: the loop costs O(1) host syncs a
    batch — one for the plan's seed radii, one for the loop's masks and
    rounds — whatever (k, batch size, rounds); the sharded executor
    (S = 3) holds the same bound."""
    monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
    X = env["X"]
    ex = env["single"] if name == "resident" else ShardedExecutor(
        env["snap"], mesh=_mesh(3))
    syncs = []
    for k, nq in CASES:
        ex.knn_query_batch(_queries(X, nq, seed=k), k)
        assert ex.last_knn["backend"] == "resident"
        assert ex.last_knn["driver"] == "loop" == ex.last_driver
        assert ex.last_knn["rounds"] >= 1
        syncs.append(ex.last_knn["host_syncs"])
    assert len(set(syncs)) == 1, syncs
    assert syncs[0] <= 3, syncs
    assert ex.last_profile.driver == "loop"


@pytest.mark.parametrize("k", [4, 23])
def test_loop_matches_rounds_driver(env, monkeypatch, k):
    """Twin of ``test_planner.py``'s: ``loop`` and ``rounds`` run the
    same certified schedule — ids and f64 distances bit-identical, equal
    rounds — and ``rounds`` syncs once a round."""
    ex = env["single"]
    Q = _queries(env["X"], 5, seed=17)
    got_l, lk_l = _knn(ex, Q, k, "loop", monkeypatch)
    got_r, lk_r = _knn(ex, Q, k, "rounds", monkeypatch)
    _same_knn(got_l, got_r)
    assert lk_l["rounds"] == lk_r["rounds"]
    assert lk_r["host_syncs"] >= lk_r["rounds"]
    assert lk_l["host_syncs"] == 2


# ------------------------------------------------ against the reference
def _ref_loop(env, monkeypatch, Q, k, max_rounds=64, ex=None):
    ex = env["ref_ex"] if ex is None else ex
    got, lk = _knn(ex, Q, k, "loop", monkeypatch, max_rounds)
    return got, lk


@pytest.mark.parametrize("case", ["data", "wide_margin", "k_over_live"])
def test_loop_equals_reference_loop(env, ref, monkeypatch, case):
    """The port's loop on the carried snapshot gives the reference
    loop's ids, f64 distances and rounds, and the port's ``rounds``
    driver's: at k = 6, on the margin widened to 10.0 (several rounds),
    and at k past the live count (clamped to it)."""
    X = env["X"]
    Q, k = {"data": (_queries(X, 6, seed=5), 6),
            "wide_margin": (_queries(X, 5, seed=9), 6),
            "k_over_live": (_queries(X, 3, seed=8), N + 99)}[case]
    port, refx = env["single"], env["ref_ex"]
    if case == "wide_margin":
        port = QueryExecutor(_widened(env["snap"]))
        refx = ref.Executor(_widened(env["ref_snap"]))
    got, lk = _knn(port, Q, k, "loop", monkeypatch)
    want, wk = _ref_loop(env, monkeypatch, Q, k, ex=refx)
    _same_knn(got, want)
    assert lk["rounds"] == wk["rounds"]
    assert got[0].shape == (len(Q), min(k, N))
    rr, rk = _knn(port, Q, k, "rounds", monkeypatch)
    _same_knn(got, rr)
    assert rk["rounds"] == lk["rounds"]
    if case == "wide_margin":
        assert lk["rounds"] >= 3


@pytest.mark.parametrize("max_rounds", [1, 2])
def test_max_rounds_reaches_the_full_scan(env, ref, monkeypatch,
                                          max_rounds):
    """At ``max_rounds`` 1 and 2 no query certifies (the margin widened
    to 10.0 needs at least three rounds), so every query takes the exact full
    scan: the port's loop equals the reference's loop on the same
    widened snapshot, the port's rounds driver and the host index, and
    uses every round it was given."""
    X = env["X"]
    Q = _queries(X, 4, seed=11)
    port = QueryExecutor(_widened(env["snap"]))
    refx = ref.Executor(_widened(env["ref_snap"]))
    got, lk = _knn(port, Q, 6, "loop", monkeypatch, max_rounds)
    want, wk = _ref_loop(env, monkeypatch, Q, 6, max_rounds, ex=refx)
    _same_knn(got, want)
    assert lk["rounds"] == wk["rounds"] == max_rounds
    _same_knn(got, _knn(port, Q, 6, "rounds", monkeypatch, max_rounds)[0])
    _same_knn(got, env["single"].knn_query_batch(Q, 6))
    full, fk = _knn(port, Q, 6, "loop", monkeypatch)
    _same_knn(full, got)
    assert fk["rounds"] >= 3
    assert fk["rounds"] == _ref_loop(env, monkeypatch, Q, 6, ex=refx)[1][
        "rounds"]


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_lp_plane_loop_equals_reference(env, ref, monkeypatch, dtype):
    """On the bf16 and f16 planes (eps > 0: the ball widens, the
    certification tightens) the port's loop equals the reference's loop
    on its own plane, the port's rounds driver and the f32 baseline."""
    X = env["X"]
    monkeypatch.setenv("REPRO_ROWS_DTYPE", dtype)
    built = ref.Snapshot.build(env["ref_ix"])
    assert built.lp_eps > 0.0
    bits = np.asarray(built.rows_lp).view(np.uint16)
    port = QueryExecutor(_carried(built, rows_lp=bits, rows_lp_dtype=dtype,
                                  lp_eps=built.lp_eps))
    assert port.snap.lp_eps == built.lp_eps
    Q = np.concatenate([_queries(X, 3, seed=12), X[:2]])
    for k in (1, 9):
        got, lk = _knn(port, Q, k, "loop", monkeypatch)
        want, wk = _ref_loop(env, monkeypatch, Q, k,
                             ex=ref.Executor(built))
        _same_knn(got, want)
        assert lk["rounds"] == wk["rounds"]
        rr, rk = _knn(port, Q, k, "rounds", monkeypatch)
        _same_knn(got, rr)
        assert rk["rounds"] == lk["rounds"]
        monkeypatch.setenv("REPRO_KNN_DRIVER", "rounds")
        _same_knn(got, env["single"].knn_query_batch(Q, k))


@pytest.mark.parametrize("S", [2, 3, 4])
def test_sharded_loop_equals_single_and_reference(env, monkeypatch, S):
    """``ShardedExecutor``'s loop (auto picks it on the CPU) equals the
    single-device loop and the reference's loop: ids, f64 distances,
    rounds and host syncs; also at k > live, and at max_rounds 1 where
    a query needs 2 rounds and takes the full scan."""
    X = env["X"]
    sx = ShardedExecutor(env["snap"], mesh=_mesh(S))
    Q = _queries(X, 5, seed=21)
    monkeypatch.delenv("REPRO_KNN_DRIVER", raising=False)
    for k in (1, 7, N + 99):
        got = sx.knn_query_batch(Q, k)
        assert sx.last_knn["driver"] == "loop"
        one, lk = _knn(env["single"], Q, k, "loop", monkeypatch)
        _same_knn(got, one)
        for key in ("rounds", "host_syncs"):
            assert sx.last_knn[key] == lk[key], key
        want, wk = _ref_loop(env, monkeypatch, Q, k)
        _same_knn(got, want)
        assert sx.last_knn["rounds"] == wk["rounds"]
        monkeypatch.delenv("REPRO_KNN_DRIVER", raising=False)
    rows = X[:3].copy()                 # k = 1 at row 2 takes 2 rounds
    got = sx.knn_query_batch(rows, 1, max_rounds=1)
    assert sx.last_knn["rounds"] == 1
    want, wk = _ref_loop(env, monkeypatch, rows, 1, max_rounds=1)
    _same_knn(got, want)
    assert wk["rounds"] == 1
    _same_knn(got, env["single"].knn_query_batch(rows, 1))


# ------------------------------------------------------- batch buckets
@pytest.mark.parametrize("B", [1, 3, 5])
def test_bucket_padding_invisible(env, monkeypatch, B):
    """The loop pads a batch to its power-of-two bucket with copies of
    query 0: its masks, rounds and results equal the unpadded loop's and
    the rounds driver's, query by query."""
    X = env["X"]
    Q = np.concatenate([X[2:3], _queries(X, B - 1, seed=30 + B)])
    ex = env["single"]
    assert executor_mod._bucket_rows(B) == {1: 1, 3: 4, 5: 8}[B]
    monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
    plan = ex.planner.plan_knn(Q, 1, 64)
    padded = ex._knn_device_loop(plan)
    monkeypatch.setattr(executor_mod, "_bucket_rows", lambda n: n)
    bare = ex._knn_device_loop(plan)
    assert np.array_equal(padded[0], bare[0]) and padded[1] == bare[1]
    assert padded[0].shape == (B, env["snap"].n_slots)
    got, lk = _knn(ex, Q, 1, "loop", monkeypatch)
    rr, rk = _knn(ex, Q, 1, "rounds", monkeypatch)
    _same_knn(got, rr)
    assert lk["rounds"] == rk["rounds"] == 2     # row 2 needs 2 rounds
    for b in range(B):
        one, _ = _knn(ex, Q[b:b + 1], 1, "loop", monkeypatch)
        assert np.array_equal(one[0][0], got[0][b])
        assert np.array_equal(one[1][0], got[1][b])


# ---------------------------------------------------- condition, paged
def test_loop_condition_plain():
    """``knn_loop_cond``'s plain version: one more round, and the flag
    while some query is open and rounds < max_rounds."""
    done = torch.tensor([True, False, True])
    rounds = torch.zeros(1, dtype=torch.int32)
    assert int(loop_cond_plain(done, rounds, 3)) == 1 and int(rounds) == 1
    assert int(loop_cond_plain(done, rounds, 3)) == 1 and int(rounds) == 2
    assert int(loop_cond_plain(done, rounds, 3)) == 0 and int(rounds) == 3
    done[:] = True
    rounds.zero_()
    assert int(loop_cond_plain(done, rounds, 3)) == 0 and int(rounds) == 1
    for mr in (1, 4):
        r, f = loop_rounds_plain(torch.zeros(5, dtype=torch.bool), mr)
        assert int(r) == mr and int(f) == 0
        r, f = loop_rounds_plain(torch.ones(5, dtype=torch.bool), mr)
        assert int(r) == 1 and int(f) == 0


def test_paged_backend_stays_host_driven(env, tmp_path, monkeypatch):
    """A store-backed executor runs its host-driven paged rounds under
    ``loop`` too, as the reference's does."""
    monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
    path = str(tmp_path / "s")
    env["snap"].spill(path)
    pag = QueryExecutor(LIMSSnapshot.load(path, store=True, device=CPU))
    Q = _queries(env["X"], 4, seed=1)
    _same_knn(pag.knn_query_batch(Q, 6), env["single"].knn_query_batch(Q, 6))
    assert pag.last_knn["backend"] == "paged"
    assert pag.last_knn["driver"] == "paged" and pag._loop is None


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the loop's CUDA graph and its "
                    "kernels have no CPU mode")
    X = gauss_mix(N, D, seed=7)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=3, n_rings=10)
    return X, ix, LIMSSnapshot.build(ix, device="cuda"), \
        LIMSSnapshot.build(ix, device=CPU)


@pytest.mark.gpu
def test_loop_on_card_equals_cpu(monkeypatch):
    """The card's loop (one CUDA graph a batch) against the CPU port's
    loop, single-device and sharded over ``cuda:0`` four times: ids, f64
    distances, rounds and host syncs; launches counted per replayed
    round (``pdist_rankeval`` once a shard a round, ``knn_loop_cond``
    once a round, ``pdist`` twice a shard a batch)."""
    X, ix, card, cpu_snap = _card()
    monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
    cases = [(QueryExecutor(card), QueryExecutor(cpu_snap), 1),
             (ShardedExecutor(card, mesh=Mesh((torch.device("cuda", 0),)
                                              * 4)),
              ShardedExecutor(cpu_snap, mesh=_mesh(4)), 4)]
    for ex, cpu, S in cases:
        for Q, k in ((_queries(X, 16, seed=1), 7), (X[:5].copy(), 1),
                     (_queries(X, 3, seed=2), N + 99)):
            _cuda.reset_launches()
            got = ex.knn_query_batch(Q, k)
            n = dict(_cuda.LAUNCHES)
            _same_knn(got, cpu.knn_query_batch(Q, k))
            for key in ("rounds", "host_syncs", "driver"):
                assert ex.last_knn[key] == cpu.last_knn[key], key
            rounds = ex.last_knn["rounds"]
            assert n["pdist_rankeval"] == S * rounds
            assert n["knn_loop_cond"] == rounds
            assert n["pdist"] == 2 * S
    wide = QueryExecutor(_widened(card))
    got = wide.knn_query_batch(_queries(X, 4, seed=3), 6)
    assert wide.last_knn["rounds"] >= 3
    _same_knn(got, QueryExecutor(cpu_snap).knn_query_batch(
        _queries(X, 4, seed=3), 6))


def _d2h_copies(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "DtoH" in e.key or "Device -> Host" in e.key)


@pytest.mark.gpu
def test_loop_d2h_copies_equal_for_one_and_several_rounds(monkeypatch):
    """A 1-round batch and a batch of 3 or more rounds make the same
    number of device-to-host copies (``torch.profiler``): the plan's
    seed radii and the loop's one readback."""
    X, ix, card, _ = _card()
    monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
    one, many = QueryExecutor(card), QueryExecutor(_widened(card))
    Q = _queries(X, 8, seed=4)
    for ex in (one, many):          # capture outside the windows
        ex.knn_query_batch(Q, 6)
    counts = []
    for ex in (one, many):
        counts.append(_d2h_copies(lambda: ex.knn_query_batch(Q, 6)))
        counts.append(ex.last_knn["rounds"])
    assert counts[1] == 1 and counts[3] >= 3, counts
    assert counts[0] == counts[2] > 0, counts


@pytest.mark.gpu
def test_loop_graphs_bounded_on_one_pool(monkeypatch):
    """Six keys through one executor: at most 4 graphs cached, every one
    on the card's one pool, and reserved memory after the sixth key no
    more than after the fourth (the round's temporaries are shared)."""
    X, ix, card, _ = _card()
    monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
    ex = QueryExecutor(card)
    Q = _queries(X, 16, seed=5)
    reserved = []
    for k in (1, 2, 3, 4, 5, 6):
        ex.knn_query_batch(Q, k)
        reserved.append(torch.cuda.memory_reserved())
    loops = ex._loop
    assert len(loops.entries) == 4 and len(loops.captures) == 6
    assert loops.card.graphs >= 4 and loops.card.pool is not None
    assert reserved[5] <= reserved[3], reserved
    ex.knn_query_batch(Q[:3], 2)            # a smaller bucket: no growth
    assert torch.cuda.memory_reserved() <= reserved[3]


@pytest.mark.gpu
def test_loop_memory_returned_when_dropped(monkeypatch):
    """An executor's graphs, pool and buffers go with it."""
    X, ix, card, _ = _card()
    monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
    Q = _queries(X, 32, seed=6)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    ex = QueryExecutor(card)
    for k in (3, 4):
        ex.knn_query_batch(Q, k)
    assert torch.cuda.memory_reserved() > base
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= base


@pytest.mark.gpu
def test_loop_threads_at_different_batch_sizes_exact(monkeypatch):
    """Four threads, at B = 1, 3, 8 and 20, on one executor and on four
    executors of one snapshot: every answer equals the CPU port's."""
    X, ix, card, cpu_snap = _card()
    monkeypatch.setenv("REPRO_KNN_DRIVER", "loop")
    cpu = QueryExecutor(cpu_snap)
    batches = [_queries(X, b, seed=40 + b) for b in (1, 3, 8, 20)]
    want = [cpu.knn_query_batch(Q, 5) for Q in batches]
    shared = QueryExecutor(card)
    for execs in ([shared] * 4, [QueryExecutor(card) for _ in range(4)]):
        got = [None] * 4
        errors = []

        def run(i):
            try:
                for _ in range(3):
                    got[i] = execs[i].knn_query_batch(batches[i], 5)
                    _same_knn(got[i], want[i])
            except Exception as e:          # reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errors, errors


@pytest.mark.gpu
def test_loop_condition_kernel_matches_plain():
    """``knn_loop_cond`` alone in a WHILE graph counts the rounds its
    plain version counts: max_rounds while a query is open, 1 once none
    is; one launch counted a round."""
    from repro_torch.kernels.graph_loop import loop_rounds
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the condition kernel runs only "
                    "in a CUDA graph")
    for B in (1, 5, 64):
        for mr in (1, 3, 64):
            for fill in (False, True):
                done = torch.full((B,), fill, dtype=torch.bool)
                done_c = done.cuda()
                _cuda.reset_launches()
                r, f = loop_rounds(done_c, mr)
                pr, pf = loop_rounds_plain(done, mr)
                assert int(r) == int(pr) and int(f) == int(pf)
                assert _cuda.LAUNCHES["knn_loop_cond"] == int(pr)
