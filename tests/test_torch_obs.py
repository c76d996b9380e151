"""The port's observability layer (``repro_torch.obs``) and the emit
points of its query path, on the CPU.

Twins of ``tests/test_obs.py``'s registry, histogram, mode-gating,
off-mode zero-allocation, trace-ring, profile and Prometheus / Chrome /
JSON export tests (the paged, sharded and frontend cases wait for their
slices).  Then the emit points against the reference: on the seeded
index of ``tests/test_torch_executor.py`` (N = 2500, D = 6, K = 10), the
port's ``QueryProfile`` for a range and a kNN batch gives the
reference's kind, batch, k, rounds, host syncs, candidates and clusters
per query, and its observed rank-error ratio within 1e-6 relative; the
``kernels.<name>.launches`` / ``.torch`` counters equal the calls of
each ``ops`` wrapper (a spy counts them); and ``host_syncs`` are equal
with ``REPRO_OBS`` on and off.
"""
import json
import math
import threading
import time

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.core import LIMSIndex as RefIndex
from repro.core import MetricSpace as RefSpace
from repro.core.executor import QueryExecutor as RefExecutor
from repro.core.snapshot import LIMSSnapshot as RefSnapshot
from repro_torch import obs
from repro_torch.core import LIMSIndex, MetricSpace, QueryExecutor
from repro_torch.core.metrics import dist_one_to_many
from repro_torch.core.snapshot import LIMSSnapshot
from repro_torch.data.datasets import gauss_mix
from repro_torch.kernels import ops
from repro_torch.obs import registry as _reg
from repro_torch.obs.registry import Histogram, MetricsRegistry
from repro_torch.obs.trace import _NULL, span

N, D = 2500, 6
OPS = ("pdist", "pdist_grouped", "rankeval", "range_filter",
       "pdist_rankeval", "flash_attention")


@pytest.fixture(autouse=True)
def _restore_mode():
    """Tests flip the cached obs modes of both packages; put them back."""
    before, ref_before = obs.obs_mode(), ref_obs.obs_mode()
    yield
    obs.configure(before)
    ref_obs.configure(ref_before)


@pytest.fixture(scope="module")
def env():
    X = gauss_mix(N, D, seed=4)
    ref_ix = RefIndex(RefSpace(X, "l2"), n_clusters=10, m=3, n_rings=12)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=10, m=3, n_rings=12)
    rng = np.random.default_rng(2)
    Q = X[rng.choice(N, 8)] + rng.normal(0, 0.004, (8, D))
    rs = np.array([float(np.quantile(dist_one_to_many(q, X, "l2"), 0.01))
                   for q in Q])
    return {"X": X, "Q": Q, "rs": rs,
            "ref": RefExecutor(RefSnapshot.build(ref_ix)),
            "port": QueryExecutor(LIMSSnapshot.build(ix, device="cpu"))}


# ---------------------------------------------------------------- registry
def test_registry_get_or_create_and_kind_clash():
    reg = MetricsRegistry()
    c = reg.counter("a.b")
    assert reg.counter("a.b") is c
    with pytest.raises(TypeError):
        reg.gauge("a.b")
    reg.histogram("a.h").observe(2.0)
    reg.gauge("a.g").set(3.5)
    snap = reg.snapshot()
    assert snap["a.b"] == 0 and snap["a.g"] == 3.5
    assert snap["a.h"]["count"] == 1
    reg.reset()
    assert reg.snapshot()["a.h"]["count"] == 0
    assert reg.counter("a.b") is c          # reset keeps registrations


def test_registry_thread_safety():
    """Concurrent increments and observations lose nothing, and racing
    get-or-create yields one object per name."""
    reg = MetricsRegistry()
    n_threads, per = 8, 2000

    def worker() -> None:
        for j in range(per):
            reg.counter("t.count").inc()
            reg.histogram("t.hist", cap=64).observe(float(j))

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert reg.counter("t.count").value == n_threads * per
    h = reg.histogram("t.hist")
    assert h.count == n_threads * per
    assert h.sum == pytest.approx(n_threads * sum(range(per)))
    assert len(h) == 64
    assert h.min == 0.0 and h.max == float(per - 1)


def test_histogram_percentiles_match_numpy():
    rng = np.random.default_rng(11)
    xs = rng.lognormal(0.0, 1.5, 500)
    h = Histogram("pct.test", cap=1024)
    for x in xs:
        h.observe(float(x))
    for p in (0.0, 25.0, 50.0, 90.0, 99.0, 100.0):
        assert h.percentile(p) == float(np.percentile(xs, p))
    assert h.mean == pytest.approx(float(np.mean(xs)))


def test_histogram_reservoir_bounded_stats_exact():
    h = Histogram("res.test", cap=128)
    n = 10_000
    for i in range(n):
        h.observe(float(i))
    assert len(h) == 128 and h.count == n
    assert h.min == 0.0 and h.max == float(n - 1)
    assert h.sum == pytest.approx(n * (n - 1) / 2)
    assert 0.2 * n < h.percentile(50) < 0.8 * n


def test_mode_gating_and_configure(monkeypatch):
    obs.configure("off")
    assert not _reg.enabled() and not _reg.tracing()
    assert span("x") is _NULL
    obs.configure("trace")
    assert _reg.enabled() and _reg.tracing()
    assert span("x") is not _NULL
    with pytest.raises(ValueError):
        obs.configure("loud")
    monkeypatch.setenv("REPRO_OBS", "off")
    assert obs.configure() == "off"         # re-reads the knob
    monkeypatch.setenv("REPRO_OBS", "sometimes")
    with pytest.raises(ValueError, match="REPRO_OBS"):
        obs.configure()


def _quiesce() -> None:
    """Wait for the port's transient threads (engine refreshes, monitor
    samplers) from earlier tests to exit, and for the page prefetcher's
    queue to drain: a frame they allocate in the obs modules would be
    charged to the window below."""
    from repro_torch.storage import drain_queue
    drain_queue(timeout=30.0)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if not any(t.name in ("lims-snapshot-refresh", "lims-monitor")
                   for t in threading.enumerate()):
            return
        time.sleep(0.05)


def test_off_mode_records_and_allocates_nothing():
    import tracemalloc

    import repro_torch.obs.registry as regmod
    import repro_torch.obs.trace as trmod

    _quiesce()
    obs.configure("on")
    obs.count("offtest.c")
    obs.observe("offtest.h", 1.0)
    before = obs.REGISTRY.counter("offtest.c").value
    obs.configure("off")
    for _ in range(5):
        for _ in range(50):                 # settle frame freelists etc.
            obs.count("offtest.c")
            obs.observe("offtest.h", 2.0)
            obs.set_gauge("offtest.g", 3.0)
            with span("offtest.span"):
                pass
        tracemalloc.start()
        try:
            for _ in range(200):
                obs.count("offtest.c")
                obs.observe("offtest.h", 2.0)
                obs.set_gauge("offtest.g", 3.0)
                with span("offtest.span"):
                    pass
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        obs_alloc = sum(
            st.size for st in snap.statistics("filename")
            if st.traceback[0].filename in (regmod.__file__, trmod.__file__))
        if obs_alloc == 0:
            break
        _quiesce()
    assert obs_alloc == 0
    assert obs.REGISTRY.counter("offtest.c").value == before
    assert obs.REGISTRY.histogram("offtest.h").count == 1


def test_trace_ring_is_bounded(monkeypatch):
    monkeypatch.setenv("REPRO_OBS_TRACE_CAP", "50")
    obs.clear_trace()                       # recreate the ring at cap 50
    obs.configure("trace")
    for _ in range(200):
        with span("ring.test"):
            pass
    assert obs.trace_len() == 50
    obs.clear_trace()


# ---------------------------------------------------------------- profiles
def _assert_complete(p, kind):
    assert p is not None, "no QueryProfile was recorded"
    assert p.missing() == [], f"incomplete profile: {p.missing()}"
    assert p.kind == kind and p.backend == "resident"
    assert p.storage == "resident" and p.n_shards == 1
    assert p.batch > 0 and p.rounds >= 1 and p.n_clusters > 0
    assert p.total_s > 0 and all(v >= 0 for v in p.stages.values())
    assert p.pages == 0 and p.pages_per_query == 0


def test_profile_resident_complete(env):
    obs.configure("on")
    ex, Q, rs = env["port"], env["Q"], env["rs"]
    ex.knn_query_batch(Q, 5)
    _assert_complete(ex.last_profile, "knn")
    assert ex.last_profile.k == 5 and ex.last_profile.driver == "rounds"
    assert ex.last_profile.candidates_per_query >= 5
    ex.range_query_batch(Q, rs)
    _assert_complete(ex.last_profile, "range")
    assert ex.last_profile.k is None
    assert obs.last_profile() is ex.last_profile
    assert ex.live == ex.snap.live


def test_profile_off_mode_records_nothing(env):
    obs.configure("on")
    env["port"].knn_query_batch(env["Q"], 3)
    obs.clear_profiles()
    obs.configure("off")
    env["port"].knn_query_batch(env["Q"], 3)
    assert obs.last_profile() is None


def test_profile_ring_bounded(env, monkeypatch):
    monkeypatch.setenv("REPRO_OBS_PROFILES", "2")
    obs.configure("on")
    obs.clear_profiles()                    # recreate the ring at cap 2
    for _ in range(3):
        env["port"].knn_query_batch(env["Q"][:2], 3)
    assert len(obs.profiles()) == 2
    assert obs.profiles(1) == [obs.last_profile()]
    obs.clear_profiles()


# ---------------------------------------------------------------- exporters
def test_prometheus_text_format():
    obs.configure("on")
    reg = obs.REGISTRY
    reg.counter("exp.count").inc(7)
    reg.gauge("exp.gauge").set(2.5)
    h = reg.histogram("exp.hist")
    for x in range(10):
        h.observe(float(x))
    text = obs.prometheus_text()
    lines = text.splitlines()
    assert text.endswith("\n")
    assert "# TYPE lims_exp_count counter" in lines
    assert "lims_exp_count 7" in lines
    assert "# TYPE lims_exp_gauge gauge" in lines
    assert "lims_exp_gauge 2.5" in lines
    assert "# TYPE lims_exp_hist summary" in lines
    assert 'lims_exp_hist{quantile="0.5"} 4.5' in lines
    assert "lims_exp_hist_count 10" in lines
    assert "lims_exp_hist_sum 45" in lines
    for ln in lines:
        if ln.startswith("#"):
            continue
        name = ln.split("{")[0].split(" ")[0]
        assert name.startswith("lims_")
        assert all(c.isalnum() or c == "_" for c in name)


def test_chrome_trace_structure_and_file(tmp_path):
    obs.configure("trace")
    obs.clear_trace()
    with span("trace.outer", {"B": 4}):
        with span("trace.inner"):
            pass
    doc = obs.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert meta and meta[0]["name"] == "thread_name"
    assert {e["name"] for e in xs} == {"trace.outer", "trace.inner"}
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0 and e["cat"] == "lims"
    outer = next(e for e in xs if e["name"] == "trace.outer")
    assert outer["args"] == {"B": 4}
    path = str(tmp_path / "trace.json")
    assert obs.write_chrome_trace(path) == 2
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    obs.clear_trace()


def test_json_snapshot_round_trips(env, tmp_path):
    obs.configure("on")
    env["port"].knn_query_batch(env["Q"], 3)
    doc = obs.json_snapshot(n_profiles=4)
    assert doc["mode"] == "on"
    assert doc["profiles"] and doc["profiles"][-1]["kind"] == "knn"
    assert "profile.batches" in doc["metrics"]
    json.dumps(doc)
    path = str(tmp_path / "obs.json")
    obs.write_json_snapshot(path)
    with open(path) as f:
        assert json.load(f)["mode"] == "on"


def test_query_path_spans_in_the_trace(env):
    """With REPRO_OBS=trace a range and a kNN batch leave the planner's
    and executor's spans in the Chrome trace, as the reference's do."""
    obs.configure("trace")
    obs.clear_trace()
    env["port"].range_query_batch(env["Q"], env["rs"])
    env["port"].knn_query_batch(env["Q"], 3)
    names = {e["name"] for e in obs.chrome_trace()["traceEvents"]
             if e["ph"] == "X"}
    assert names == {"planner.plan_range", "planner.plan_knn",
                     "executor.range_execute", "executor.knn_execute",
                     "executor.refine"}
    obs.clear_trace()


# ------------------------------------------------------ against the reference
PROFILE_EQUAL = ("kind", "batch", "k", "rounds", "host_syncs",
                 "candidates_per_query", "clusters_per_query")


@pytest.mark.parametrize("kind", ["range", "knn"])
def test_profile_equals_reference(env, kind):
    obs.configure("on")
    ref_obs.configure("on")
    Q, rs = env["Q"], env["rs"]
    for ex in (env["port"], env["ref"]):
        if kind == "range":
            ex.range_query_batch(Q, rs)
        else:
            ex.knn_query_batch(Q, 6)
    got, want = env["port"].last_profile, env["ref"].last_profile
    for f in PROFILE_EQUAL:
        assert getattr(got, f) == getattr(want, f), f
    assert want.rank_err_ratio is not None
    assert got.rank_err_ratio == pytest.approx(want.rank_err_ratio,
                                               rel=1e-6)
    assert got.missing() == want.missing() == []


RANK_GAUGES = "executor.rank_err_ratio.c"


def _rank_gauges(registry) -> dict:
    """The per-cluster rank-error gauges that hold a value (not NaN)."""
    return {m.name: m.value for m in registry.metrics()
            if m.name.startswith(RANK_GAUGES) and not math.isnan(m.value)}


def test_rank_err_gauges_equal_reference(env):
    """The per-cluster gauges the rank-drift detector reads carry the
    reference's values after the same batch: the same set of gauges is
    set on both sides, to equal values.

    The gauges are process-wide, so a batch of another test that ran in
    the same process (another index, other queries) leaves gauges of its
    own clusters behind.  Every existing gauge of both registries is set
    to a NaN sentinel first; the gauges compared are those this batch
    set.  The sentinels the batch leaves are put back afterwards."""
    obs.configure("on")
    ref_obs.configure("on")
    saved = [(m, m.value) for registry in (obs.REGISTRY, ref_obs.REGISTRY)
             for m in registry.metrics() if m.name.startswith(RANK_GAUGES)]
    try:
        for m, _ in saved:
            m.set(float("nan"))
        assert not _rank_gauges(obs.REGISTRY)
        assert not _rank_gauges(ref_obs.REGISTRY)
        env["port"].knn_query_batch(env["Q"], 6)
        env["ref"].knn_query_batch(env["Q"], 6)
        ours = _rank_gauges(obs.REGISTRY)
        theirs = _rank_gauges(ref_obs.REGISTRY)
        assert ours and set(ours) == set(theirs)
        for name, v in ours.items():
            assert v == pytest.approx(theirs[name], rel=1e-6, abs=1e-12)
    finally:
        for m, v in saved:
            if math.isnan(m.value):
                m.set(v)


def test_kernel_counters_equal_wrapper_calls(env, monkeypatch):
    """``kernels.<name>.launches`` and ``kernels.<name>.torch`` rise by
    the number of calls of each ``ops`` wrapper (a spy counts them); on
    CPU tensors no ``cuda`` lane is counted."""
    obs.configure("on")
    calls = dict.fromkeys(OPS, 0)
    for name in OPS:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, spy)

    def counters():
        return {(name, lane): obs.REGISTRY.counter(
            f"kernels.{name}.{lane}").value
            for name in OPS for lane in ("launches", "torch", "cuda")}

    before = counters()
    env["port"].range_query_batch(env["Q"], env["rs"])
    env["port"].knn_query_batch(env["Q"], 6)
    after = counters()
    assert calls["pdist"] > 0 and calls["range_filter"] > 0
    assert calls["rankeval"] > 0
    for name in OPS:
        assert after[name, "launches"] - before[name, "launches"] == \
            calls[name], name
        assert after[name, "torch"] - before[name, "torch"] == calls[name]
        assert after[name, "cuda"] == before[name, "cuda"]


def test_host_syncs_equal_with_obs_on_and_off(env):
    """Profiling adds no device→host copy."""
    ex, Q, rs = env["port"], env["Q"], env["rs"]
    syncs = {}
    for mode in ("on", "off"):
        obs.configure(mode)
        ex.range_query_batch(Q, rs)
        r = ex._tls.syncs
        ex.knn_query_batch(Q, 6)
        syncs[mode] = (r, ex.last_knn["host_syncs"])
    assert syncs["on"] == syncs["off"]
    assert syncs["on"][0] >= 1 and syncs["on"][1] >= 2


def test_compact_counters(env, monkeypatch):
    obs.configure("on")
    monkeypatch.setenv("REPRO_COMPACT", "on")
    n0 = obs.REGISTRY.counter("executor.compact_batches").value
    h0 = obs.REGISTRY.histogram("executor.compact_frac").count
    env["port"].range_query_batch(env["Q"], env["rs"])
    assert obs.REGISTRY.counter("executor.compact_batches").value == n0 + 1
    assert obs.REGISTRY.histogram("executor.compact_frac").count == h0 + 1
    monkeypatch.setenv("REPRO_COMPACT", "off")
    env["port"].range_query_batch(env["Q"], env["rs"])
    assert obs.REGISTRY.counter("executor.compact_batches").value == n0 + 1


def test_planner_counters(env):
    obs.configure("on")
    built = obs.REGISTRY.counter("planner.plans_built").value
    evals = obs.REGISTRY.counter("planner.round_evals").value
    ex = env["port"]
    plan = ex.planner.plan_range(env["Q"], env["rs"])
    assert plan.plan_s > 0
    ex.planner.eval_mask(plan.qf, 2 * env["rs"])
    assert obs.REGISTRY.counter("planner.plans_built").value == built + 1
    assert obs.REGISTRY.counter("planner.round_evals").value == evals + 1
