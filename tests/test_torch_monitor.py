"""The port's health monitoring (``repro_torch.obs.{timeseries,health,
monitor}``) and the closed retrain loop (``repro_torch.serving.
MonitorDaemon``), on the CPU.

Twins of ``tests/test_monitor.py``: series and detector tests
(hysteresis, rank drift, pruning regression, SLO burn), the manual-tick
monitor, start/stop and the atexit join, no thread leak across engine
rebuilds, the zero-thread zero-allocation off path, the Prometheus
bucket and series lines, ``test_daemon_retrain_modes``,
``test_executor_emits_observed_rank_error``, and the closed loop through
the port's replica stack: the daemon's rebalance cooldown and audit
ring over a ``PlanRouter``, paged drift -> heat-skew finding ->
rebalance with results bit-identical throughout, and the frontend's SLO
accounting with an adopted ``Monitor``.  A daemon whose ``router_fn``
returns None (before a frontend's first routed batch) takes no
heat-skew action.
"""
import threading

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core import LIMSIndex, MetricSpace, QueryExecutor
from repro_torch.core.serving import ServingEngine
from repro_torch.core.snapshot import LIMSSnapshot
from repro_torch.data.datasets import gauss_mix
from repro_torch.obs import monitor as monmod
from repro_torch.obs.health import (HealthFinding, HeatSkewDetector,
                                    PruningRegressionDetector,
                                    RankDriftDetector, SloBurnDetector,
                                    default_detectors)
from repro_torch.obs.monitor import (Monitor, active_monitors,
                                     configure_monitor, maybe_monitor,
                                     shutdown_monitors)
from repro_torch.obs.registry import DEFAULT_BUCKET_BOUNDS, MetricsRegistry
from repro_torch.obs.timeseries import Series, SeriesStore, sparkline
from repro_torch.serving import MonitorDaemon, PlanRouter, ReplicaSet

N, D = 700, 6


@pytest.fixture(autouse=True)
def _restore_modes():
    """Tests flip the cached obs/monitor modes and may start sampler
    threads; restore both and join stray threads."""
    obs_before = obs.obs_mode()
    mon_before = monmod.monitor_mode()
    yield
    shutdown_monitors()
    obs.configure(obs_before)
    configure_monitor(mon_before)


@pytest.fixture(scope="module")
def setup():
    X = gauss_mix(N, D, seed=11)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=6, m=2, n_rings=6)
    snap = LIMSSnapshot.build(ix, device="cpu")
    rng = np.random.default_rng(5)
    Q = X[rng.choice(N, 12, replace=False)] + 0.005
    return X, ix, snap, Q


def _monitor_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "lims-monitor"]


# ------------------------------------------------------------- time series
def test_series_kinds_window_and_cap():
    s = Series("x", "level", cap=4)
    s.extend([1, 2, 3, 4, 5])
    assert s.values() == [2.0, 3.0, 4.0, 5.0]
    assert s.last() == 5.0 and len(s) == 4
    assert s.window(2) == [4.0, 5.0]
    assert s.window_mean(2) == 4.5 and s.window_sum(10) == 14.0
    assert s.stats()["max"] == 5.0
    with pytest.raises(ValueError):
        Series("y", "cumulative")
    assert sparkline([]) == ""
    assert sparkline([2.0, 2.0]) == "▁▁"
    spark = sparkline([0, 1, 2, 3], width=4)
    assert len(spark) == 4 and spark[0] == "▁" and spark[-1] == "█"


def test_seriesstore_sampling_semantics():
    """Counters -> per-tick deltas (reset self-heals), gauges -> levels,
    histograms -> p50/p99 levels plus a count-delta rate series."""
    reg = MetricsRegistry()
    store = SeriesStore(cap=16)
    c, g, h = reg.counter("t.c"), reg.gauge("t.g"), reg.histogram("t.h")
    c.inc(3)
    g.set(1.5)
    h.observe(2.0)
    h.observe(4.0)
    store.sample(reg)
    c.inc(2)
    g.set(2.5)
    h.observe(6.0)
    store.sample(reg)
    assert store.get("t.c").values() == [3.0, 2.0]
    assert store.get("t.c").kind == "delta"
    assert store.get("t.g").values() == [1.5, 2.5]
    assert store.get("t.g").kind == "level"
    assert store.get("t.h.rate").values() == [2.0, 1.0]
    assert store.get("t.h.p50").kind == "level"
    assert store.get("t.h.p50").last() == h.snapshot()["p50"]
    assert store.ticks == 2
    reg.reset()
    c.inc(4)
    store.sample(reg)
    assert store.get("t.c").last() == 4.0
    assert store.match("t.") and store.names() == sorted(store.names())


# --------------------------------------------------------------- detectors
def _feed(det, store, series_name, values, kind="level"):
    s = store.series(series_name, kind)
    out = []
    for i, v in enumerate(values, 1):
        s.append(v)
        out.extend(det.evaluate(store, i))
    return out


def test_detector_hysteresis_drift_present_absent_flapping():
    det = HeatSkewDetector(trigger=1.5, clear=1.15, persistence=2)
    assert _feed(det, SeriesStore(cap=64), "router.heat_skew",
                 [1.0, 1.2, 1.4, 1.1]) == []
    assert not det.active

    det2 = HeatSkewDetector(trigger=1.5, clear=1.15, persistence=2)
    fs = _feed(det2, SeriesStore(cap=64), "router.heat_skew",
               [2.0, 2.0, 2.0, 2.0, 1.0])
    assert [f.cleared for f in fs] == [False, True]
    fired, cleared = fs
    assert fired.detector == "heat_skew" and fired.severity == "warn"
    assert fired.tick == 2 and fired.value == 2.0
    assert cleared.severity == "info" and cleared.tick == 5
    assert not det2.active

    det3 = HeatSkewDetector(trigger=1.5, clear=1.15, persistence=2)
    assert _feed(det3, SeriesStore(cap=64), "router.heat_skew",
                 [2.0, 1.0, 2.0, 1.0, 2.0, 1.0]) == []

    det4 = HeatSkewDetector(trigger=1.5, clear=1.15, persistence=1,
                            refire=2)
    fs4 = _feed(det4, SeriesStore(cap=64), "router.heat_skew",
                [2.0, 1.3, 1.3, 1.3, 1.3, 1.3])
    assert len(fs4) == 1 and det4.active

    det5 = HeatSkewDetector(trigger=1.5, clear=1.15, persistence=1,
                            refire=3)
    fs5 = _feed(det5, SeriesStore(cap=64), "router.heat_skew", [2.0] * 7)
    assert [f.tick for f in fs5] == [1, 4, 7]

    with pytest.raises(ValueError):
        HeatSkewDetector(trigger=1.0, clear=1.0)


def test_rank_drift_detector_per_cluster_and_severity():
    store = SeriesStore(cap=16)
    det = RankDriftDetector(trigger=0.75, clear=0.5, persistence=2)
    store.series("executor.rank_err_ratio.c0").append(0.2)
    store.series("executor.rank_err_ratio.c3").append(0.9)
    assert det.evaluate(store, 1) == []
    store.series("executor.rank_err_ratio.c3").append(1.2)
    (f,) = det.evaluate(store, 2)
    assert f.context["cluster"] == 3
    assert f.severity == "critical"
    assert "1.20x the certified bound" in f.summary
    assert det.state()["active"]


def test_pruning_regression_detector_baseline_ratio():
    det = PruningRegressionDetector(trigger=2.0, clear=1.5, persistence=1,
                                    baseline_n=3, window=2)
    fs = _feed(det, SeriesStore(cap=64), "profile.candidates_per_query.p50",
               [100, 100, 100, 120, 300, 300])
    assert len(fs) == 1 and fs[0].value == pytest.approx(2.1)
    assert fs[0].tick == 5
    assert fs[0].context["baseline"] == pytest.approx(100.0)


def test_slo_burn_detector_window_math():
    store = SeriesStore(cap=64)
    det = SloBurnDetector(trigger=2.0, clear=1.0, persistence=1, window=10,
                          objective=0.99)
    ok = store.series("frontend.slo_ok", "delta")
    miss = store.series("frontend.slo_miss", "delta")
    assert det.evaluate(store, 1) == []
    ok.append(97.0)
    miss.append(3.0)
    (f,) = det.evaluate(store, 2)
    assert f.value == pytest.approx(3.0) and f.severity == "warn"
    assert int(f.context["miss"]) == 3
    ok.append(0.0)
    miss.append(50.0)
    assert det.evaluate(store, 3) == []
    assert det.active


def test_slo_burn_critical_severity():
    store = SeriesStore(cap=64)
    det = SloBurnDetector(trigger=2.0, clear=1.0, persistence=1, window=10)
    store.series("frontend.slo_ok", "delta").append(50.0)
    store.series("frontend.slo_miss", "delta").append(50.0)
    (f,) = det.evaluate(store, 1)
    assert f.severity == "critical" and f.value == pytest.approx(50.0)
    with pytest.raises(ValueError):
        SloBurnDetector(objective=1.5)


def test_default_detectors_are_the_four():
    assert [d.name for d in default_detectors()] == [
        "rank_drift", "pruning_regression", "heat_skew", "slo_burn"]


# ----------------------------------------------------- monitor + lifecycle
def test_monitor_manual_tick_probes_findings_subscribers():
    reg = MetricsRegistry()
    det = HeatSkewDetector(trigger=1.5, clear=1.15, persistence=1)
    mon = Monitor(registry=reg, interval=3600.0, detectors=[det],
                  findings=4)
    seen = []
    mon.subscribe(seen.append)
    mon.add_probe(lambda: reg.gauge("router.heat_skew").set(4.0))
    mon.add_probe(lambda: 1 / 0)                    # must not kill the tick
    fired = mon.tick()
    assert len(fired) == 1 and seen == fired
    assert isinstance(fired[0], HealthFinding)
    assert mon.store.ticks == 1 and not mon.running
    snap = mon.snapshot()
    assert snap["ticks"] == 1 and len(snap["findings"]) == 1
    assert snap["detectors"][0]["name"] == "heat_skew"
    for _ in range(40):
        mon.tick()
    assert len(mon.findings()) <= 4
    assert reg.get("monitor.probe_errors") is None


def test_monitor_start_stop_idempotent_and_atexit_join():
    mon = Monitor(interval=0.01)
    assert not _monitor_threads()
    mon.start()
    mon.start()
    assert len(_monitor_threads()) == 1 and mon.running
    assert mon in active_monitors()
    assert mon.stop(timeout=5.0)
    assert mon.stop()
    assert not mon.running and mon not in active_monitors()
    assert not _monitor_threads()
    m2 = Monitor(interval=0.01).start()
    assert m2.running
    assert shutdown_monitors(timeout=5.0)
    assert not m2.running and not _monitor_threads()


def test_no_thread_leak_across_repeated_engine_rebuilds(setup):
    """Rebuilding an engine with a started monitor and its daemon three
    times leaves no lims-monitor thread once each monitor is stopped."""
    X, ix, snap, Q = setup
    base = len(_monitor_threads())
    for _ in range(3):
        se = ServingEngine(ix, refresh_every=0, device="cpu")
        mon = Monitor(interval=0.01).start()
        MonitorDaemon(mon, lambda: None, se)
        assert mon.running
        se.knn_query(Q[0], 3)
        se.refresh()
        assert mon.stop(timeout=5.0) and not mon.running
    assert len(_monitor_threads()) == base == 0


def test_monitor_off_is_zero_thread_zero_alloc():
    import tracemalloc

    configure_monitor("off")
    assert monmod.monitor_enabled() is False
    for _ in range(50):
        maybe_monitor()
        monmod.monitor_enabled()
    tracemalloc.start()
    try:
        for _ in range(200):
            assert maybe_monitor() is None
            monmod.monitor_enabled()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mon_alloc = sum(st.size for st in snap.statistics("filename")
                    if st.traceback[0].filename == monmod.__file__)
    assert mon_alloc == 0
    assert not _monitor_threads()
    configure_monitor("on")
    m = maybe_monitor(interval=0.01)
    assert m is not None and m.running
    assert m.stop(5.0) and not _monitor_threads()
    with pytest.raises(ValueError):
        configure_monitor("sometimes")


# ---------------------------------------------------- prometheus histogram
def test_prometheus_bucket_lines_format_pinned():
    obs.configure("on")
    h = obs.REGISTRY.histogram("monbkt.h")
    h.reset()
    for v in range(10):
        h.observe(float(v))
    text = obs.prometheus_text()
    assert "# TYPE lims_monbkt_h_hist histogram" in text
    assert 'lims_monbkt_h_hist_bucket{le="1"} 2' in text
    assert 'lims_monbkt_h_hist_bucket{le="10"} 10' in text
    assert 'lims_monbkt_h_hist_bucket{le="+Inf"} 10' in text
    assert "lims_monbkt_h_hist_count 10" in text
    assert "lims_monbkt_h_hist_sum 45" in text
    counts = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
              if line.startswith("lims_monbkt_h_hist_bucket")]
    assert counts == sorted(counts) and counts[-1] == 10
    assert len(counts) == len(DEFAULT_BUCKET_BOUNDS) + 1
    bounds, cum = h.buckets()
    assert list(bounds) == sorted(bounds) and cum[-1] == 10
    h.reset()
    assert h.buckets()[1][-1] == 0


def test_prometheus_monitor_series_lines():
    obs.configure("on")
    reg = MetricsRegistry()
    mon = Monitor(registry=reg, interval=3600.0, detectors=[])
    reg.gauge("router.heat_skew").set(2.5)
    mon.tick()
    text = obs.prometheus_text(monitor=mon)
    assert ('lims_monitor_series{series="router.heat_skew",stat="last"} 2.5'
            in text)
    assert "lims_monitor_ticks 1" in text


# -------------------------------------------------------------- the daemon
def _drift_stack(cooldown=1, **daemon_kw):
    """A manually-ticked monitor with the rank-drift and heat-skew
    detectors and a daemon with no router (``lambda: None``)."""
    mon = Monitor(interval=3600.0,
                  detectors=[HeatSkewDetector(trigger=1.5, clear=1.15,
                                              persistence=1),
                             RankDriftDetector(persistence=1)])
    daemon = MonitorDaemon(mon, lambda: None, cooldown_ticks=cooldown,
                           **daemon_kw)
    return mon, daemon


def test_daemon_retrain_modes(setup):
    """rank_drift findings route through REPRO_MONITOR_RETRAIN: off
    ignores, recommend records on the engine, auto also retrains."""
    X, ix, snap, Q = setup
    obs.configure("on")
    # refresh_every=1 so an auto retrain publishes a fresh generation
    se = ServingEngine(ix, refresh_every=1, device="cpu")

    def drive(mode):
        mon, daemon = _drift_stack(engine=se, retrain=mode)
        mon.registry.gauge("executor.rank_err_ratio.c2").set(0.9)
        mon.tick()
        return daemon.events()

    with pytest.raises(ValueError):
        _drift_stack(engine=se, retrain="always")

    se.clear_retrain_recommendations()
    evs = drive("off")
    assert not [e for e in evs if e["action"].startswith("retrain")]
    assert se.retrain_recommendations() == []

    evs = drive("recommend")
    (ev,) = [e for e in evs if e["action"] == "retrain_recommend"]
    assert ev["cluster"] == 2
    (rec,) = se.retrain_recommendations()
    assert rec["cluster"] == 2 and "rank error" in rec["reason"]

    se.clear_retrain_recommendations()
    before = se.generation
    evs = drive("auto")
    (ev,) = [e for e in evs if e["action"] == "retrain_auto"]
    assert ev["cluster"] == 2
    assert se.generation > before
    assert len(se.retrain_recommendations()) == 1
    # the published generation still answers as the host index does
    ids, ds = se.knn_query_batch(Q, 4)
    for b, q in enumerate(Q):
        np.testing.assert_allclose(ds[b], ix.knn_query(q, 4)[1], atol=0)
    obs.REGISTRY.gauge("executor.rank_err_ratio.c2").set(0.0)


def test_daemon_heat_skew_without_a_router():
    """Before a frontend's first routed batch there is no router: the
    probe publishes nothing and the daemon takes no heat-skew action."""
    obs.configure("on")
    reg = MetricsRegistry()
    mon = Monitor(registry=reg, interval=3600.0,
                  detectors=[HeatSkewDetector(trigger=1.5, clear=1.15,
                                              persistence=1)])
    daemon = MonitorDaemon(mon, lambda: None, cooldown_ticks=1)
    reg.gauge("router.heat_skew").set(4.0)
    fired = mon.tick()
    assert [f.detector for f in fired] == ["heat_skew"]
    assert daemon.events() == []
    assert daemon.snapshot()["last_action"] == {}


def _router_stack(snap, n_replicas=4, cooldown=2, **daemon_kw):
    """Replica set with ownership pinned to replica 0 (the injected
    drift), a router, and a manually-ticked monitor + daemon.  Uses the
    process registry (obs must be "on") because the router publishes
    its heat-skew gauge there."""
    replicas = ReplicaSet(snap, n_replicas=n_replicas)
    router = PlanRouter(replicas)
    mon = Monitor(interval=3600.0,
                  detectors=[HeatSkewDetector(trigger=1.5, clear=1.15,
                                              persistence=2),
                             RankDriftDetector(persistence=1)])
    daemon = MonitorDaemon(mon, lambda: router,
                           cooldown_ticks=cooldown, **daemon_kw)
    replicas.set_ownership(np.zeros(snap.K, np.int64))
    return replicas, router, mon, daemon


def test_daemon_rebalance_cooldown_and_audit(setup):
    X, ix, snap, Q = setup
    obs.configure("on")
    replicas, router, mon, daemon = _router_stack(snap, cooldown=10)
    router.knn_query_batch(Q, 4)
    for _ in range(6):
        mon.tick()
    evs = daemon.events()
    rebal = [e for e in evs if e["action"] == "rebalance"]
    skips = [e for e in evs if e["action"] == "cooldown_skip"]
    assert len(rebal) == 1                          # cooldown holds
    assert rebal[0]["skew"] == pytest.approx(4.0)   # all heat on replica 0
    assert rebal[0]["detector"] == "heat_skew"
    assert sorted(set(rebal[0]["owner"])) == list(range(4))
    assert all(s["last_action_tick"] == rebal[0]["tick"] for s in skips)
    snap_d = daemon.snapshot()
    assert snap_d["cooldown_ticks"] == 10
    assert snap_d["last_action"]["heat_skew"] == rebal[0]["tick"]


def test_closed_loop_paged_drift_to_rebalance_bit_identical(setup,
                                                            tmp_path):
    """Paged serving with skewed heat -> heat-drift finding -> daemon
    rebalance within cooldown -> replica load spread tightens
    (router.replica_spread series) -> results bit-identical throughout."""
    X, ix, snap, Q = setup
    obs.configure("on")
    obs.REGISTRY.reset()            # deterministic reservoirs for p50s
    path = str(tmp_path / "store")
    snap.spill(path)
    paged = LIMSSnapshot.load(path, store=True, cache_pages=8, device="cpu")
    replicas = ReplicaSet(paged, n_replicas=4)
    router = PlanRouter(replicas)
    mon = Monitor(interval=3600.0,
                  detectors=[HeatSkewDetector(trigger=1.5, clear=1.15,
                                              persistence=2)])
    daemon = MonitorDaemon(mon, lambda: router, cooldown_ticks=2)
    ids_ref, ds_ref = QueryExecutor(snap).knn_query_batch(Q, 5)

    def spread(owner):
        counts = np.bincount(owner, minlength=4)
        return counts.max() / max(counts.mean(), 1e-12)

    # baseline traffic, balanced ownership: no finding should fire
    router.knn_query_batch(Q, 5)
    mon.tick()
    assert daemon.events() == []

    # inject placement drift: replica 0 "owns" every cluster while the
    # page-cache heat stays spread across clusters
    replicas.set_ownership(np.zeros(paged.K, np.int64))
    assert spread(replicas.owner) == pytest.approx(4.0)
    found = []
    for _ in range(4):
        ids, ds = router.knn_query_batch(Q, 5)
        assert np.array_equal(ids, ids_ref)         # exactness under drift
        assert np.array_equal(ds, ds_ref)
        found.extend(mon.tick())

    drift = [f for f in found if f.detector == "heat_skew" and not f.cleared]
    assert drift, "skewed heat must produce a heat-drift HealthFinding"
    assert drift[0].value == pytest.approx(4.0)     # all heat on replica 0
    rebal = [e for e in daemon.events() if e["action"] == "rebalance"]
    assert rebal, "daemon must rebalance on the finding"
    assert rebal[0]["tick"] == drift[0].tick        # acted the same tick
    assert spread(replicas.owner) < 4.0
    assert len(set(replicas.owner.tolist())) >= 2
    for _ in range(6):
        ids, ds = router.knn_query_batch(Q, 5)
        assert np.array_equal(ids, ids_ref)         # still bit-identical
        assert np.array_equal(ds, ds_ref)
        mon.tick()
    s = mon.store.get("router.replica_spread.p50")
    assert s.last() is not None
    # the series dipped while batches collapsed onto replica 0, then
    # recovered once the daemon's rebalance took effect
    assert min(s.values()) < s.last()
    assert s.last() > 1.0
    assert mon.store.get("router.heat_skew").last() < 1.5
    assert paged.store.cache.pinned == 0


def test_frontend_slo_accounting_and_monitor_integration(setup):
    """The frontend records per-request completion latency against the
    SLO target; metrics() exposes attainment; an explicit Monitor is
    adopted (its daemon routed to the frontend's router) and stopped by
    close(); a hopeless target turns every completion into a miss."""
    X, ix, snap, Q = setup
    obs.configure("on")
    se = ServingEngine(ix, refresh_every=0, device="cpu")
    mon = Monitor(interval=3600.0)
    with se.frontend(max_batch=4, slo_ms=100.0, slo_target_ms=60_000.0,
                     monitor=mon) as fe:
        assert fe.monitor is mon and fe.daemon is not None
        for j in range(6):
            fe.knn_query(Q[j], 3)
        m = fe.metrics()
        assert m["slo_ok"] == 6 and m["slo_miss"] == 0
        assert m["slo_attained"] == 1.0
        assert m["slo_target_ms"] == 60_000.0
        assert m["latency_ms_p50"] > 0.0
        mon.tick()
        assert fe.daemon._router_fn() is fe._router_obj is not None
    assert not mon.running                          # close() stopped it
    assert mon.store.get("frontend.request_latency_s.p50") is not None
    assert mon.store.get("router.heat_skew") is not None

    with se.frontend(max_batch=4, slo_ms=100.0,
                     slo_target_ms=1e-9) as fe2:
        fe2.knn_query(Q[0], 3)
        m2 = fe2.metrics()
        assert m2["slo_miss"] == 1 and m2["slo_attained"] == 0.0


def test_executor_emits_observed_rank_error(setup):
    """The executor's per-batch observed-rank-error stat feeds the
    rank-drift detector: profiles carry the ratio, per-cluster gauges
    appear, and fresh models sit well inside the certified bound."""
    X, ix, snap, Q = setup
    obs.configure("on")
    obs.clear_profiles()
    ex = QueryExecutor(snap)
    ex.knn_query_batch(Q, 5)
    p = obs.last_profile()
    assert p is not None and p.rank_err_ratio is not None
    assert 0.0 <= p.rank_err_ratio <= 1.0
    gauges = [m for m in obs.REGISTRY.metrics()
              if m.name.startswith("executor.rank_err_ratio.c")]
    assert gauges and all(g.value <= 1.0 for g in gauges)
    assert obs.REGISTRY.histogram("profile.rank_err_ratio").count >= 1
    # and a tick over them finds no drift
    mon = Monitor(interval=3600.0, detectors=[RankDriftDetector(
        persistence=1)])
    assert mon.tick() == []


def test_nan_rank_replays_as_ring_zero(setup):
    """A NaN pivot distance ranks 0 in ring 0, as the kernels rank it
    since their NaN repair: the replay counts a slot whose stored ring
    is 0 as predicted exactly, one whose ring is higher as off by it."""
    X, ix, snap, Q = setup
    obs.configure("on")
    ex = QueryExecutor(snap)
    n_max = snap.n_max
    slot = int(np.nonzero(snap.tables_np.in_ring)[0][0])
    rows = snap.rows_np.copy()
    rows[slot] = np.nan
    ex._refine_rows = lambda idx: rows[idx]
    ratio = ex._observed_rank_err(np.array([slot]))
    k, j = divmod(slot, n_max)
    act = snap.tables_np.rids[k, j]
    width = np.ceil(snap.tables_np.n[k] / np.float32(snap.n_rings))
    want = (act * width / np.maximum(snap.tables_np.err[k], 1.0)).mean()
    assert ratio == pytest.approx(float(want), rel=1e-6)
    assert np.isfinite(ratio)
