"""Shared demo fixtures for the report CLI (and its smokes).

Port of ``repro/obs/demo.py``.  ``report --demo`` and ``report
--health`` both build through :func:`demo_state` — one tiny synthetic
index + engine + query set, on the card unless the caller asks for
``device="cpu"`` — and layer their workload on top:

* :func:`run_traffic_demo` — the exporter smoke: range/kNN/frontend
  traffic under full tracing, asserting a complete ``QueryProfile``.
* :func:`run_health_demo` — the closed loop, deterministically: a
  4-replica router over the same snapshot, placement drift injected by
  pinning every cluster's ownership to replica 0, then manually-ticked
  monitoring — the heat-skew detector fires, the daemon rebalances
  within its cooldown, and the series show the spread recovering.  No
  threads, no sleeps: every tick is explicit.
"""
from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np

from . import profile, registry


def demo_state(mode: str = "trace", device=None) -> SimpleNamespace:
    """One small index + serving engine + query batch (seeded rng).
    ``device`` is where the engine's snapshots are built and served
    (default ``cuda``; ``"cpu"`` runs the kernels' plain versions)."""
    from ..core import LIMSIndex, MetricSpace
    from ..serving import ServingEngine

    registry.configure(mode)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((600, 8))
    ix = LIMSIndex(MetricSpace(data, "l2"), n_clusters=6, m=2, n_rings=6)
    se = ServingEngine(ix, refresh_every=0, device=device)
    Q = data[rng.choice(600, 16, replace=False)] + 0.01
    return SimpleNamespace(rng=rng, data=data, ix=ix, se=se, Q=Q)


def run_traffic_demo(st: SimpleNamespace | None = None) -> SimpleNamespace:
    """Serve a small synthetic workload with full tracing enabled."""
    st = st if st is not None else demo_state("trace")
    st.se.range_query_batch(st.Q, 0.7)
    st.se.knn_query_batch(st.Q, 5)
    with st.se.frontend(max_batch=8, slo_ms=5.0) as fe:
        threads = [threading.Thread(
            target=fe.knn_query, args=(st.Q[j], 3)) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    p = profile.last_profile()
    assert p is not None and not p.missing(), \
        f"demo must yield a complete QueryProfile, missing={p and p.missing()}"
    return st


def run_health_demo(st: SimpleNamespace | None = None, ticks: int = 10):
    """Inject placement drift and drive the closed loop by hand.

    Returns ``(state, monitor, daemon)`` with at least one heat-skew
    finding recorded and (cooldown permitting) a rebalance event in the
    daemon's audit ring.
    """
    from ..serving import MonitorDaemon, PlanRouter, ReplicaSet
    from .monitor import Monitor

    st = st if st is not None else demo_state("trace")
    snap = st.se.executor.snap
    replicas = ReplicaSet(snap, n_replicas=4)
    router = PlanRouter(replicas)
    # interval is irrelevant — the demo ticks manually, nothing starts
    # the sampler thread, so the loop below is fully deterministic
    mon = Monitor(interval=3600.0)
    daemon = MonitorDaemon(mon, lambda: router, engine=st.se,
                           cooldown_ticks=3)
    # the injected drift: ownership says replica 0 owns *everything*
    # while real query heat is spread — exactly what serving a stale
    # placement under shifted traffic looks like
    replicas.set_ownership(np.zeros(snap.K, np.int64))
    for _ in range(int(ticks)):
        router.knn_query_batch(st.Q, 5)
        mon.tick()
    return st, mon, daemon
