"""The closed loop: health findings → serving actions.

Port of ``repro/serving/daemon.py`` (the reference's DESIGN.md §12),
copied.  The router it rebalances (``PlanRouter``) and the replica set
behind it are not ported yet (ROADMAP A10): until they are, every
caller passes ``router_fn=lambda: None``, as the reference's callers do
before their first routed batch, so the heat-skew branch never runs and
the rank-drift branch (retrain recommendations and automatic retrains
on the ``ServingEngine``) is the loop.

:class:`MonitorDaemon` is the subscriber that turns the monitor's
:class:`~repro_torch.obs.health.HealthFinding`s into operations on the
serving stack — the "placement daemon reacting to heat drift" ROADMAP
item 2 called for:

* ``heat_skew`` findings → :meth:`PlanRouter.rebalance` (fold the live
  heat signal back into replica ownership).  The detector's hysteresis
  already debounces the *signal*; the daemon adds an **action cooldown**
  (``cooldown_ticks`` monitor ticks between rebalances) so even a
  re-firing finding can never thrash placement.
* ``rank_drift`` findings → retrain handling per
  ``REPRO_MONITOR_RETRAIN``: ``off`` ignores them, ``recommend``
  records :meth:`ServingEngine.recommend_retrain` for the drifting
  cluster, ``auto`` additionally calls
  :meth:`ServingEngine.retrain_cluster` (same cooldown discipline,
  keyed per detector).

Every action (and every deliberate skip while cooling down) lands in a
bounded audit ring (:meth:`events`) with the triggering finding, so the
loop is inspectable after the fact — an autonomous actor nobody can
audit is a liability, not a feature.

The daemon owns no thread: it registers the router heat-skew probe on
the monitor (computing the ``router.heat_skew`` gauge each tick) and
reacts inside the monitor's tick, so manual-tick tests drive the whole
loop deterministically.
"""
from __future__ import annotations

import threading
from collections import deque

from .. import env
from ..obs import registry as _obs
from ..obs.health import HealthFinding
from ..obs.monitor import Monitor

__all__ = ["MonitorDaemon"]

_ACTIONABLE = ("warn", "critical")


def retrain_mode() -> str:
    """``REPRO_MONITOR_RETRAIN``: off | recommend | auto."""
    return env.get("REPRO_MONITOR_RETRAIN")


class MonitorDaemon:
    """Subscribe a serving stack to a monitor's findings and act.

    ``router_fn`` returns the live :class:`PlanRouter` (or None before
    the first routed batch) — a callable because the frontend rebuilds
    its router on generation change.  ``engine`` (optional) receives
    retrain recommendations.  ``retrain`` overrides the
    ``REPRO_MONITOR_RETRAIN`` knob when given.
    """

    def __init__(self, monitor: Monitor, router_fn, engine=None,
                 cooldown_ticks: int = 5, retrain: str | None = None,
                 max_events: int = 256):
        if retrain is not None and retrain not in ("off", "recommend",
                                                   "auto"):
            raise ValueError(
                f"retrain must be off|recommend|auto, got {retrain!r}")
        self.monitor = monitor
        self._router_fn = router_fn
        self._engine = engine
        self.cooldown_ticks = max(1, int(cooldown_ticks))
        self._retrain = retrain
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        # per-detector tick of the last *action* (cooldown keys)
        self._last_action: dict[str, int] = {}
        monitor.add_probe(self._probe)
        monitor.subscribe(self._on_finding)

    # -- per-tick probe --------------------------------------------------
    def _probe(self) -> None:
        """Publish the router's heat-skew gauge so the detector has a
        fresh signal every tick (cheap: one (R,K)@(K,) matvec)."""
        router = self._router_fn()
        if router is not None:
            router.heat_skew()

    # -- findings → actions ----------------------------------------------
    def _on_finding(self, f: HealthFinding) -> None:
        if f.cleared or f.severity not in _ACTIONABLE:
            return
        if f.detector == "heat_skew":
            self._act_rebalance(f)
        elif f.detector == "rank_drift":
            self._act_retrain(f)

    def _cooling(self, f: HealthFinding) -> bool:
        """True (and audited) when the detector acted too recently."""
        with self._lock:
            last = self._last_action.get(f.detector)
            if last is not None and f.tick - last < self.cooldown_ticks:
                self._events.append({
                    "action": "cooldown_skip", "detector": f.detector,
                    "tick": f.tick, "last_action_tick": last,
                    "finding": f.as_dict()})
                return True
            self._last_action[f.detector] = f.tick
        return False

    def _act_rebalance(self, f: HealthFinding) -> None:
        router = self._router_fn()
        if router is None or self._cooling(f):
            return
        owner = router.rebalance()
        _obs.count("daemon.rebalances")
        with self._lock:
            self._events.append({
                "action": "rebalance", "detector": f.detector,
                "tick": f.tick, "skew": f.value,
                "owner": owner.tolist(), "finding": f.as_dict()})

    def _act_retrain(self, f: HealthFinding) -> None:
        mode = self._retrain if self._retrain is not None else retrain_mode()
        if mode == "off" or self._engine is None:
            return
        if self._cooling(f):
            return
        cluster = f.context.get("cluster")
        if cluster is None:
            return
        self._engine.recommend_retrain(cluster, reason=f.summary)
        action = "retrain_recommend"
        if mode == "auto":
            self._engine.retrain_cluster(int(cluster))
            _obs.count("daemon.retrains")
            action = "retrain_auto"
        with self._lock:
            self._events.append({
                "action": action, "detector": f.detector, "tick": f.tick,
                "cluster": int(cluster), "finding": f.as_dict()})

    # -- inspection ------------------------------------------------------
    def events(self, n: int | None = None) -> list:
        """The audit ring, oldest first (all when ``n`` is None)."""
        with self._lock:
            out = list(self._events)
        return out if n is None else out[-n:]

    def snapshot(self) -> dict:
        with self._lock:
            return {"cooldown_ticks": self.cooldown_ticks,
                    "retrain_mode": self._retrain or retrain_mode(),
                    "last_action": dict(self._last_action),
                    "events": list(self._events)}
