"""Health detectors: typed findings over monitor time series.

Port of ``repro/obs/health.py`` (the reference's DESIGN.md §12), copied.

Each detector turns a scalar **signal** derived from the
:class:`~repro_torch.obs.timeseries.SeriesStore` into typed
:class:`HealthFinding` events with hysteresis, so one noisy tick never
fires an action and a signal hovering at the threshold never flaps:

* the detector *arms* while the signal is >= ``trigger`` and fires only
  after ``persistence`` consecutive over-trigger ticks;
* once active it re-fires at most every ``refire`` ticks (the findings
  ring stays auditable without flooding);
* it *clears* only when the signal drops to <= ``clear`` (< trigger),
  emitting an informational cleared-finding.

Detectors are pure functions of the series store — no threads, no
registry access — so unit tests drive them deterministically over
hand-built series.  The sampler loop that feeds them lives in
``repro_torch.obs.monitor``; the serving reactions live in
``repro_torch.serving.daemon``.

The four shipped detectors watch the decay modes called out in the
paper's §6 dynamic workload and ROADMAP item 2:

* :class:`RankDriftDetector` — per-cluster observed rank-model error
  (``executor.rank_err_ratio.c<k>`` gauges, fed by the executor's
  per-batch observed-rank-error stat) as a fraction of the certified
  bound E.  Signal = max over clusters of the last sampled ratio.
* :class:`PruningRegressionDetector` — pruning power erosion: the
  ``profile.candidates_per_query.p50`` series against its own early
  baseline.  Signal = recent-window mean / baseline mean.
* :class:`HeatSkewDetector` — cache heat vs replica ownership: the
  ``router.heat_skew`` gauge (max per-replica owned heat / mean).
* :class:`SloBurnDetector` — frontend error-budget burn: window miss
  rate over ``frontend.slo_ok``/``frontend.slo_miss`` deltas divided
  by the budget (1 - objective).  Burn 1.0 = exactly on budget.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .timeseries import SeriesStore

__all__ = ["HealthFinding", "Detector", "RankDriftDetector",
           "PruningRegressionDetector", "HeatSkewDetector",
           "SloBurnDetector", "default_detectors"]

SEVERITIES = ("info", "warn", "critical")


@dataclass(frozen=True)
class HealthFinding:
    """One detector event: something crossed (or re-crossed) a threshold."""

    detector: str          # detector name, e.g. "heat_skew"
    severity: str          # "info" | "warn" | "critical"
    summary: str           # human-readable one-liner
    value: float           # the signal value at fire time
    threshold: float       # the trigger it was compared against
    tick: int              # store tick index when fired (deterministic)
    cleared: bool = False  # True for the informational clear event
    context: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "detector": self.detector, "severity": self.severity,
            "summary": self.summary, "value": self.value,
            "threshold": self.threshold, "tick": self.tick,
            "cleared": self.cleared, "context": dict(self.context),
        }


class Detector:
    """Hysteresis base: subclasses implement :meth:`signal`.

    State machine (evaluated once per tick):

    ``idle`` --signal >= trigger for `persistence` ticks--> ``active``
    (fires a finding); ``active`` --signal <= clear--> ``idle`` (fires
    a cleared info finding); while ``active``, re-fires every
    ``refire`` ticks.  A signal of ``None`` (no data yet) leaves the
    state untouched.
    """

    name = "detector"

    def __init__(self, trigger: float, clear: float | None = None,
                 persistence: int = 3, refire: int = 10,
                 critical_at: float | None = None):
        if clear is None:
            clear = trigger * 0.75
        if clear >= trigger:
            raise ValueError(
                f"{self.name}: clear ({clear}) must be < trigger ({trigger})")
        self.trigger = float(trigger)
        self.clear = float(clear)
        self.persistence = max(1, int(persistence))
        self.refire = max(1, int(refire))
        self.critical_at = critical_at
        self.active = False
        self._over = 0           # consecutive over-trigger ticks while idle
        self._fired_tick = -1    # tick of the last emitted active finding

    # -- subclass API ----------------------------------------------------
    def signal(self, store: SeriesStore) -> Optional[tuple[float, dict]]:
        """(value, context) of the watched signal, or None if no data."""
        raise NotImplementedError

    def describe(self, value: float, context: dict) -> str:
        return (f"{self.name} signal {value:.3g} over trigger "
                f"{self.trigger:.3g}")

    # -- hysteresis ------------------------------------------------------
    def evaluate(self, store: SeriesStore, tick: int) -> list[HealthFinding]:
        sig = self.signal(store)
        if sig is None:
            return []
        value, context = sig
        value = float(value)
        out: list[HealthFinding] = []
        if not self.active:
            if value >= self.trigger:
                self._over += 1
                if self._over >= self.persistence:
                    self.active = True
                    self._fired_tick = tick
                    out.append(self._finding(value, context, tick))
            else:
                self._over = 0
        else:
            if value <= self.clear:
                self.active = False
                self._over = 0
                out.append(HealthFinding(
                    detector=self.name, severity="info",
                    summary=f"{self.name} cleared "
                            f"(signal {value:.3g} <= {self.clear:.3g})",
                    value=value, threshold=self.clear, tick=tick,
                    cleared=True, context=dict(context)))
            elif (value >= self.trigger
                  and tick - self._fired_tick >= self.refire):
                # still firing over trigger — re-emit (bounded by refire)
                # so long-lived conditions stay visible; inside the
                # hysteresis band (clear, trigger) stay active silently
                self._fired_tick = tick
                out.append(self._finding(value, context, tick))
        return out

    def _finding(self, value: float, context: dict,
                 tick: int) -> HealthFinding:
        sev = "warn"
        if self.critical_at is not None and value >= self.critical_at:
            sev = "critical"
        return HealthFinding(
            detector=self.name, severity=sev,
            summary=self.describe(value, context), value=value,
            threshold=self.trigger, tick=tick, context=dict(context))

    def state(self) -> dict:
        return {"name": self.name, "active": self.active,
                "trigger": self.trigger, "clear": self.clear,
                "persistence": self.persistence}


class RankDriftDetector(Detector):
    """Observed per-cluster rank-model error approaching the certified
    bound E: ratio 1.0 means the model is mispredicting ranks by as
    much as its ring-widening budget assumes — exactness still holds
    (E certifies the widening), but pruning pays full price and any
    further drift after a retrain-free refresh erodes the margin."""

    name = "rank_drift"

    def __init__(self, trigger: float = 0.75, clear: float = 0.5,
                 persistence: int = 2, refire: int = 10,
                 critical_at: float | None = 1.0):
        super().__init__(trigger, clear, persistence, refire, critical_at)

    def signal(self, store: SeriesStore):
        worst, worst_name = None, None
        for s in store.match("executor.rank_err_ratio.c"):
            v = s.last()
            if v is not None and (worst is None or v > worst):
                worst, worst_name = v, s.name
        if worst is None:
            return None
        cluster = int(worst_name.rsplit(".c", 1)[1])
        return worst, {"cluster": cluster, "series": worst_name}

    def describe(self, value, context):
        return (f"cluster {context['cluster']} observed rank error at "
                f"{value:.2f}x the certified bound E "
                f"(trigger {self.trigger:.2f})")


class PruningRegressionDetector(Detector):
    """Pruning power erosion: median candidates/query trending up
    against this store's own early baseline (first ``baseline_n``
    samples of ``profile.candidates_per_query.p50``)."""

    name = "pruning_regression"

    def __init__(self, trigger: float = 2.0, clear: float = 1.5,
                 persistence: int = 3, refire: int = 10,
                 baseline_n: int = 5, window: int = 3,
                 series: str = "profile.candidates_per_query.p50"):
        super().__init__(trigger, clear, persistence, refire)
        self.baseline_n = max(1, int(baseline_n))
        self.window = max(1, int(window))
        self.series_name = series

    def signal(self, store: SeriesStore):
        s = store.get(self.series_name)
        if s is None or len(s) < self.baseline_n + 1:
            return None
        vs = s.values()
        baseline = sum(vs[:self.baseline_n]) / self.baseline_n
        if baseline <= 0:
            return None
        recent = vs[-self.window:]
        ratio = (sum(recent) / len(recent)) / baseline
        return ratio, {"baseline": baseline,
                       "recent": sum(recent) / len(recent)}

    def describe(self, value, context):
        return (f"candidates/query at {value:.2f}x its baseline "
                f"({context['recent']:.1f} vs {context['baseline']:.1f}; "
                f"trigger {self.trigger:.2f}x)")


class HeatSkewDetector(Detector):
    """Cache heat vs replica ownership drift: the ``router.heat_skew``
    gauge (max per-replica owned heat / mean) — 1.0 is perfectly
    balanced, R means one replica owns all the heat."""

    name = "heat_skew"

    def __init__(self, trigger: float = 1.5, clear: float = 1.15,
                 persistence: int = 2, refire: int = 5):
        super().__init__(trigger, clear, persistence, refire)

    def signal(self, store: SeriesStore):
        s = store.get("router.heat_skew")
        if s is None or not len(s):
            return None
        return s.last(), {}

    def describe(self, value, context):
        return (f"replica heat skew {value:.2f}x mean "
                f"(trigger {self.trigger:.2f}x) — ownership no longer "
                f"matches query heat")


class SloBurnDetector(Detector):
    """Frontend error-budget burn rate: window miss fraction over the
    ``frontend.slo_ok``/``frontend.slo_miss`` delta series divided by
    the budget (1 - objective).  Burn 1.0 spends the budget exactly;
    the default trigger 2.0 / critical 14.0 mirrors SRE fast-burn
    alerting."""

    name = "slo_burn"

    def __init__(self, trigger: float = 2.0, clear: float = 1.0,
                 persistence: int = 2, refire: int = 5,
                 objective: float = 0.99, window: int = 10):
        super().__init__(trigger, clear, persistence, refire,
                         critical_at=14.0)
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.objective = float(objective)
        self.window = max(1, int(window))

    def signal(self, store: SeriesStore):
        ok = store.get("frontend.slo_ok")
        miss = store.get("frontend.slo_miss")
        n_ok = ok.window_sum(self.window) if ok is not None else 0.0
        n_miss = miss.window_sum(self.window) if miss is not None else 0.0
        total = n_ok + n_miss
        if total <= 0:
            return None
        burn = (n_miss / total) / (1.0 - self.objective)
        return burn, {"ok": n_ok, "miss": n_miss,
                      "objective": self.objective}

    def describe(self, value, context):
        return (f"SLO burn rate {value:.1f}x budget "
                f"({int(context['miss'])} misses / "
                f"{int(context['ok'] + context['miss'])} requests at "
                f"{context['objective']:.2%} objective)")


def default_detectors() -> list[Detector]:
    """Fresh instances of the four shipped detectors (stateful — one
    set per monitor)."""
    return [RankDriftDetector(), PruningRegressionDetector(),
            HeatSkewDetector(), SloBurnDetector()]
