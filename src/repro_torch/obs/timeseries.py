"""Bounded time-series layer over the metrics registry.

Port of ``repro/obs/timeseries.py`` (the reference's DESIGN.md §12),
copied.

The registry (``repro_torch.obs.registry``) holds *instantaneous* state:
cumulative counters, last-writer-wins gauges, reservoir histograms.
This module adds the notion of **time**: a :class:`SeriesStore` samples
a registry on every monitor tick and appends one point per metric into
bounded ring-buffer :class:`Series`:

* counters   -> ``delta`` series (per-tick increments, so rates and
  windowed sums are trivial and counter resets self-heal),
* gauges     -> ``level`` series (the sampled value),
* histograms -> three derived ``level``/``delta`` series:
  ``<name>.p50`` and ``<name>.p99`` (reservoir percentiles at sample
  time) plus ``<name>.rate`` (observation-count delta per tick).

Everything is plain host Python under one lock — sampling touches no
device state and allocates O(#metrics) per tick.  Ring capacity comes
from ``REPRO_MONITOR_SERIES_CAP`` (default 512 points per series).

Health detectors (``repro_torch.obs.health``) read these series; nothing in
this module starts threads — the sampler loop lives in
``repro_torch.obs.monitor``.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Iterable

from . import registry as _reg
from .registry import Counter, Gauge, Histogram, MetricsRegistry, _int_knob

__all__ = ["Series", "SeriesStore", "series_cap", "sparkline"]

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def series_cap() -> int:
    """Ring capacity per series (``REPRO_MONITOR_SERIES_CAP``, >= 1)."""
    return _int_knob("REPRO_MONITOR_SERIES_CAP", 512)


class Series:
    """One bounded ring of float samples, appended once per tick.

    ``kind`` is ``"delta"`` (per-tick increments of a cumulative
    counter) or ``"level"`` (sampled instantaneous values).  The
    distinction matters to consumers: summing a delta series over a
    window gives the window total, while a level series is averaged.
    """

    __slots__ = ("name", "kind", "_vals")

    def __init__(self, name: str, kind: str = "level", cap: int | None = None):
        if kind not in ("delta", "level"):
            raise ValueError(f"series kind must be delta|level, got {kind!r}")
        self.name = name
        self.kind = kind
        self._vals: deque[float] = deque(maxlen=cap or series_cap())

    def append(self, v: float) -> None:
        self._vals.append(float(v))

    def extend(self, vs: Iterable[float]) -> None:
        for v in vs:
            self._vals.append(float(v))

    def __len__(self) -> int:
        return len(self._vals)

    def values(self) -> list[float]:
        return list(self._vals)

    def last(self) -> float | None:
        return self._vals[-1] if self._vals else None

    def window(self, n: int) -> list[float]:
        """The most recent ``n`` samples (fewer if the ring is shorter)."""
        if n <= 0:
            return []
        vs = self._vals
        return list(vs)[-n:] if len(vs) > n else list(vs)

    def window_mean(self, n: int) -> float | None:
        w = self.window(n)
        return sum(w) / len(w) if w else None

    def window_sum(self, n: int) -> float:
        return float(sum(self.window(n)))

    def stats(self) -> dict:
        vs = list(self._vals)
        if not vs:
            return {"kind": self.kind, "n": 0}
        return {
            "kind": self.kind,
            "n": len(vs),
            "last": vs[-1],
            "mean": sum(vs) / len(vs),
            "min": min(vs),
            "max": max(vs),
        }


def sparkline(values: list[float], width: int = 24) -> str:
    """Unicode block sparkline of the last ``width`` values."""
    vs = [v for v in values[-width:] if not math.isnan(v)]
    if not vs:
        return ""
    lo, hi = min(vs), max(vs)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(vs)
    top = len(_SPARK_BLOCKS) - 1
    return "".join(
        _SPARK_BLOCKS[min(top, int((v - lo) / span * top + 0.5))] for v in vs)


class SeriesStore:
    """Named series rings plus the registry sampler that feeds them."""

    def __init__(self, cap: int | None = None):
        self._cap = cap or series_cap()
        self._series: dict[str, Series] = {}
        self._prev_counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self.ticks = 0

    # -- access ----------------------------------------------------------
    def series(self, name: str, kind: str = "level") -> Series:
        """Get-or-create the series ``name`` (kind fixed at creation)."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = Series(name, kind, self._cap)
            return s

    def get(self, name: str) -> Series | None:
        with self._lock:
            return self._series.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def match(self, prefix: str) -> list[Series]:
        """All series whose name starts with ``prefix`` (sorted by name)."""
        with self._lock:
            return [s for n, s in sorted(self._series.items())
                    if n.startswith(prefix)]

    # -- sampling --------------------------------------------------------
    def sample(self, registry: MetricsRegistry | None = None) -> None:
        """Append one point per registry metric (one monitor tick)."""
        reg = registry if registry is not None else _reg.REGISTRY
        for m in reg.metrics():
            if isinstance(m, Counter):
                v = m.value
                prev = self._prev_counts.get(m.name, 0)
                # counter reset (registry.reset() / fresh process) shows
                # as v < prev: restart the delta baseline, don't go
                # negative
                self.series(m.name, "delta").append(v - prev if v >= prev else v)
                self._prev_counts[m.name] = v
            elif isinstance(m, Gauge):
                self.series(m.name, "level").append(m.value)
            elif isinstance(m, Histogram):
                snap = m.snapshot()
                self.series(m.name + ".p50", "level").append(snap["p50"])
                self.series(m.name + ".p99", "level").append(snap["p99"])
                cnt = snap["count"]
                key = m.name + ".rate"
                prev = self._prev_counts.get(key, 0)
                self.series(key, "delta").append(cnt - prev if cnt >= prev else cnt)
                self._prev_counts[key] = cnt
        self.ticks += 1

    def snapshot(self, spark_width: int = 24) -> dict:
        """JSON-ready summary of every series (stats + sparkline)."""
        with self._lock:
            items = sorted(self._series.items())
        out = {}
        for name, s in items:
            st = s.stats()
            st["spark"] = sparkline(s.values(), spark_width)
            out[name] = st
        return out
