"""Process-wide metrics registry: counters, gauges, bounded-reservoir
histograms.

Port of ``repro/obs/registry.py``, copied: this module is pure Python.

The paper's evaluation currency is per-query cost — pages read,
candidates pruned, distance computations — and until now the
reproduction surfaced it as ad-hoc dicts scattered across layers
(``frontend.metrics()``, ``CacheStats``, prefetch ledgers, ``last_knn``
counts).  This module is the one place those signals land: every layer
records through the module-level helpers (:func:`count`,
:func:`observe`, :func:`set_gauge`) into one :data:`REGISTRY`, and the
exporters (``repro_torch.obs.export``) read the registry instead of chasing
per-object dicts.

Design constraints, in order:

* **Cheap when off.**  ``REPRO_OBS=off`` must cost a single global
  string compare per call and allocate *nothing* (pinned by a
  tracemalloc test) — the helpers return before touching the registry,
  and :func:`span` returns a shared no-op singleton.
* **Thread-safe, lock-light.**  Serving is many submitter threads over
  shared executors; every metric carries its own small lock, held for a
  few arithmetic ops — never across IO or kernel dispatch.  The
  registry dict itself is guarded only on get-or-create.
* **Bounded.**  Histograms keep a fixed-size reservoir (Vitter's
  algorithm R, deterministic per-name seed) plus exact count / sum /
  min / max, so a frontend that serves forever holds O(reservoir)
  memory while its mean and extremes stay exact; percentiles are exact
  until the reservoir overflows and statistically representative after.

Mode resolution: ``REPRO_OBS`` (off | on | trace, default on) is read
once at import and cached in :data:`_MODE`; tests and embedders flip it
with :func:`configure`.  ``on`` records metrics and span durations;
``trace`` additionally appends Chrome ``trace_event`` records
(``repro_torch.obs.trace``).
"""
from __future__ import annotations

import threading
import zlib
from bisect import bisect_left
from random import Random

from .. import env


def _int_knob(name: str, fallback: int) -> int:
    raw = env.get(name)
    if raw is None or str(raw).strip() == "":
        return fallback
    try:
        v = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name}={raw!r} is not a valid setting (expected an integer)")
    if v < 1:
        raise ValueError(f"{name} must be >= 1, got {v}")
    return v


def _resolve_mode() -> str:
    return env.get("REPRO_OBS")


_MODE: str = _resolve_mode()


def obs_mode() -> str:
    """The cached observability mode: 'off' | 'on' | 'trace'."""
    return _MODE


def enabled() -> bool:
    return _MODE != "off"


def tracing() -> bool:
    return _MODE == "trace"


def configure(mode: str | None = None) -> str:
    """Set the observability mode ('off'|'on'|'trace'), or re-read
    ``REPRO_OBS`` when ``mode`` is None.  Returns the active mode.
    Existing metric values are kept — mode only gates *recording*."""
    global _MODE
    if mode is None:
        _MODE = _resolve_mode()
    else:
        mode = str(mode).strip().lower()
        if mode not in ("off", "on", "trace"):
            raise ValueError(f"obs mode must be off|on|trace, got {mode!r}")
        _MODE = mode
    return _MODE


def default_reservoir() -> int:
    """Histogram reservoir capacity (``REPRO_OBS_RESERVOIR``)."""
    return _int_knob("REPRO_OBS_RESERVOIR", 1024)


# ---------------------------------------------------------------------------
# metric types
# ---------------------------------------------------------------------------
class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "help", "_v", "_lock")

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0

    def snapshot(self):
        return self._v


class Gauge:
    """Last-writer-wins scalar (queue depth, replica count, ...)."""

    __slots__ = ("name", "help", "_v", "_lock")

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._v += float(dv)

    @property
    def value(self) -> float:
        return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0.0

    def snapshot(self):
        return self._v


# fixed log-spaced Prometheus bucket bounds: half-decade steps covering
# ~3.2e-7 .. 1e4 — wide enough for latencies in seconds, queue depths,
# candidate counts, and page tallies without per-metric tuning.  Exact
# counts below/above the range still land in the first / +Inf bucket.
DEFAULT_BUCKET_BOUNDS: tuple[float, ...] = tuple(
    10.0 ** (e / 2.0) for e in range(-13, 9))


class Histogram:
    """Bounded-reservoir distribution with exact count/sum/min/max.

    The reservoir holds the first ``cap`` observations verbatim
    (percentiles are then *exact*, matched against numpy in tests);
    past ``cap`` it switches to Vitter's algorithm R — each later
    observation replaces a uniformly random slot with probability
    ``cap/count`` — so memory stays O(cap) while the reservoir remains
    a uniform sample of everything observed.  The RNG is seeded from
    the metric name, so runs are reproducible.

    Alongside the reservoir each histogram keeps *exact* fixed-bound
    bucket counts (``bounds``, default :data:`DEFAULT_BUCKET_BOUNDS`,
    recorded at creation) so the Prometheus exporter can emit real
    cumulative ``_bucket``/``le`` lines — burn-rate recording rules
    need them, and unlike the reservoir they never subsample.
    """

    __slots__ = ("name", "help", "cap", "bounds", "_bcounts", "_res",
                 "_count", "_sum", "_min", "_max", "_rng", "_lock")

    kind = "histogram"

    def __init__(self, name: str, cap: int | None = None, help: str = "",
                 bounds: tuple[float, ...] | None = None):
        self.name = name
        self.help = help
        self.cap = int(cap) if cap is not None else default_reservoir()
        if self.cap < 1:
            raise ValueError("histogram reservoir cap must be >= 1")
        self.bounds = tuple(sorted(float(b) for b in (
            bounds if bounds is not None else DEFAULT_BUCKET_BOUNDS)))
        self._bcounts = [0] * (len(self.bounds) + 1)  # last = overflow/+Inf
        self._res: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._rng = Random(zlib.crc32(name.encode()))
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self._count += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x
            # bisect_left puts x == bounds[i] into bucket i, matching
            # Prometheus' inclusive `le` semantics after cumsum
            self._bcounts[bisect_left(self.bounds, x)] += 1
            if len(self._res) < self.cap:
                self._res.append(x)
            else:
                j = self._rng.randrange(self._count)
                if j < self.cap:
                    self._res[j] = x

    def buckets(self) -> tuple[tuple[float, ...], list[int]]:
        """(bounds, cumulative counts) with a final +Inf entry equal to
        ``count`` — exactly the series a Prometheus ``_bucket`` family
        renders."""
        with self._lock:
            raw = list(self._bcounts)
        cum, total = [], 0
        for c in raw:
            total += c
            cum.append(total)
        return self.bounds, cum

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def __len__(self) -> int:
        """Resident reservoir size (bounded by ``cap``)."""
        return len(self._res)

    def percentile(self, p: float) -> float:
        """The p-th percentile (0..100) of the reservoir, linearly
        interpolated exactly like ``numpy.percentile``'s default — so
        for <= cap observations the two agree bit-for-bit (pinned in
        tests)."""
        with self._lock:
            s = sorted(self._res)
        if not s:
            return 0.0
        if len(s) == 1:
            return s[0]
        pos = (len(s) - 1) * (float(p) / 100.0)
        lo = int(pos)
        frac = pos - lo
        if lo + 1 >= len(s):
            return s[-1]
        # numpy's exact lerp form (lo + t*(hi-lo)), for bit-identity
        return s[lo] + frac * (s[lo + 1] - s[lo])

    def reset(self) -> None:
        with self._lock:
            self._res.clear()
            self._count = 0
            self._sum = 0.0
            self._min = float("inf")
            self._max = float("-inf")
            self._bcounts = [0] * (len(self.bounds) + 1)

    def snapshot(self) -> dict:
        with self._lock:
            n, s = self._count, self._sum
        return {
            "count": n, "sum": s,
            "mean": s / n if n else 0.0,
            "min": self.min, "max": self.max,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
class MetricsRegistry:
    """Name → metric map with get-or-create semantics.

    One instance (:data:`REGISTRY`) serves the whole process; layers
    never hold references to each other's metrics, only names.  A name
    maps to exactly one metric kind — asking for the same name as a
    different kind raises, catching wiring typos early.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, cap: int | None = None,
                  help: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, cap=cap, help=help)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def metrics(self) -> list:
        """Stable-ordered list of live metric objects."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """{name: value-or-dict} of everything registered."""
        return {m.name: m.snapshot() for m in self.metrics()}

    def reset(self) -> None:
        """Zero every metric (benchmarks isolating one workload); the
        metric objects themselves stay registered."""
        for m in self.metrics():
            m.reset()

    def clear(self) -> None:
        """Drop every metric (tests wanting a pristine registry)."""
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# mode-gated helpers: the API the instrumented layers call
# ---------------------------------------------------------------------------
def count(name: str, n: int = 1) -> None:
    """Increment counter ``name`` (no-op, zero-alloc when off)."""
    if _MODE == "off":
        return
    REGISTRY.counter(name).inc(n)


def observe(name: str, x: float) -> None:
    """Record ``x`` into histogram ``name`` (no-op when off)."""
    if _MODE == "off":
        return
    REGISTRY.histogram(name).observe(x)


def set_gauge(name: str, v: float) -> None:
    """Set gauge ``name`` (no-op when off)."""
    if _MODE == "off":
        return
    REGISTRY.gauge(name).set(v)


__all__ = ["Counter", "DEFAULT_BUCKET_BOUNDS", "Gauge", "Histogram",
           "MetricsRegistry", "REGISTRY", "configure", "count",
           "default_reservoir", "enabled", "obs_mode", "observe",
           "set_gauge", "tracing"]
