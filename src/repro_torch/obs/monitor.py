"""Continuous index-health monitor: the sampler loop.

Port of ``repro/obs/monitor.py`` (the reference's DESIGN.md §12),
copied.

A :class:`Monitor` owns one :class:`~repro_torch.obs.timeseries.SeriesStore`,
a set of :class:`~repro_torch.obs.health.Detector` instances, and a bounded
findings ring.  Each **tick** it (1) runs registered probe callables
(cheap gauges computed on demand, e.g. the router's heat-skew), (2)
samples the metrics registry into the series store, (3) evaluates every
detector, and (4) appends new :class:`HealthFinding`s to the ring and
fans them out to subscriber callbacks (the serving
:class:`~repro_torch.serving.daemon.MonitorDaemon` is the canonical
subscriber).

Ticks can be driven two ways:

* **manually** — call :meth:`Monitor.tick` yourself; deterministic, the
  form every test uses;
* **periodically** — :meth:`Monitor.start` spawns one daemon thread
  ticking every ``interval`` seconds (``REPRO_MONITOR_INTERVAL``,
  default 0.5s).  :meth:`Monitor.stop` joins it with a timeout; all
  started monitors are also stopped by an atexit hook, mirroring the
  reference's prefetch-worker lifecycle.

Mode: ``REPRO_MONITOR`` (off | on, default off) is read once at import
and cached in :data:`_MODE` — with ``off`` nothing here spawns a
thread and the gate helpers (:func:`monitor_enabled`,
:func:`maybe_monitor`) return without allocating (tracemalloc-pinned,
like ``REPRO_OBS=off``).
"""
from __future__ import annotations

import atexit
import threading
from collections import deque

from .. import env
from . import registry as _reg
from .health import Detector, HealthFinding, default_detectors
from .registry import MetricsRegistry, _int_knob
from .timeseries import SeriesStore

__all__ = ["Monitor", "monitor_enabled", "monitor_mode", "configure_monitor",
           "maybe_monitor", "active_monitors", "shutdown_monitors",
           "monitor_interval", "findings_cap"]


def _resolve_mode() -> str:
    return env.get("REPRO_MONITOR")


_MODE: str = _resolve_mode()


def monitor_mode() -> str:
    """The cached monitor mode: 'off' | 'on'."""
    return _MODE


def monitor_enabled() -> bool:
    return _MODE == "on"


def configure_monitor(mode: str | None = None) -> str:
    """Set the monitor mode ('off'|'on'), or re-read ``REPRO_MONITOR``
    when ``mode`` is None.  Returns the active mode.  Flipping the mode
    does not stop already-running monitors — owners do that."""
    global _MODE
    if mode is None:
        _MODE = _resolve_mode()
    else:
        mode = str(mode).strip().lower()
        if mode not in ("off", "on"):
            raise ValueError(f"monitor mode must be off|on, got {mode!r}")
        _MODE = mode
    return _MODE


def monitor_interval() -> float:
    """Sampler tick interval in seconds (``REPRO_MONITOR_INTERVAL``)."""
    raw = env.get("REPRO_MONITOR_INTERVAL")
    if raw is None or str(raw).strip() == "":
        return 0.5
    try:
        v = float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"REPRO_MONITOR_INTERVAL={raw!r} is not a valid setting "
            "(expected a float, seconds)")
    if v <= 0:
        raise ValueError(f"REPRO_MONITOR_INTERVAL must be > 0, got {v}")
    return v


def findings_cap() -> int:
    """Findings ring capacity (``REPRO_MONITOR_FINDINGS``, >= 1)."""
    return _int_knob("REPRO_MONITOR_FINDINGS", 256)


# started monitors, tracked for the atexit join (mirrors the reference's
# prefetch worker's shutdown contract: bounded join, never hangs interpreter exit)
_ACTIVE: set = set()
_ACTIVE_LOCK = threading.Lock()


class Monitor:
    """Sampler + detectors + findings ring over one metrics registry."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 interval: float | None = None,
                 detectors: list[Detector] | None = None,
                 series_cap: int | None = None,
                 findings: int | None = None):
        self.registry = registry if registry is not None else _reg.REGISTRY
        self.interval = float(interval) if interval is not None \
            else monitor_interval()
        self.store = SeriesStore(series_cap)
        self.detectors = list(detectors) if detectors is not None \
            else default_detectors()
        self._findings: deque[HealthFinding] = deque(
            maxlen=findings or findings_cap())
        self._probes: list = []
        self._subscribers: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- wiring ----------------------------------------------------------
    def add_probe(self, fn) -> None:
        """Register a zero-arg callable run at the start of every tick
        (compute on-demand gauges before sampling).  Probe exceptions
        are counted (``monitor.probe_errors``), never propagated."""
        with self._lock:
            self._probes.append(fn)

    def subscribe(self, fn) -> None:
        """Register a callback invoked with each new HealthFinding."""
        with self._lock:
            self._subscribers.append(fn)

    # -- one tick --------------------------------------------------------
    def tick(self) -> list[HealthFinding]:
        """Probe, sample, detect; returns the findings fired this tick."""
        with self._lock:
            probes = list(self._probes)
            subs = list(self._subscribers)
        for p in probes:
            try:
                p()
            except Exception:
                _reg.count("monitor.probe_errors")
        self.store.sample(self.registry)
        tick = self.store.ticks
        fired: list[HealthFinding] = []
        for det in self.detectors:
            fired.extend(det.evaluate(self.store, tick))
        if fired:
            with self._lock:
                self._findings.extend(fired)
            _reg.count("monitor.findings", len(fired))
        _reg.count("monitor.ticks")
        for f in fired:
            for s in subs:
                try:
                    s(f)
                except Exception:
                    _reg.count("monitor.subscriber_errors")
        return fired

    # -- background loop -------------------------------------------------
    def start(self) -> "Monitor":
        """Spawn the sampler thread (idempotent while running)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="lims-monitor", daemon=True)
            self._thread.start()
        with _ACTIVE_LOCK:
            _ACTIVE.add(self)
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                # a failing probe/detector must never kill the sampler
                _reg.count("monitor.tick_errors")

    def stop(self, timeout: float = 2.0) -> bool:
        """Stop and join the sampler thread (idempotent).  Returns True
        when no sampler thread remains alive."""
        with self._lock:
            t, self._thread = self._thread, None
        self._stop.set()
        if t is not None and t.is_alive():
            t.join(timeout)
        with _ACTIVE_LOCK:
            _ACTIVE.discard(self)
        return t is None or not t.is_alive()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- inspection ------------------------------------------------------
    def findings(self, n: int | None = None) -> list[HealthFinding]:
        """Most recent findings, newest last (all when ``n`` is None)."""
        with self._lock:
            out = list(self._findings)
        return out if n is None else out[-n:]

    def snapshot(self, spark_width: int = 24) -> dict:
        """JSON-ready monitor state: series stats, findings, detectors."""
        return {
            "interval_s": self.interval,
            "running": self.running,
            "ticks": self.store.ticks,
            "series": self.store.snapshot(spark_width),
            "findings": [f.as_dict() for f in self.findings()],
            "detectors": [d.state() for d in self.detectors],
        }


def maybe_monitor(**kw) -> Monitor | None:
    """A fresh started Monitor when ``REPRO_MONITOR=on``, else None.

    This is the gate serving layers call at construction time — with
    the knob off it is one string compare and no allocation."""
    if _MODE != "on":
        return None
    return Monitor(**kw).start()


def active_monitors() -> list[Monitor]:
    """Monitors with a live sampler thread (stop() removes them)."""
    with _ACTIVE_LOCK:
        return list(_ACTIVE)


def shutdown_monitors(timeout: float = 2.0) -> bool:
    """Stop every started monitor; True when all joined within timeout.

    Registered atexit so stray monitors never block interpreter exit;
    also callable directly (tests, embedders)."""
    ok = True
    for m in active_monitors():
        ok = m.stop(timeout) and ok
    return ok


atexit.register(shutdown_monitors)
