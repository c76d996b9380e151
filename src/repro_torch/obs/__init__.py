"""Unified observability for the serving stack.

Port of ``repro/obs/__init__.py`` (the reference's DESIGN.md §11), with
the same exports; ``demo`` and ``report`` wait for the frontend and the
replica set (ROADMAP A10).

One process-wide metrics registry (counters / gauges / bounded-reservoir
histograms), a span tracer over the query path, per-batch
``QueryProfile`` records, and exporters (JSON, Prometheus text, Chrome
trace_event).  Controlled by ``REPRO_OBS=off|on|trace``; the disabled
path costs one string compare and allocates nothing.

    from repro_torch import obs
    with obs.span("my.stage"):
        ...
    obs.count("my.counter")
    print(obs.json_snapshot())
"""
from .registry import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, configure, count, enabled,
                       obs_mode, observe, set_gauge, tracing)
from .trace import (clear_trace, instant, span, trace_events,  # noqa: F401
                    trace_len)
from .profile import (QueryProfile, clear_profiles,  # noqa: F401
                      last_profile, profiles, record_profile)
from .export import (chrome_trace, json_snapshot,  # noqa: F401
                     prometheus_text, write_chrome_trace,
                     write_json_snapshot, write_prometheus)
from .timeseries import Series, SeriesStore, sparkline  # noqa: F401
from .health import (Detector, HealthFinding,  # noqa: F401
                     HeatSkewDetector, PruningRegressionDetector,
                     RankDriftDetector, SloBurnDetector,
                     default_detectors)
from .monitor import (Monitor, active_monitors,  # noqa: F401
                      configure_monitor, maybe_monitor, monitor_enabled,
                      monitor_mode, shutdown_monitors)

__all__ = [
    "REGISTRY", "Counter", "Detector", "Gauge", "HealthFinding",
    "HeatSkewDetector", "Histogram", "MetricsRegistry", "Monitor",
    "PruningRegressionDetector", "QueryProfile", "RankDriftDetector",
    "Series", "SeriesStore", "SloBurnDetector", "active_monitors",
    "chrome_trace", "clear_profiles", "clear_trace", "configure",
    "configure_monitor", "count", "default_detectors", "enabled",
    "instant", "json_snapshot", "last_profile", "maybe_monitor",
    "monitor_enabled", "monitor_mode", "obs_mode", "observe", "profiles",
    "prometheus_text", "record_profile", "set_gauge", "shutdown_monitors",
    "span", "sparkline", "trace_events", "trace_len", "tracing",
    "write_chrome_trace", "write_json_snapshot", "write_prometheus",
]
