"""Exporters: registry + profiles + trace + monitor → JSON / Prometheus /
Chrome.

Port of ``repro/obs/export.py``, copied.

Three read-only renderings of the same state:

* :func:`json_snapshot` — everything (mode, metrics, recent
  QueryProfiles, trace depth, and — when a monitor is passed or active —
  its time series and findings) as one JSON-able dict; the programmatic
  surface.
* :func:`prometheus_text` — the text exposition format: counters and
  gauges as-is; histograms twice — the original summary family with
  quantile labels plus ``_count``/``_sum``, and a parallel ``<name>_hist``
  **histogram** family with real cumulative ``_bucket``/``le`` lines from
  the exact fixed-bound counts, so burn-rate recording rules are
  computable by a stock Prometheus.  Monitor series additionally render
  as ``lims_monitor_series`` gauges.  Metric names are sanitized
  (dots → underscores) to the Prometheus grammar.
* :func:`chrome_trace` / :func:`write_chrome_trace` — the span ring as a
  Chrome Trace Event Format JSON object, loadable in Perfetto or
  chrome://tracing.

Exporters never mutate state and take the same locks the recorders do,
so they are safe to call from a live serving process.
"""
from __future__ import annotations

import json

from . import profile as _prof
from . import registry as _reg
from . import trace as _trace


def _active_monitor(monitor):
    """Resolve an explicit monitor, else any running one, else None."""
    if monitor is not None:
        return monitor
    from . import monitor as _mon  # local import: monitor imports registry
    act = _mon.active_monitors()
    return act[0] if act else None


def json_snapshot(n_profiles: int = 32, monitor=None) -> dict:
    """One dict with the whole observability state (JSON-serializable).

    ``monitor`` adds that monitor's series/findings under ``"monitor"``;
    when omitted, a running monitor (if any) is picked up automatically.
    """
    doc = {
        "mode": _reg.obs_mode(),
        "metrics": _reg.REGISTRY.snapshot(),
        "profiles": [p.as_dict() for p in _prof.profiles(n_profiles)],
        "trace_events": _trace.trace_len(),
    }
    mon = _active_monitor(monitor)
    if mon is not None:
        doc["monitor"] = mon.snapshot()
    return doc


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return "lims_" + s


def prometheus_text(monitor=None) -> str:
    """The registry (plus monitor series, when one is passed or running)
    in Prometheus text exposition format."""
    lines: list[str] = []
    for m in _reg.REGISTRY.metrics():
        pn = _prom_name(m.name)
        if m.kind == "counter":
            lines.append(f"# TYPE {pn} counter")
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            lines.append(f"{pn} {m.value}")
        elif m.kind == "gauge":
            lines.append(f"# TYPE {pn} gauge")
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            lines.append(f"{pn} {_fmt(m.value)}")
        else:  # histogram → summary + real bucket family
            lines.append(f"# TYPE {pn} summary")
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            for q in (0.5, 0.9, 0.99):
                v = m.percentile(q * 100.0)
                lines.append(f'{pn}{{quantile="{_fmt(q)}"}} {_fmt(v)}')
            lines.append(f"{pn}_count {m.count}")
            lines.append(f"{pn}_sum {_fmt(m.sum)}")
            hn = pn + "_hist"
            bounds, cum = m.buckets()
            lines.append(f"# TYPE {hn} histogram")
            for b, c in zip(bounds, cum):
                lines.append(f'{hn}_bucket{{le="{_fmt(b)}"}} {c}')
            lines.append(f'{hn}_bucket{{le="+Inf"}} {cum[-1]}')
            lines.append(f"{hn}_count {cum[-1]}")
            lines.append(f"{hn}_sum {_fmt(m.sum)}")
    mon = _active_monitor(monitor)
    if mon is not None:
        lines.extend(_monitor_series_lines(mon))
    return "\n".join(lines) + "\n"


def _monitor_series_lines(mon) -> list[str]:
    """Series-derived gauges: last value and ring mean per series, plus
    tick and findings totals — the scrape surface for dashboarding the
    monitor without re-deriving series server-side."""
    lines = ["# TYPE lims_monitor_series gauge"]
    snap = mon.store.snapshot(spark_width=0)
    for name in sorted(snap):
        st = snap[name]
        if not st.get("n"):
            continue
        for stat in ("last", "mean"):
            lines.append(
                f'lims_monitor_series{{series="{name}",stat="{stat}"}} '
                f"{_fmt(st[stat])}")
    lines.append("# TYPE lims_monitor_ticks gauge")
    lines.append(f"lims_monitor_ticks {mon.store.ticks}")
    lines.append("# TYPE lims_monitor_findings_total gauge")
    lines.append(f"lims_monitor_findings_total {len(mon.findings())}")
    return lines


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def chrome_trace() -> dict:
    """The span ring as a Chrome Trace Event Format dict."""
    return _trace.trace_events()


def write_chrome_trace(path: str) -> int:
    """Write the Perfetto-loadable trace JSON to ``path``; returns the
    number of events written (excluding thread-name metadata)."""
    doc = chrome_trace()
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")


def write_json_snapshot(path: str, n_profiles: int = 32,
                        monitor=None) -> None:
    with open(path, "w") as f:
        json.dump(json_snapshot(n_profiles, monitor=monitor), f,
                  indent=2, sort_keys=True)


def write_prometheus(path: str, monitor=None) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(monitor=monitor))


__all__ = ["chrome_trace", "json_snapshot", "prometheus_text",
           "write_chrome_trace", "write_json_snapshot", "write_prometheus"]
