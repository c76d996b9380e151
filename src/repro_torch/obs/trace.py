"""Span-based tracing for the query path.

Port of ``repro/obs/trace.py``, copied.  Spans keep the reference's
host clock (``time.perf_counter``): every stage the executor wraps in a
span ends in that stage's one counted device→host copy, so a span
measures the stage's device work without a synchronisation or a CUDA
event of its own.

A *span* is one timed region of the request path — ``frontend.execute``,
``router.dispatch``, ``executor.knn``, ``storage.fetch`` — entered as a
context manager::

    with span("executor.knn", args={"B": 64}):
        ...

What a span costs depends on ``REPRO_OBS``:

* ``off`` — :func:`span` returns a shared no-op singleton; entering and
  exiting it does nothing and allocates nothing.
* ``on`` — the span's wall duration lands in the registry histogram
  ``span.<name>`` (seconds), so every stage of the query path gets
  p50/p99 latency for free.
* ``trace`` — additionally, a Chrome ``trace_event`` "complete" record
  (name, thread, start, duration, args) is appended to a bounded ring
  buffer.  :func:`trace_events` renders the ring as the Trace Event
  Format dict Perfetto / ``chrome://tracing`` load directly; the
  exporter (``repro_torch.obs.export``) writes it to a file.

The ring is ``REPRO_OBS_TRACE_CAP`` events (default 20000, oldest
dropped first), so tracing a long-running server is safe — you get the
most recent window, never unbounded growth.  Timestamps are
``perf_counter`` microseconds relative to a process epoch; thread ids
are compacted to small stable integers and named in the trace metadata
so Perfetto shows "lims-frontend" instead of a pointer-sized ident.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import registry as _reg
from .registry import _int_knob

_EPOCH = time.perf_counter()

_TRACE_LOCK = threading.Lock()
_EVENTS: deque | None = None        # created lazily at first trace append
_TIDS: dict[int, int] = {}          # thread ident → compact tid
_TID_NAMES: dict[int, str] = {}     # compact tid → thread name


def trace_cap() -> int:
    """Trace ring capacity (``REPRO_OBS_TRACE_CAP``)."""
    return _int_knob("REPRO_OBS_TRACE_CAP", 20000)


def _tid() -> int:
    t = threading.current_thread()
    ident = t.ident
    tid = _TIDS.get(ident)
    if tid is None:
        with _TRACE_LOCK:
            tid = _TIDS.get(ident)
            if tid is None:
                tid = len(_TIDS)
                _TIDS[ident] = tid
                _TID_NAMES[tid] = t.name
    return tid


def _append_event(name: str, t0: float, t1: float, args) -> None:
    global _EVENTS
    ev = (name, _tid(), (t0 - _EPOCH) * 1e6, (t1 - t0) * 1e6, args)
    with _TRACE_LOCK:
        if _EVENTS is None:
            _EVENTS = deque(maxlen=trace_cap())
        _EVENTS.append(ev)


class _Span:
    """Live span: duration → histogram, plus a trace event when tracing."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args=None):
        self.name = name
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        _reg.REGISTRY.histogram("span." + self.name).observe(t1 - self._t0)
        if _reg._MODE == "trace":
            _append_event(self.name, self._t0, t1, self.args)


class _NullSpan:
    """Shared no-op span for the disabled path (never allocates)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, args=None):
    """A context manager timing the enclosed region (see module doc).
    ``args`` (a small dict, or None) lands in the trace event's
    ``args`` field; hot callers pass None to avoid building it."""
    if _reg._MODE == "off":
        return _NULL
    return _Span(name, args)


def instant(name: str, args=None) -> None:
    """A zero-duration trace marker (mode 'trace' only) — e.g. a
    snapshot swap or a shed decision, things with a *moment* rather
    than a duration."""
    if _reg._MODE != "trace":
        return
    t = time.perf_counter()
    _append_event(name, t, t, args)


def trace_events() -> dict:
    """The trace ring as a Chrome Trace Event Format dict (Perfetto /
    chrome://tracing load it as-is).  Events are "X" (complete) phases;
    thread-name metadata rows label each tid."""
    pid = os.getpid()
    with _TRACE_LOCK:
        evs = list(_EVENTS) if _EVENTS is not None else []
        names = dict(_TID_NAMES)
    out = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": nm}} for tid, nm in sorted(names.items())]
    for name, tid, ts, dur, args in evs:
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": round(ts, 3), "dur": round(dur, 3), "cat": "lims"}
        if args:
            ev["args"] = dict(args)
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def trace_len() -> int:
    with _TRACE_LOCK:
        return len(_EVENTS) if _EVENTS is not None else 0


def clear_trace() -> None:
    global _EVENTS
    with _TRACE_LOCK:
        _EVENTS = None


__all__ = ["span", "instant", "trace_events", "trace_len", "clear_trace",
           "trace_cap"]
