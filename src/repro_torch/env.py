"""Registry of the ``REPRO_*`` environment knobs the port reads.

Port of ``repro/env.py``, cut to the knobs the port reads: the
resident query path's, the observability layer's (``obs/``), the
monitor's and the serving engine's.  Consumers call :func:`get`
instead of ``os.environ.get`` so that a typo like ``REPRO_COMPACT=of``
fails loudly with the list of accepted values rather than silently
selecting a default.

Conventions (as in the reference):

* The empty string is always accepted and means "use the default".
* Values are matched case-insensitively after stripping whitespace.
* Free-form knobs (numbers) declare ``values=None`` and are returned raw.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    name: str
    values: tuple[str, ...] | None  # None -> free-form (a number)
    default: str
    help: str


_KNOBS = (
    Knob("REPRO_COMPACT",
         ("", "on", "off"), "on",
         "Compacted candidate gather on the resident range path: gather "
         "the certified candidate rows once into a dense power-of-two "
         "bucket and filter only those (on, default), or stream the "
         "full padded slot array through the kernels (off)."),
    Knob("REPRO_STORAGE",
         ("", "paged"), "",
         "Snapshot storage tier: resident (default) or paged (not ported: "
         "the serving engine raises NotImplementedError, ROADMAP A7)."),
    Knob("REPRO_OBS",
         ("", "off", "on", "trace"), "on",
         "Observability (repro_torch.obs): off (zero-cost disabled path), "
         "on (metrics registry + span latency histograms + "
         "QueryProfiles), trace (additionally record Chrome trace_event "
         "spans for Perfetto)."),
    Knob("REPRO_OBS_RESERVOIR", None, "1024",
         "Histogram reservoir capacity (samples kept per histogram; "
         "percentiles are exact up to this many observations)."),
    Knob("REPRO_OBS_TRACE_CAP", None, "20000",
         "Trace ring capacity: most recent span events kept in "
         "REPRO_OBS=trace mode."),
    Knob("REPRO_OBS_PROFILES", None, "256",
         "QueryProfile ring capacity: most recent per-batch serving "
         "profiles kept."),
    Knob("REPRO_MONITOR",
         ("", "off", "on"), "off",
         "Continuous health monitoring (repro_torch.obs.monitor): off "
         "(zero-thread, zero-allocation path), on (background sampler "
         "thread snapshotting registry metrics into time series, health "
         "detectors, and the closed-loop serving daemon)."),
    Knob("REPRO_MONITOR_INTERVAL", None, "0.5",
         "Monitor sampler tick interval in seconds (float)."),
    Knob("REPRO_MONITOR_SERIES_CAP", None, "512",
         "Time-series ring capacity: most recent samples kept per "
         "monitored series."),
    Knob("REPRO_MONITOR_FINDINGS", None, "256",
         "Health-finding ring capacity: most recent detector findings "
         "kept by a monitor."),
    Knob("REPRO_MONITOR_RETRAIN",
         ("", "off", "recommend", "auto"), "off",
         "Closed-loop reaction to rank-model drift findings: off "
         "(ignore), recommend (surface retrain recommendations on the "
         "ServingEngine), auto (additionally trigger retrain_cluster)."),
)

KNOBS: dict[str, Knob] = {k.name: k for k in _KNOBS}


def get(name: str) -> str:
    """Validated value of knob ``name`` ("" and unset -> its default).

    Raises ``KeyError`` for an undeclared knob (a programming error) and
    ``ValueError`` for a set-but-invalid value (a user error).
    """
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    if knob.values is None:
        return raw
    val = raw.strip().lower()
    if val not in knob.values:
        valid = ", ".join(repr(v) for v in knob.values if v) or "''"
        raise ValueError(
            f"{name}={raw!r} is not a valid setting ({knob.help} "
            f"Valid values: {valid}, or empty/unset for the default.)")
    return knob.default if val == "" else val
