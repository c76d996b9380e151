"""``python -m repro_torch.obs.report`` — export serving telemetry to
files.

Port of ``repro/obs/report.py``.  Renders the process-wide
observability state (metrics registry, recent ``QueryProfile`` records,
span trace, monitor series/findings) through the exporters:

    python -m repro_torch.obs.report --demo --health \\
        --json obs.json --prom obs.prom --trace obs.trace.json

``--demo`` builds a tiny index and serves range/kNN/frontend traffic
under ``REPRO_OBS=trace`` (``repro_torch.obs.demo``) on ``--device``
(default the card; ``cpu`` runs the kernels' plain versions) — a
one-command check that every exporter produces well-formed output.
``--health`` renders the index-health report (findings, series
sparklines, SLO attainment, daemon audit); combined with ``--demo`` it
first drives the deterministic closed-loop drift demo so there are
findings to show.  Without ``--demo`` the CLI exports whatever the
current process already recorded, which only makes sense when embedded
(``repro_torch.obs.report.main([...])`` from a serving script).  With
no output paths and no ``--health``, the JSON snapshot prints to
stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import export, registry
from .timeseries import sparkline


def render_health(monitor, daemon=None) -> str:
    """The health report as text: detector states, findings, daemon
    audit events, series sparklines, and SLO attainment."""
    snap = monitor.snapshot()
    lines = ["== LIMS index health =="]
    lines.append(
        f"monitor: ticks={snap['ticks']} series={len(snap['series'])} "
        f"findings={len(snap['findings'])} "
        f"sampler={'running' if snap['running'] else 'manual'}")

    lines.append("detectors:")
    for d in snap["detectors"]:
        state = "ACTIVE" if d["active"] else "idle"
        lines.append(f"  {d['name']:<22} {state:<6} "
                     f"trigger={d['trigger']:.3g} clear={d['clear']:.3g} "
                     f"persistence={d['persistence']}")

    lines.append("findings (newest last):")
    if not snap["findings"]:
        lines.append("  (none)")
    for f in snap["findings"][-12:]:
        lines.append(f"  [{f['severity']}] tick {f['tick']} "
                     f"{f['detector']}: {f['summary']}")

    if daemon is not None:
        ev = daemon.events()
        lines.append(f"daemon: cooldown={daemon.cooldown_ticks} ticks, "
                     f"{len(ev)} audit event(s)")
        for e in ev[-8:]:
            extra = ""
            if e["action"] == "rebalance":
                extra = f" (skew {e['skew']:.2f}x)"
            elif "cluster" in e:
                extra = f" (cluster {e['cluster']})"
            lines.append(f"  tick {e['tick']}: {e['action']}"
                         f"{extra} [{e['detector']}]")

    lines.append("series:")
    shown = 0
    for name in sorted(snap["series"]):
        st = snap["series"][name]
        if not st.get("n"):
            continue
        s = monitor.store.get(name)
        spark = sparkline(s.values()) if s is not None else ""
        lines.append(f"  {name:<36} {spark:<24} "
                     f"last={st['last']:.4g} mean={st['mean']:.4g}")
        shown += 1
    if not shown:
        lines.append("  (no samples yet)")

    ok = registry.REGISTRY.get("frontend.slo_ok")
    miss = registry.REGISTRY.get("frontend.slo_miss")
    n_ok = ok.value if ok is not None else 0
    n_miss = miss.value if miss is not None else 0
    if n_ok + n_miss:
        att = n_ok / (n_ok + n_miss)
        lines.append(f"slo: attained {att:.2%} "
                     f"({n_miss} miss / {n_ok + n_miss} requests)")
    else:
        lines.append("slo: no frontend requests recorded")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Export LIMS serving telemetry "
                    "(JSON / Prometheus / Chrome trace / health report).")
    ap.add_argument("--demo", action="store_true",
                    help="serve a small synthetic workload first "
                         "(trace mode) so there is telemetry to export; "
                         "with --health, also drive the closed-loop "
                         "drift demo")
    ap.add_argument("--health", action="store_true",
                    help="render the index-health report (findings, "
                         "series sparklines, SLO attainment) to stdout")
    ap.add_argument("--json", metavar="PATH",
                    help="write the JSON snapshot here")
    ap.add_argument("--prom", metavar="PATH",
                    help="write Prometheus text format here")
    ap.add_argument("--trace", metavar="PATH",
                    help="write the Chrome trace_event file here "
                         "(load in Perfetto / chrome://tracing)")
    ap.add_argument("--device", default=None,
                    help="where --demo builds and serves its engine "
                         "(default: the card; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--profiles", type=int, default=32, metavar="N",
                    help="recent QueryProfiles to include in the JSON "
                         "snapshot (default 32)")
    args = ap.parse_args(argv)

    monitor = daemon = None
    if args.demo:
        from . import demo as _demo
        st = _demo.run_traffic_demo(
            _demo.demo_state("trace", device=args.device))
        if args.health:
            _, monitor, daemon = _demo.run_health_demo(st)
    if monitor is None:
        from .monitor import active_monitors
        act = active_monitors()
        monitor = act[0] if act else None

    wrote = []
    if args.json:
        export.write_json_snapshot(args.json, n_profiles=args.profiles,
                                   monitor=monitor)
        wrote.append(f"json snapshot -> {args.json}")
    if args.prom:
        export.write_prometheus(args.prom, monitor=monitor)
        wrote.append(f"prometheus text -> {args.prom}")
    if args.trace:
        n = export.write_chrome_trace(args.trace)
        wrote.append(f"chrome trace ({n} events) -> {args.trace}")

    if args.health:
        if monitor is None:
            print("== LIMS index health ==\nno monitor active "
                  "(REPRO_MONITOR=off and none passed)")
        else:
            print(render_health(monitor, daemon))
    for line in wrote:
        print(line)
    if not wrote and not args.health:
        json.dump(export.json_snapshot(args.profiles), sys.stdout,
                  indent=2, sort_keys=True)
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
