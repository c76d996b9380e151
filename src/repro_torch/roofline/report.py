"""Render roofline reports.

Port of ``repro/roofline/report.py``.  Two modes:

* ``python -m repro_torch.roofline.report --pipeline [--quick]
  [--json PATH] [--device cpu|cuda]`` — measure the query pipeline's
  stages on this machine (``pipeline.py``) and print the per-stage
  utilization table.
* ``python -m repro_torch.roofline.report [DIR]`` — the dry-run tables
  from ``launch/dryrun.py``'s JSON records (default ``results/dryrun``).
  The collective columns of the reference's tables come from XLA's
  compiled HLO; the port's records list them as not measured.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def load(dirpath: str) -> list[dict]:
    out = []
    for f in sorted(os.listdir(dirpath)):
        if f.endswith(".json"):
            with open(os.path.join(dirpath, f)) as fh:
                out.append(json.load(fh))
    return out


def fmt_ms(s: float) -> str:
    return f"{s*1e3:,.1f}"


def roofline_table(recs: list[dict], mesh: str) -> str:
    rows = ["| arch | shape | params | live GB | fits 80 GB | t_comp ms | "
            "t_mem ms | dominant | MFU-bound |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if "skipped" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — "
                        f"| — | SKIP (full attn @500k) | — |")
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{r['params_total']/1e9:.1f}B | "
            f"{r['mem']['live_gb']:.1f} | "
            f"{'Y' if r['mem']['fits_80gb'] else 'N'} | "
            f"{fmt_ms(rf['t_compute_s'])} | {fmt_ms(rf['t_memory_s'])} | "
            f"{rf['bottleneck']} | {rf['mfu_bound']*100:.0f}% |")
    return "\n".join(rows)


def collective_summary(recs: list[dict]) -> str:
    """The reference's per-kind collective bytes: not measured in the
    port (no compiled HLO); one row per record says so."""
    rows = ["| arch | shape | mesh | collective bytes |",
            "|---|---|---|---|"]
    for r in recs:
        if "skipped" in r:
            continue
        missing = "collective_bytes" in r.get("not_measured", ())
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                    f"{'not measured (no XLA HLO)' if missing else '—'} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", nargs="?", default="results/dryrun")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="--pipeline's device (default: the card; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.pipeline:
        from .pipeline import pipeline_report, render
        try:
            rep = pipeline_report(quick=args.quick, device=args.device)
        except RuntimeError as e:       # no card, and none asked for
            print(f"report: {e}", file=sys.stderr)
            return 2
        print(render(rep))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rep, f, indent=1)
            print(f"# wrote {args.json}")
        return 0
    recs = load(args.dir)
    print("## Roofline — single pod (16×16 = 256 chips)\n")
    print(roofline_table(recs, "16x16"))
    print("\n## Roofline — multi-pod (2×16×16 = 512 chips)\n")
    print(roofline_table(recs, "2x16x16"))
    print("\n## Collective breakdown (per device per step)\n")
    print(collective_summary([r for r in recs
                              if r.get("mesh") == "2x16x16"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
