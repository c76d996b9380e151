"""Roofline analysis of the real query pipeline: pdist -> rankeval ->
range_filter, and the fused plan stage.

Port of ``repro/roofline/pipeline.py``.  For each kernel stage, at the
shapes the resident executor launches against a real snapshot:

1. count the stage's flops and bytes (``analysis.*_work``: every input
   read once, every output written once — the reference parses the
   compiled HLO for its flops; the port has hand-written kernels and no
   HLO);
2. time the stage: on a card CUDA events around a run of calls (best
   of ``reps`` runs; the wrappers as the executor calls them), on the
   CPU the plain versions by the host clock;
3. divide by the machine's ceiling (:func:`repro_torch.roofline.hw.
   machine_profile`: the data sheet on an H100 SXM, calibrated
   elsewhere): arithmetic intensity I = flops / bytes, attainable =
   min(peak, I · bandwidth), utilization = achieved / attainable (the
   bound's time over the measured time), bottleneck = compute or
   memory by which roof binds.

A utilization above 1 says the count is wrong (the kernel did less than
the count) or the working set sat in the cache; on the card
``chip_smoke.py`` fails above 1.05.  Entry point: ``python -m
repro_torch.roofline.report --pipeline``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import analysis, hw


def _stage_report(name: str, fn, work: tuple[float, float], machine: dict,
                  reps: int, device: torch.device) -> dict:
    io, flops = work
    t_us = hw.best_seconds(fn, reps, device, calls=10) * 1e6
    intensity = flops / io if io else float("inf")
    attainable = min(machine["peak_flops"], intensity * machine["mem_bw"])
    t_bound = max(io / machine["mem_bw"], flops / machine["peak_flops"])
    achieved = flops / (t_us * 1e-6) if t_us else 0.0
    util = t_bound / (t_us * 1e-6) if t_us else 0.0
    if intensity * machine["mem_bw"] >= machine["peak_flops"]:
        bound = "compute"
    elif util > 1.0:
        bound = "cache"
    else:
        bound = "memory"
    return {
        "stage": name,
        "flops": flops,
        "io_bytes": io,
        "intensity_flops_per_byte": round(intensity, 3),
        "time_us": round(t_us, 3),
        "bound_us": round(t_bound * 1e6, 3),
        "achieved_gflops": round(achieved / 1e9, 2),
        "attainable_gflops": round(attainable / 1e9, 2),
        "roofline_utilization": round(util, 4),
        "bound": bound,
    }


def pipeline_report(n: int = 12_000, d: int = 8, batch: int = 64,
                    quick: bool = False, reps: int = 5,
                    device=None, snapshot=None, queries=None) -> dict:
    """Per-stage roofline report over a real snapshot's query pipeline
    on ``device`` (default: the card; ``RuntimeError`` without one, as
    every entry point).  By default it builds a GaussMix index of ``n``
    rows and a batch of ``batch`` queries at the 1e-3 quantile; given a
    ``snapshot`` and ``queries`` = (Q (B, d), radii (B,)) it times the
    stages at their shapes (``n``, ``d``, ``batch`` unused) on the
    snapshot's device."""
    from ..kernels.dispatch import resolve_device
    if snapshot is not None:
        return _pipeline_report(snapshot, *queries, reps,
                                resolve_device(snapshot.rows.device))
    if quick:
        n, reps = min(n, 4_000), min(reps, 2)
    device = resolve_device(device)
    from ..core import LIMSIndex, MetricSpace
    from ..core.metrics import dist_one_to_many
    from ..core.snapshot import LIMSSnapshot
    from ..data.datasets import gauss_mix

    X = gauss_mix(n, d, seed=0)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=16, m=3, n_rings=20)
    snap = LIMSSnapshot.build(ix, device=device)
    rng = np.random.default_rng(1)
    qn = (X[rng.choice(n, batch)]
          + rng.normal(0, 0.003, (batch, d))).astype(np.float32)
    rn = np.asarray([np.quantile(dist_one_to_many(q, X, "l2"), 1e-3)
                     for q in qn], np.float32)
    return _pipeline_report(snap, qn, rn, reps, device)


def _pipeline_report(snap, qn, rn, reps: int, device: torch.device) -> dict:
    from ..core.planner import _R_ABS, _R_REL
    from ..kernels import ops

    batch, d = qn.shape
    qf = torch.as_tensor(np.asarray(qn, np.float32), device=device)
    rf = torch.as_tensor(np.asarray(rn, np.float32), device=device)
    r_g = rf * (1.0 + _R_REL) + _R_ABS

    G = snap.K * snap.m
    pivots = snap.pivots.reshape(G, d)
    rows = snap.rows.reshape(snap.n_slots, d)
    coef = snap.coef.reshape(G, -1)
    C = coef.shape[1]
    mlo = snap.model_lo.reshape(-1)
    mhi = snap.model_hi.reshape(-1)
    mn = snap.model_n.reshape(-1)
    P = snap.n_slots

    machine = hw.machine_profile(device)

    # the boundary matrix the staged plan feeds rankeval (G, 2B)
    dq = torch.sqrt(torch.clamp(ops.pdist(qf, pivots), min=0.0))
    xb = torch.cat([(dq - r_g[:, None]).T, (dq + r_g[:, None]).T], dim=1)
    # range_filter pads its points to whole 128-point tiles
    p_pad = -(-P // 128) * 128

    stages = [
        # refinement-shaped pdist: the batch against every resident slot
        ("pdist", lambda: ops.pdist(qf, rows),
         analysis.pdist_work(batch, P, d)),
        ("rankeval",
         lambda: ops.rankeval(xb, coef, mlo, mhi, mn, n_rings=snap.n_rings),
         analysis.rankeval_work(G, 2 * batch, C)),
        ("range_filter", lambda: ops.range_filter(qf, rows, rf),
         analysis.range_filter_work(batch, p_pad, d)),
        # the fused plan stage (pdist + rankeval in one launch)
        ("fused_plan",
         lambda: ops.pdist_rankeval(qf, pivots, coef, mlo, mhi, mn, r_g,
                                    n_rings=snap.n_rings),
         analysis.pdist_rankeval_work(batch, G, d, C)),
    ]
    out = {
        "machine": {k: (round(v, 3) if isinstance(v, float) else v)
                    for k, v in machine.items()},
        "device": str(device),
        "shapes": {"n": snap.live, "d": d, "batch": batch, "G": G,
                   "n_slots": P},
        "stages": [_stage_report(nm, fn, work, machine, reps, device)
                   for nm, fn, work in stages],
    }
    core = [s for s in out["stages"] if s["stage"] != "fused_plan"]
    tot_t = sum(s["time_us"] for s in core)
    out["pipeline"] = {
        "time_us": round(tot_t, 3),
        "flops": sum(s["flops"] for s in core),
        "io_bytes": sum(s["io_bytes"] for s in core),
        "utilization_weighted": round(
            sum(s["roofline_utilization"] * s["time_us"]
                for s in core) / tot_t, 4) if tot_t else 0.0,
    }
    return out


def render(report: dict) -> str:
    lines = [
        f"machine: {report['machine']['name']}  "
        f"peak {report['machine']['peak_flops'] / 1e9:.0f} GFLOP/s  "
        f"bw {report['machine']['mem_bw'] / 1e9:.1f} GB/s  "
        f"device={report['device']}",
        f"shapes: {report['shapes']}",
        "| stage | FLOPs | IO bytes | I (F/B) | t_us | bound_us | "
        "achieved GF/s | attainable GF/s | util | bound |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for s in report["stages"]:
        lines.append(
            f"| {s['stage']} | {s['flops']:.3g} | {s['io_bytes']:.3g} | "
            f"{s['intensity_flops_per_byte']} | {s['time_us']} | "
            f"{s['bound_us']} | {s['achieved_gflops']} | "
            f"{s['attainable_gflops']} | "
            f"{s['roofline_utilization'] * 100:.1f}% | {s['bound']} |")
    p = report["pipeline"]
    lines.append(
        f"pipeline (staged 3 kernels): {p['time_us']}us, "
        f"{p['flops']:.3g} FLOPs, {p['io_bytes']:.3g} IO bytes, "
        f"time-weighted utilization "
        f"{p['utilization_weighted'] * 100:.1f}%")
    return "\n".join(lines)


__all__ = ["pipeline_report", "render"]
