#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's exact query path on one CUDA card.

    python3 chip_smoke.py [--n 1000000] [--batches 8]

Phases, each printing lines that start with its name:

1. device   the card's name, count and power limit (nvidia-smi);
2. build    nvcc builds the four kernels from src/repro_torch/kernels/csrc
            (one process each, in parallel), then again with -Xptxas -v
            for their register and shared-memory use;
3. main     GaussMix (n rows, d = 8, seed 0) -> host LIMSIndex(K=64, m=3,
            N=20, degree 8) -> LIMSSnapshot.build on the card ->
            range (0.01% selectivity) and kNN (k = 10) batches of 64
            queries, with REPRO_COMPACT on and off.  Every result must
            equal the host index's, ids and f64 distances; one batch of
            each kind is checked against an f64 brute-force scan.  The
            launch counters are zeroed just before the snapshot build
            and read after the last batch: each kernel must have run;
4. E        the certified rank-error bound covers the error of the
            card's pdist_rankeval at every data point;
5. kernels  each kernel against its plain PyTorch version at the main
            path's shapes, timed with CUDA events beside its plain
            version, its bound and (pdist only) torch.cdist(q, p)**2.

Before the last line it prints the kernels as one JSON object and the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.  Any
failed check raises, so the script exits nonzero and prints no result.
It also exits nonzero when no CUDA device is available or the port's
sources are missing beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (the data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # f32 outside the tensor cores

DEVICE = "cuda"
D = 8                           # GaussMix width every repro benchmark uses
B = 64                          # queries per batch
K_NN = 10
SELECTIVITY = 1e-4              # the paper's default 0.01%

# the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "pdist": "src/repro/kernels/pdist.py:55",
    "rankeval": "src/repro/kernels/rankeval.py:69",
    "range_filter": "src/repro/kernels/range_filter.py:35",
    "pdist_rankeval": "src/repro/kernels/fused.py:58",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA
    events around the whole run, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def rank_ops(n_coef: int) -> int:
    """f32 operations of one rank_math evaluation: normalize (6),
    Clenshaw (3 per coefficient past the first, +4), rank and ring id
    (10)."""
    return 6 + 3 * (n_coef - 1) + 4 + 10


# ------------------------------------------------------------------ phases
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} count={count} nvidia-smi='{smi}' "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    return name, count, smi


def phase_build():
    from repro_torch.kernels import _cuda
    t0 = time.perf_counter()
    built = _cuda.build(force=True)
    print(f"build: {len(built)} kernels with nvcc in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{b.name} {b.seconds:.2f} s' for b in built.values())})",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        verbose = _cuda.build(extra_flags=("-Xptxas", "-v"), build_dir=tmp)
    for b in verbose.values():
        use = re.findall(r"Used (\d+) registers.*?(?:, (\d+) bytes smem)?$",
                         b.log, re.M)
        regs, smem = use[-1] if use else ("?", "")
        print(f"build: {b.name} registers={regs} static_smem={smem or 0} B",
              flush=True)


def make_queries(X, rng, n_batches: int):
    """Batches of B data rows plus N(0, 0.003) noise, each with the
    radius at its SELECTIVITY quantile of true distances (f64, on the
    card: torch.quantile's linear interpolation, like np.quantile)."""
    Xd = torch.from_numpy(X).to(DEVICE)
    out = []
    for _ in range(n_batches):
        Q = X[rng.choice(len(X), B)] + rng.normal(0.0, 0.003, (B, D))
        r = np.empty(B)
        for i, q in enumerate(torch.from_numpy(Q).to(DEVICE)):
            dist = torch.sqrt(((Xd - q) ** 2).sum(dim=1))
            r[i] = float(torch.quantile(dist, SELECTIVITY))
        out.append((Q, r))
    return out


def same_range(got, want) -> bool:
    gi, gd = got
    wi, wd = want
    a, b = np.argsort(gi), np.argsort(wi)
    return np.array_equal(gi[a], wi[b]) and np.array_equal(gd[a], wd[b])


def phase_main(X, ix, batches, snap_cls, executor_cls):
    """The counted main path.  Returns the launch counts and the
    snapshot (reused by the later phases)."""
    from repro_torch.core.metrics import dist_one_to_many
    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    host_range = [[ix.range_query(q, r)[:2] for q, r in zip(Q, rs)]
                  for Q, rs in batches]
    t1 = time.perf_counter()
    host_knn = [[ix.knn_query(q, K_NN)[:2] for q in Q] for Q, _ in batches]
    t2 = time.perf_counter()
    nq = len(batches) * B
    print(f"main: host LIMSIndex range {nq / (t1 - t0):.2f} q/s, "
          f"kNN {nq / (t2 - t1):.2f} q/s (one CPU thread)", flush=True)

    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    snap = snap_cls.build(ix, device=DEVICE)
    sync()
    ex = executor_cls(snap)
    print(f"main: snapshot K={snap.K} n_max={snap.n_max} P={snap.n_slots} "
          f"G={snap.K * snap.m} C={snap.coef.shape[-1]} "
          f"device_bytes={snap.device_nbytes()} "
          f"build_s={time.perf_counter() - t0:.3f}", flush=True)
    for compact in ("on", "off"):
        os.environ["REPRO_COMPACT"] = compact
        t0 = time.perf_counter()
        for (Q, rs), want in zip(batches, host_range):
            got = ex.range_query_batch(Q, rs)
            for b in range(B):
                check(same_range(got[b], want[b]),
                      f"range result differs from the host index "
                      f"(compact={compact}, query {b})")
        t_range = time.perf_counter() - t0
        frac = ex.last_compact
        t0 = time.perf_counter()
        rounds, syncs = [], []
        for (Q, _), want in zip(batches, host_knn):
            ids, ds = ex.knn_query_batch(Q, K_NN)
            rounds.append(ex.last_knn["rounds"])
            syncs.append(ex.last_knn["host_syncs"])
            for b in range(B):
                check(np.array_equal(ds[b], want[b][1])
                      and np.array_equal(np.sort(ids[b]),
                                         np.sort(want[b][0])),
                      f"kNN result differs from the host index "
                      f"(compact={compact}, query {b})")
        t_knn = time.perf_counter() - t0
        print(f"main: REPRO_COMPACT={compact} range {nq / t_range:.2f} q/s "
              f"kNN {nq / t_knn:.2f} q/s (B={B}, k={K_NN}, wall clock incl. "
              f"host refinement); kNN rounds/batch={rounds} "
              f"host_syncs/batch={syncs}; last compact gather={frac}",
              flush=True)
    sync()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    print(f"main: launches {json.dumps(counts)} "
          f"max_memory_allocated={peak}", flush=True)
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was not launched on the main path")

    # one batch of each kind against an f64 brute-force scan
    Q, rs = batches[0]
    got_r = ex.range_query_batch(Q, rs)
    ids_k, ds_k = ex.knn_query_batch(Q, K_NN)
    for b in range(B):
        dist = dist_one_to_many(Q[b], X, "l2")
        hit = np.nonzero(dist <= rs[b])[0]
        check(same_range(got_r[b], (hit, dist[hit])),
              f"range query {b} differs from the brute-force scan")
        top = np.argsort(dist, kind="stable")[:K_NN]
        check(np.array_equal(ds_k[b], dist[top])
              and np.array_equal(np.sort(ids_k[b]), np.sort(top)),
              f"kNN query {b} differs from the brute-force scan")
    print(f"main: batch 0 equals the f64 brute-force scan "
          f"(range hits/query={np.mean([len(g[0]) for g in got_r]):.1f})",
          flush=True)
    return counts, snap


def phase_error_bound(ix, snap):
    """E against pdist_rankeval's rank error at every data point: each
    stored row against its own cluster's m pivots, rg = 0."""
    from repro_torch.kernels import ops
    worst = (0.0, 0, 0.0, 0, -1, -1)
    E = snap.rank_err.cpu().numpy()
    for ci in ix.clusters:
        if ci.n == 0:
            continue
        k = ci.cid
        q = torch.from_numpy(ci.store.rows.astype(np.float32)).to(DEVICE)
        _, rank, _ = ops.pdist_rankeval(
            q, snap.pivots[k], snap.coef[k], snap.model_lo[k],
            snap.model_hi[k], snap.model_n[k],
            torch.zeros(ci.n, device=DEVICE), n_rings=snap.n_rings)
        rank = rank.cpu().numpy()                            # (m, n_i)
        for j in range(snap.m):
            true = np.searchsorted(ci.mapping.d_sorted[j],
                                   ci.pivot_d_stored[:, j], side="left")
            err = np.abs(rank[j] - true).max()
            check(err <= E[k, j], f"rank error {err} exceeds E={E[k, j]} "
                  f"(cluster {k}, pivot {j})")
            ratio = err / max(E[k, j], 1.0)
            if ratio >= worst[0]:
                worst = (ratio, int(err), float(E[k, j]), ci.n, k, j)
    n_g = snap.model_n.cpu().numpy()
    print(f"E: covers pdist_rankeval's rank error at all {ix.space.n} "
          f"data points; worst observed/E = {worst[0]:.4f} (error "
          f"{worst[1]}, E {worst[2]}, n {worst[3]}, cluster {worst[4]}, "
          f"pivot {worst[5]}); groups with E = n: "
          f"{int((E >= n_g).sum())} of {E.size}", flush=True)


def phase_kernels(ix, snap, batches, counts):
    from repro_torch.core.planner import _BALL_ABS, _R_ABS, _R_REL
    from repro_torch.core.snapshot import rank_columns
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.fused import pdist_rankeval_plain
    from repro_torch.kernels.pdist import pdist_plain
    from repro_torch.kernels.range_filter import range_filter_plain
    from repro_torch.kernels.rankeval import rank_math_plain

    Q, rs = batches[0]
    q = torch.from_numpy(Q.astype(np.float32)).to(DEVICE)
    rf = torch.from_numpy(rs.astype(np.float32)).to(DEVICE)
    P, G, C = snap.n_slots, snap.K * snap.m, snap.coef.shape[-1]
    rows = snap.rows.reshape(P, D)
    piv = snap.pivots.reshape(G, D)
    coef = snap.coef.reshape(G, C)
    lo, hi, nn = (t.reshape(G) for t in
                  (snap.model_lo, snap.model_hi, snap.model_n))
    out = []

    def row(name, err, call, iters, plain, plain_iters, nbytes, flops,
            library=None):
        """Time ``call`` (the wrapper) and ``plain`` with CUDA events,
        and the kernel's own device time under the profiler."""
        ms = time_ms(call, iters)
        plain_ms = time_ms(plain, plain_iters)
        library_ms = time_ms(library, 10) if library else None
        kernel_ms = device_busy(call)[1]
        b_ms, by = bound(nbytes, flops)
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/"
                              f"{_cuda.SOURCES[name]}",
                    "replaces": REPLACES[name], "launches": counts[name],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": by,
                    "library_ms": library_ms})
        print(f"kernels: {name} max_abs_err={err} ms={ms:.4f} "
              f"profiler_device_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({by}) library_ms={library_ms}",
              flush=True)

    # pdist: the kNN distance matrix (B, P)
    got = ops.pdist(q, rows)
    want = pdist_plain(q, rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * D)
    err = float((got - want).abs().max())
    del got, want
    row("pdist", err, lambda: ops.pdist(q, rows), 20,
        lambda: pdist_plain(q, rows), 3,
        4.0 * (B * D + P * D + B * P),
        B * P * (2 * D + 4) + 2 * D * (B + P),
        library=lambda: torch.cdist(q, rows) ** 2)

    # rankeval: the snapshot's E certification (G, n_col)
    x = torch.from_numpy(rank_columns(ix)).to(DEVICE)
    rk, rid = ops.rankeval(x, coef, lo, hi, nn, snap.n_rings)
    rk_p, rid_p = rank_math_plain(x, coef, lo, hi, nn, snap.n_rings)
    check(torch.equal(rk, rk_p) and torch.equal(rid, rid_p),
          "rankeval differs from its plain version")
    nc = x.shape[1]
    row("rankeval", 0.0,
        lambda: ops.rankeval(x, coef, lo, hi, nn, snap.n_rings), 50,
        lambda: rank_math_plain(x, coef, lo, hi, nn, snap.n_rings), 5,
        4.0 * (G * nc + G * C + 3 * G) + 8.0 * G * nc,
        G * nc * rank_ops(C))

    # range_filter: the full ball prefilter (B, P) at the batch's
    # guard-widened radii
    r = rf * (1.0 + _R_REL) + _BALL_ABS
    r2 = r * r
    mask, cnt = ops.range_filter(q, rows, r)
    mask_p, _ = range_filter_plain(q, rows, r2)
    diff = mask != mask_p
    n_diff = int(diff.sum())
    if n_diff:
        d2 = pdist_plain(q, rows)
        near = (d2 - r2[:, None]).abs() <= 1e-5 * torch.clamp(r2, min=1.0)[
            :, None]
        check(bool(near[diff].all()),
              "range_filter mask differs away from the ball boundary")
        del d2, near
    tiles = torch.nn.functional.pad(mask, (0, (-P) % 128)).reshape(
        B, -1, 128).sum(-1, dtype=torch.int32)
    check(torch.equal(cnt, tiles), "range_filter counts differ from the "
          "sums of its own mask")
    print(f"kernels: range_filter mask cells differing from plain: {n_diff} "
          f"of {B * P}; hits={int(mask.sum())}", flush=True)
    del mask_p, diff
    row("range_filter", float(n_diff > 0),
        lambda: ops.range_filter(q, rows, r), 20,
        lambda: range_filter_plain(q, rows, r2), 3,
        4.0 * (B * D + P * D + B) + B * P + 4.0 * B * (-(-P // 128)),
        B * P * (2 * D + 5) + 2 * D * (B + P))

    # pdist_rankeval: the fused plan stage (B, G) against the staged
    # pdist -> sqrt -> rankeval chain and its plain version, bitwise
    rg = rf * (1.0 + _R_REL) + _R_ABS
    fused = ops.pdist_rankeval(q, piv, coef, lo, hi, nn, rg)
    dq = torch.sqrt(torch.clamp(ops.pdist(q, piv), min=0.0))
    xs = torch.cat([(dq - rg[:, None]).T, (dq + rg[:, None]).T], dim=1)
    rank, _ = ops.rankeval(xs, coef, lo, hi, nn)
    staged = (dq, rank[:, :B], rank[:, B:])
    plain = pdist_rankeval_plain(q, piv, coef, lo, hi, nn, rg, snap.n_rings)
    for f, s in zip(fused, staged):
        check(torch.equal(f, s), "fused and staged plans differ")
    print("kernels: pdist_rankeval equals the staged pdist -> sqrt -> "
          "rankeval chain bit for bit", flush=True)
    row("pdist_rankeval",
        max(float((f.double() - p.double()).abs().max())
            for f, p in zip(fused, plain)),
        lambda: ops.pdist_rankeval(q, piv, coef, lo, hi, nn, rg), 200,
        lambda: pdist_rankeval_plain(q, piv, coef, lo, hi, nn, rg,
                                     snap.n_rings), 20,
        4.0 * (B * D + G * D + G * C + 3 * G + B) + 4.0 * B * G
        + 8.0 * G * B,
        2 * D * (B + G) + B * G * (2 * D + 4 + 3 + 2 * rank_ops(C)))
    return out


def device_busy(fn) -> tuple[float, float, list]:
    """(wall ms, device ms, top device activities) of one call of
    ``fn`` under torch.profiler.  Only the device's own events count
    (kernels and copies); the CPU ops that launched them are skipped,
    or their device time would be counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [(e.key[:48], e.device_time_total / 1e3)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    evs = sorted((e for e in evs if e[1] > 0), key=lambda e: -e[1])
    return wall, sum(t for _, t in evs), evs[:6]


def phase_profile(ex, batches):
    """Where one batch's time goes: host-clock stages, each ended by a
    device synchronise, and the device's busy share under
    torch.profiler (run with --profile)."""
    from repro_torch.core.metrics import dist_one_to_many
    Q, rs = batches[-1]
    T = time.perf_counter

    def refine_range(hit, plan):
        for b in range(B):
            idx = np.nonzero(hit[b])[0]
            d = dist_one_to_many(Q[b], ex.snap.rows_np[idx], "l2")
            ex.snap.gids_np[idx][d <= plan.radii[b]]

    for compact in ("on", "off"):
        os.environ["REPRO_COMPACT"] = compact
        ex.range_query_batch(Q, rs)                     # warm
        st = {}
        t0 = T()
        plan = ex.planner.plan_range(Q, rs)
        plan.mask_dev
        sync()
        st["plan_device"] = T() - t0
        t0 = T()
        plan.mask
        st["mask_to_host"] = T() - t0
        if compact == "on":
            t0 = T()
            slots = plan.compact_slots()
            st["compact_slots_host"] = T() - t0
            rf = torch.from_numpy(plan.radii.astype(np.float32)).to(DEVICE)
            t0 = T()
            hit = ex.backend._range_hits_compact(plan, rf, slots)
            st["gather_filter_hits"] = T() - t0
        else:
            t0 = T()
            hit = ex.backend.range_hits(plan)
            st["filter_hits"] = T() - t0
        t0 = T()
        refine_range(hit, plan)
        st["refine_host"] = T() - t0
        wall, dev, top = device_busy(lambda: ex.range_query_batch(Q, rs))
        print(f"profile: range REPRO_COMPACT={compact} stages_ms="
              f"{json.dumps({k: round(v * 1e3, 3) for k, v in st.items()})}"
              f" batch_wall_ms={wall:.3f} device_ms={dev:.3f} "
              f"busy={dev / wall:.4f} top={json.dumps(top)}", flush=True)
    ex.knn_query_batch(Q, K_NN)                         # warm
    st = {}
    t0 = T()
    plan = ex.planner.plan_knn(Q, K_NN, 64)
    st["plan_knn_seed"] = T() - t0
    t0 = T()
    final, rounds = ex.backend.knn_candidates(plan)
    st["rounds_incl_distance_matrix"] = T() - t0
    t0 = T()
    ex._refine_topk(Q, final, K_NN)
    st["refine_host"] = T() - t0
    wall, dev, top = device_busy(lambda: ex.knn_query_batch(Q, K_NN))
    print(f"profile: knn rounds={rounds} candidates/query="
          f"{final.sum(axis=1).mean():.1f} stages_ms="
          f"{json.dumps({k: round(v * 1e3, 3) for k, v in st.items()})} "
          f"batch_wall_ms={wall:.3f} device_ms={dev:.3f} "
          f"busy={dev / wall:.4f} top={json.dumps(top)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="GaussMix rows (default 1,000,000)")
    ap.add_argument("--batches", type=int, default=8,
                    help="query batches of 64 per kind (default 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also print where one batch's time goes")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import LIMSIndex, MetricSpace, QueryExecutor
    from repro_torch.core.snapshot import LIMSSnapshot
    from repro_torch.data.datasets import gauss_mix

    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()

    t0 = time.perf_counter()
    X = gauss_mix(args.n, D, seed=0)
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=64, m=3, n_rings=20,
                   degree=8)
    sizes = [ci.n for ci in ix.clusters]
    print(f"main: GaussMix n={args.n} d={D}; host LIMSIndex K={ix.K} m=3 "
          f"N=20 degree=8 built in {time.perf_counter() - t0:.2f} s; "
          f"cluster rows max={max(sizes)} mean={np.mean(sizes):.1f}",
          flush=True)
    batches = make_queries(X, np.random.default_rng(1), args.batches)

    counts, snap = phase_main(X, ix, batches, LIMSSnapshot, QueryExecutor)
    phase_error_bound(ix, snap)
    kernels = phase_kernels(ix, snap, batches, counts)
    if args.profile:
        phase_profile(QueryExecutor(snap), batches)
    for k in kernels:
        check(all(v is not None for key, v in k.items()
                  if key != "library_ms"), f"incomplete row {k}")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
