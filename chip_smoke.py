#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's exact query path, index builder and
dense-LM serving path on one CUDA card.

    python3 chip_smoke.py [--n 1000000] [--batches 8] [--linf-n 200000]
                          [--seed 0]

Phases, each printing lines that start with its name:

1. device   the card's name, count and power limit (nvidia-smi);
2. build    nvcc builds the seven kernels from the six sources in
            src/repro_torch/kernels/csrc (one process each, in parallel),
            then again with -Xptxas -v for their register,
            shared-memory and spill use;
3. main     GaussMix (n rows, d = 8, seed 0) -> host LIMSIndex(K=64, m=3,
            N=20, degree 8) -> LIMSSnapshot.build on the card ->
            range (0.01% selectivity) and kNN (k = 10) batches of 64
            queries, with REPRO_COMPACT on and off.  Every result must
            equal the host index's, ids and f64 distances; one batch of
            each kind is checked against an f64 brute-force scan.  The
            launch counters are zeroed just before the snapshot build
            and read after the last batch: each kernel must have run;
4. E        the certified rank-error bound covers the error of the
            card's pdist_rankeval at every data point, and E certified
            by the rankeval kernel equals E certified by its plain
            version group for group;
5. kernels  each kernel against its plain PyTorch version at the main
            path's shapes, bit for bit (range_filter: mask and counts;
            rankeval and pdist_rankeval also with NaN, +-inf and 1e30
            distances and query coordinates, where a NaN ranks 0 in ring
            0), timed with CUDA events beside its plain version, its bound
            and (pdist only) torch.cdist(q, p)**2; pdist, range_filter and
            rankeval also print their issue floor (the fixed f32 operation
            order's instructions at the SMs' clock) as a note, and pdist a
            second line at the planner's (64, 192); rankeval and
            pdist_rankeval print bare launches (CUDA events), their SASS
            instruction count (cuobjdump), and pdist_rankeval its device
            time replayed from a CUDA graph beside the same at (1, 1) (the
            launch floor) and the host cost of each step of its wrapper;
6. builder  the device index builder (LIMSIndex(backend="device")) at
            the same n: (a) GaussMix L2, held against main's host index
            (structures, then every range and kNN batch through a
            snapshot of it); (b) Skewed L1 and (c) Skewed L-infinity,
            each against a host build of its own (structures, 64 range
            and 64 kNN queries, query 0 against an f64 brute-force
            scan); structure differences pass only at ties within one
            ulp of the host's f64 distances.  The launch counters are
            zeroed before each build: pdist_l1 and pdist_linf must have
            run exactly once in (b) and (c), pivot_columns' one grouped
            launch (each cluster's m pivots against its own n_max member
            slots); their kernel rows are timed at that shape (batched
            torch.cdist p=1 / p=inf as the library yardstick), with a
            printed line at the reference's chunked launch shape (48,
            16 n_max); (e) L1 and L-infinity at d = 256 on GaussMix, n =
            20,000, checked as (b) and (c) are (a width the first
            pdist_lp.cu could not launch); (d) retrain: the largest
            cluster of the (a) index and of main's host index loses 1%
            of its rows and gains as many; a device retrain of one and a
            host retrain of the other answer identically, and "auto"
            picks the device for it.  (c) runs at --linf-n rows (default
            200,000, a cut that keeps the whole script within twice the
            query path's time); --linf-n 1000000 runs it uncut.
7. lm       the dense LM at Llama-3-8B widths (configs/llama3_8b.py),
            random weights from --seed: (a) float32 at a cut depth of 4
            layers, batch 2, 64-token prompts: prefill of tokens[:, :-1]
            and a decode step of tokens[:, -1] give forward_seq's logits
            at -2 and -1, and the forward with the flash kernel gives the
            forward with the plain dense_attention, each within 4e-3 of
            the logits' max |value|; the plain path's own deviations and
            a control whose attention runs on bf16-rounded q, k, v are
            printed, and the control must miss the bar; (b) bfloat16 at
            full depth (32 layers): 4 requests of 2,000-token prompts,
            prefill and 32 greedy decode steps, with prefill and decode
            rates and peak memory.  The launch counters are zeroed just before the
            prefill: flash_attention must launch exactly once per layer,
            and its layer-0 and layer-31 outputs must equal the f64
            answer on the same q, k, v within one bf16 ulp (rtol = atol
            = 2**-7), and lie nearer it than the plain version wherever
            they part from the plain version by more than that; then the
            body each type and head width takes (bf16 at D 64 and 128:
            the tensor cores), the HGMMA count of the flash library's
            SASS, its kernel row at the prefill's padded shape (bound: 1.5
            bf16 passes at the tensor cores' rate), with
            scaled_dot_product_attention as the library yardstick, and an
            f32 kernel-vs-plain check at a small shape;
8. retrieval  the twin of examples/retrieval_serving.py steps 1-4: an
            encoder LM (4 layers, d 256, f32) embeds 5,000 32-token docs
            on the card (its attention through the flash kernel), a host
            LIMSIndex(K=100, m=3, N=20) indexes them, and BatchedLIMS on
            the card answers 16 kNN queries (k = 5), identical to the host
            index and to an f64 brute-force scan.  Counters are zeroed
            before the encoding: flash_attention and the query kernels
            must run.

Before the last line it prints the kernels as one JSON object and the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.  Any
failed check raises, so the script exits nonzero and prints no result.
It also exits nonzero when no CUDA device is available or the port's
sources are missing beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (the data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # f32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12     # bf16 on the tensor cores, dense
# flash_attention's bf16 body does Q K^T in one bf16 pass and P V in two
# (P split into bf16 hi + lo): 1.5 passes of the function's flops
FLASH_TC_PASSES = 1.5

DEVICE = "cuda"
PROFILER_WINDOWS = 5            # one-call profiler windows per kernel row
D = 8                           # GaussMix width every repro benchmark uses
B = 64                          # queries per batch
K_NN = 10
SELECTIVITY = 1e-4              # the paper's default 0.01%

K_CLUSTERS, M, RINGS, DEGREE = 64, 3, 20, 8   # bench_build.py:39
LINF_N = 200_000                # (c)'s cut n; --linf-n overrides it
# (e): L1 and L-infinity builds at a width the old pdist_lp.cu tile could
# not launch (d >= 202), on GaussMix, at an n that keeps (e) near 30 s
WIDE_D, WIDE_N = 256, 20_000
# kernels of the query path; pdist_l1 and pdist_linf run in the builder
MAIN_KERNELS = ("pdist", "rankeval", "range_filter", "pdist_rankeval")
# the Pallas kernel (or kernel body) each CUDA kernel replaces
REPLACES = {
    "pdist": "src/repro/kernels/pdist.py:55",
    "rankeval": "src/repro/kernels/rankeval.py:69",
    "range_filter": "src/repro/kernels/range_filter.py:35",
    "pdist_rankeval": "src/repro/kernels/fused.py:58",
    "pdist_l1": "src/repro/kernels/pdist.py:36",
    "pdist_linf": "src/repro/kernels/pdist.py:43",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
}

LM_ARCH = "llama3-8b"
# (a)'s cut depth, and its bar on max |diff| relative to the compared
# logits' max |value| (as tests/test_torch_models.py's _close_scaled):
# above what the plain dense_attention path reads against forward_seq,
# and below what the same forward reads with its attention rounded to
# bf16 (the control), which the script checks too (PERF.md, PR 13)
LM_F32_LAYERS = 4
LM_F32_REL = 4e-3
LM_REQUESTS, LM_PROMPT, LM_DECODE = 4, 2_000, 32
# examples/retrieval_serving.py:42-45
ENCODER = dict(name="encoder-20m", family="dense", n_layers=4, d_model=256,
               n_heads=4, n_kv_heads=4, d_ff=1024, vocab=8192, head_dim=64,
               attn_impl="dense", remat="none", dtype="float32")


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


def graph_ms(fn, n: int = 20, replays: int = 10) -> float:
    """Device ms a call of ``fn`` (bare kernel launches) with no host
    cost in the window: ``n`` calls captured in one CUDA graph, CUDA
    events around ``replays`` replays.  For kernels shorter than the
    host's launch path, which back-to-back launches measure instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls
    (time.perf_counter_ns, after one warm-up call), then a synchronise
    outside the window."""
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return t / calls / 1e3


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit where neither is NaN, NaN where the other is."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0, a),
                                               torch.where(nb, 0, b))


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def bound(nbytes: float, flops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """The least time in ms: bytes at the HBM rate against ``flops`` at
    ``flop_per_s``, the card's fastest rate for the operand types."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
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
    print(f"build: {len(built)} sources ({len(_cuda.SIGNATURES)} kernels) "
          f"with nvcc in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{b.name} {b.seconds:.2f} s' for b in built.values())})",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        verbose = _cuda.build(extra_flags=("-Xptxas", "-v"), build_dir=tmp)
    for b in verbose.values():
        use = re.findall(r"Used (\d+) registers.*?(?:, (\d+) bytes smem)?$",
                         b.log, re.M)
        regs = "/".join(u[0] for u in use) or "?"
        smem = "/".join(u[1] or "0" for u in use) or "0"
        spills = "/".join(re.findall(r"(\d+) bytes spill stores", b.log))
        print(f"build: {b.name} registers={regs} static_smem={smem} B "
              f"spill_stores={spills or '?'} B (per entry function)",
              flush=True)


def make_queries(X, rng, n_batches: int, metric: str = "l2"):
    """Batches of B data rows plus N(0, 0.003) noise, each with the
    radius at its SELECTIVITY quantile of true ``metric`` distances (f64,
    on the card: torch.quantile's linear interpolation, like
    np.quantile)."""
    Xd = torch.from_numpy(X).to(DEVICE)
    out = []
    for _ in range(n_batches):
        Q = X[rng.choice(len(X), B)] + rng.normal(0.0, 0.003,
                                                  (B, X.shape[1]))
        r = np.empty(B)
        for i, q in enumerate(torch.from_numpy(Q).to(DEVICE)):
            if metric == "l2":
                dist = torch.sqrt(((Xd - q) ** 2).sum(dim=1))
            elif metric == "l1":
                dist = (Xd - q).abs().sum(dim=1)
            else:
                dist = (Xd - q).abs().amax(dim=1)
            r[i] = float(torch.quantile(dist, SELECTIVITY))
        out.append((Q, r))
    return out


def same_range(got, want) -> bool:
    gi, gd = got
    wi, wd = want
    a, b = np.argsort(gi), np.argsort(wi)
    return np.array_equal(gi[a], wi[b]) and np.array_equal(gd[a], wd[b])


def same_knn(got, want) -> bool:
    """Equal f64 distances in order and equal id sets (ties may order
    ids differently)."""
    return (np.array_equal(got[1], want[1])
            and np.array_equal(np.sort(got[0]), np.sort(want[0])))


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

    # the (nq, np) of each pdist and range_filter launch of the counted run
    shapes = {"pdist": {}, "range_filter": {}}
    real_launch = _cuda.launch

    def spy(name, *args, **kw):
        real_launch(name, *args, **kw)
        if name in shapes:      # the C arguments after the pointers
            nq, npts = args[3:5] if name == "pdist" else args[5:7]
            shapes[name][nq, npts] = shapes[name].get((nq, npts), 0) + 1

    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    spying = mock.patch.object(_cuda, "launch", spy)
    spying.start()
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
    spying.stop()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    print(f"main: launches {json.dumps(counts)} "
          f"max_memory_allocated={peak}", flush=True)
    for name in MAIN_KERNELS:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")
    for name, by in shapes.items():
        check(sum(by.values()) == counts[name],
              f"{name}: the shape tally misses launches")
        print(f"main: {name} launches by (nq, np): "
              + ", ".join(f"{n} x {s}" for s, n in sorted(by.items())),
              flush=True)

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
    return counts, shapes, snap, host_range, host_knn


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
    # E certified again, by the kernel and by rank_math_plain in its
    # place on the same card: the same bound group for group
    from repro_torch.core import snapshot as snapshot_mod
    from repro_torch.kernels.rankeval import rank_math_plain
    e_kernel = snapshot_mod._certified_rank_table(ix, snap.coef.device)[4]
    with mock.patch.object(snapshot_mod.ops, "rankeval", rank_math_plain):
        e_plain = snapshot_mod._certified_rank_table(ix, snap.coef.device)[4]
    check(np.array_equal(e_kernel, e_plain)
          and np.array_equal(e_kernel.astype(np.float32).reshape(E.shape), E),
          "E certified by the rankeval kernel differs from E certified by "
          "its plain version, or from the snapshot's")
    n_g = snap.model_n.cpu().numpy()
    print(f"E: certified by the kernel and by its plain version: equal in "
          f"all {E.size} groups, and equal to the snapshot's", flush=True)
    print(f"E: covers pdist_rankeval's rank error at all {ix.space.n} "
          f"data points; worst observed/E = {worst[0]:.4f} (error "
          f"{worst[1]}, E {worst[2]}, n {worst[3]}, cluster {worst[4]}, "
          f"pivot {worst[5]}); groups with E = n: "
          f"{int((E >= n_g).sum())} of {E.size}", flush=True)


def phase_kernels(ix, snap, batches, counts, shapes):
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

    def row(name, *args, **kw):
        out.append(kernel_row(name, counts[name], *args, **kw))

    # pdist: the kNN distance matrix (B, P), bit for bit
    got = ops.pdist(q, rows)
    want = pdist_plain(q, rows)
    check(torch.equal(got, want), "pdist differs from its plain version")
    del got, want
    row("pdist", 0.0, lambda: ops.pdist(q, rows), 20,
        lambda: pdist_plain(q, rows), 3,
        4.0 * (B * D + P * D + B * P),
        B * P * (2 * D + 4) + 2 * D * (B + P),
        library=lambda: torch.cdist(q, rows) ** 2,
        note=f"main-path launches at this shape: "
             f"{shapes['pdist'].get((B, P), 0)} of {counts['pdist']}; "
             + issue_floor(B * P, 2 * D + 4))
    # and at the plan_knn seed's shape (B, G), where the launch is the
    # cost; a printed line only (the JSON row is the (B, P) one)
    got = ops.pdist(q, piv)
    check(torch.equal(got, pdist_plain(q, piv)),
          f"pdist differs from its plain version at ({B}, {G})")
    kernel_row("pdist", counts["pdist"], 0.0, lambda: ops.pdist(q, piv), 200,
               lambda: pdist_plain(q, piv), 20,
               4.0 * (B * D + G * D + B * G),
               B * G * (2 * D + 4) + 2 * D * (B + G),
               library=lambda: torch.cdist(q, piv) ** 2,
               shape=f"({B}, {G})",
               note=f"main-path launches at this shape: "
                    f"{shapes['pdist'].get((B, G), 0)} of {counts['pdist']}")

    # rankeval: the snapshot's E certification (G, n_col), and the same
    # columns with NaN, +-inf and far distances planted
    N = snap.n_rings
    x = torch.from_numpy(rank_columns(ix)).to(DEVICE)
    x_odd = plant_odd(x)
    for xs in (x, x_odd):
        rk, rid = ops.rankeval(xs, coef, lo, hi, nn, N)
        rk_p, rid_p = rank_math_plain(xs, coef, lo, hi, nn, N)
        check(torch.equal(rk, rk_p) and torch.equal(rid, rid_p),
              "rankeval differs from its plain version")
    nan = torch.isnan(x_odd)
    check(bool((rk[nan] == 0).all() and (rid[nan] == 0).all()),
          "rankeval: a NaN distance does not rank 0 in ring 0")
    print(f"kernels: rankeval equals its plain version bit for bit at "
          f"{tuple(x.shape)}, and with {ODD_CELLS} NaN, +-inf and +-1e30 "
          f"distances planted ({int(nan.sum())} NaN: rank 0, ring 0)",
          flush=True)
    nc = x.shape[1]
    outs = torch.empty(2, G, nc, dtype=torch.int32, device=DEVICE)
    ptrs = [t.data_ptr() for t in (x, coef, lo, hi, nn, outs[0], outs[1])]
    row("rankeval", 0.0,
        lambda: ops.rankeval(x, coef, lo, hi, nn, N), 50,
        lambda: rank_math_plain(x, coef, lo, hi, nn, N), 5,
        4.0 * (G * nc + G * C + 3 * G) + 8.0 * G * nc,
        G * nc * rank_ops(C),
        bare=lambda: _cuda.launch("rankeval", *ptrs, G, nc, C, N,
                                  device=x.device),
        note=issue_floor(G * nc, rank_ops(C)) + "; "
        + sass_instructions("rankeval", f"rankeval_kernelILi{C}E")
        + " over the 8 values a thread")

    # range_filter: the full ball prefilter (B, P) at the batch's
    # guard-widened radii
    r = rf * (1.0 + _R_REL) + _BALL_ABS
    r2 = r * r
    mask, cnt = ops.range_filter(q, rows, r)
    mask_p, cnt_p = range_filter_plain(q, rows, r2)
    n_diff = int((mask != mask_p).sum())
    print(f"kernels: range_filter mask cells differing from plain: {n_diff} "
          f"of {B * P}; count tiles differing: "
          f"{int((cnt != cnt_p).sum())}; hits={int(mask.sum())}", flush=True)
    check(n_diff == 0 and torch.equal(cnt, cnt_p),
          "range_filter mask or counts differ from its plain version")
    del mask, cnt, mask_p, cnt_p
    row("range_filter", 0.0,
        lambda: ops.range_filter(q, rows, r), 20,
        lambda: range_filter_plain(q, rows, r2), 3,
        4.0 * (B * D + P * D + B) + B * P + 4.0 * B * (-(-P // 128)),
        B * P * (2 * D + 5) + 2 * D * (B + P),
        note=f"main-path launches at this shape: "
             f"{shapes['range_filter'].get((B, P), 0)} of "
             f"{counts['range_filter']} (the others on compacted buckets); "
             + issue_floor(B * P, 2 * D + 6))

    # pdist_rankeval: the fused plan stage (B, G) against the staged
    # pdist -> sqrt -> rankeval chain and its plain version, bitwise
    rg = rf * (1.0 + _R_REL) + _R_ABS

    def staged(qs, rgs):
        dq = torch.sqrt(torch.clamp(ops.pdist(qs, piv), min=0.0))
        xs = torch.cat([(dq - rgs[:, None]).T, (dq + rgs[:, None]).T], dim=1)
        rank, _ = ops.rankeval(xs, coef, lo, hi, nn, N)
        return dq, rank[:, :B], rank[:, B:]

    # and with a NaN coordinate (NaN dq), an infinite one, 1e30
    # coordinates and an infinite radius
    q_odd, rg_odd = q.clone(), rg.clone()
    q_odd[0, 3], q_odd[1], q_odd[2, 5] = float("nan"), 1e30, float("inf")
    rg_odd[3] = float("inf")
    errs = []
    for qs, rgs in ((q, rg), (q_odd, rg_odd)):
        fused = ops.pdist_rankeval(qs, piv, coef, lo, hi, nn, rgs, N)
        plain = pdist_rankeval_plain(qs, piv, coef, lo, hi, nn, rgs, N)
        for f, s, p in zip(fused, staged(qs, rgs), plain):
            check(same_bits(f, s), "fused and staged plans differ")
            check(same_bits(f, p), "pdist_rankeval differs from its plain "
                  "version")
        errs.append(max(float((f.double() - p.double()).nan_to_num(0.0)
                              .abs().max()) for f, p in zip(fused, plain)))
    check(bool(torch.isnan(fused[0][0]).all() and (fused[1][:, 0] == 0).all()
               and (fused[2][:, 0] == 0).all()),
          "pdist_rankeval: a NaN dq does not rank 0")
    print("kernels: pdist_rankeval equals the staged pdist -> sqrt -> "
          "rankeval chain and its plain version bit for bit, also with a "
          "NaN, an infinite and 1e30 query coordinates and an infinite "
          "radius (NaN dq: rank 0)", flush=True)
    outs = torch.empty(3, G, B, dtype=torch.int32, device=DEVICE)
    one = torch.empty(3, 1, 1, dtype=torch.int32, device=DEVICE)

    def bare_at(b, g, out):
        ptrs = [t.data_ptr() for t in (q, piv, coef, lo, hi, nn, rg, *out)]
        return lambda: _cuda.launch("pdist_rankeval", *ptrs, b, g, D, C, N,
                                    device=q.device)

    bare, floor = bare_at(B, G, outs), bare_at(1, 1, one)
    at = [time_ms(bare, 200), graph_ms(bare)]
    fl = [time_ms(floor, 200), graph_ms(floor)]
    print(f"kernels: pdist_rankeval bare launch at ({B}, {G}) against "
          f"(1, 1): CUDA events around 200 back-to-back launches "
          f"launch_ms={at[0]:.5f} launch_floor_ms={fl[0]:.5f} "
          f"({at[0] / fl[0]:.3f}x); replayed from a CUDA graph of 20 "
          f"graph_ms={at[1]:.5f} graph_floor_ms={fl[1]:.5f} "
          f"({at[1] / fl[1]:.3f}x)", flush=True)
    wrapper_breakdown((q, piv, coef, lo, hi, nn, rg), N)
    row("pdist_rankeval", errs[0],
        lambda: ops.pdist_rankeval(q, piv, coef, lo, hi, nn, rg, N), 200,
        lambda: pdist_rankeval_plain(q, piv, coef, lo, hi, nn, rg, N), 20,
        4.0 * (B * D + G * D + G * C + 3 * G + B) + 4.0 * B * G
        + 8.0 * G * B,
        2 * D * (B + G) + B * G * (2 * D + 4 + 3 + 2 * rank_ops(C)),
        bare=bare, graph=True,
        note=f"launch_floor_ms={fl[0]:.5f} graph_floor_ms={fl[1]:.5f}; "
        + sass_instructions("pdist_rankeval",
                            f"pdist_rankeval_kernelILi{C}E"))
    return out


# the NaN, +-inf and far distances planted among the rank columns
ODD_VALUES = (float("nan"), float("inf"), float("-inf"), 1e30, -1e30)
ODD_CELLS = 64


def plant_odd(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """A copy of ``x`` with ODD_CELLS cells, at seeded places, set to
    ODD_VALUES in turn."""
    out = x.clone()
    g = torch.Generator().manual_seed(seed)
    cells = torch.randperm(out.numel(), generator=g)[:ODD_CELLS]
    vals = torch.tensor(ODD_VALUES).repeat(ODD_CELLS // len(ODD_VALUES) + 1)
    out.view(-1)[cells.to(out.device)] = vals[:ODD_CELLS].to(out.device)
    return out


def wrapper_breakdown(args, n_rings: int) -> None:
    """Host microseconds of each step of ``ops.pdist_rankeval``'s call
    at the plan's shape (1,000 calls each), beside the parent tree's way
    of doing the same step, and the whole wrapper."""
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.pdist import check_operands
    q, piv, coef = args[:3]
    B, G = q.shape[0], piv.shape[0]
    dev = q.device
    index = torch.cuda.current_device()
    fn = _cuda._FUNCS["pdist_rankeval", None]
    outs = torch.empty(3, G, B, dtype=torch.int32, device=dev)
    cargs = ([t.data_ptr() for t in (*args, *outs)]
             + [B, G, q.shape[1], coef.shape[1], n_rings])
    stream = _cuda.current_stream(index)

    def outputs_one():
        dq, lo_, hi_ = torch.empty(3, G, B, dtype=torch.int32,
                                   device=dev).unbind(0)
        return dq.view(torch.float32).view(B, G), lo_, hi_

    def stream_parent():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    steps = {
        "7 x .to(f32).contiguous() (parent)":
            lambda: [t.to(torch.float32).contiguous() for t in args],
        "7 x _f32 (now)": lambda: [ops._f32(t) for t in args],
        "check_operands(7)": lambda: check_operands(*args),
        "3 x torch.empty (parent, now)": lambda: (
            torch.empty(B, G, device=dev),
            torch.empty(G, B, dtype=torch.int32, device=dev),
            torch.empty(G, B, dtype=torch.int32, device=dev)),
        "1 x torch.empty + unbind + views (not taken)": outputs_one,
        "device switch + current_stream (parent)": stream_parent,
        "current_device + raw stream (now)": lambda: (
            torch.cuda.current_device(), _cuda.current_stream(index)),
        "ctypes entry point (the launch itself)":
            lambda: fn(*cargs, stream),
        "_cuda.launch": lambda: _cuda.launch("pdist_rankeval", *cargs,
                                             device=dev),
        "whole ops.pdist_rankeval": lambda: ops.pdist_rankeval(
            *args, n_rings=n_rings),
    }
    print("kernels: pdist_rankeval wrapper breakdown (host us a call, "
          "1,000 calls each, perf_counter_ns): "
          + "; ".join(f"{k} {host_us(f):.3f}" for k, f in steps.items()),
          flush=True)


def issue_floor(cells: int, instr_per_cell: int) -> str:
    """A note for the kernels: lines: the time the card needs to issue
    ``instr_per_cell`` f32 instructions for each of ``cells`` outputs (the
    fixed no-FMA operation order of gram.cuh), at 128 lanes per SM and the
    SMs' maximum clock from nvidia-smi.  Beside the bound, not in it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = cells * instr_per_cell / (sms * 128 * mhz * 1e6) * 1e3
    return (f"issue_floor_ms={ms:.4f} ({instr_per_cell} f32 instructions "
            f"a cell, {sms} SMs x 128 lanes at {mhz:.0f} MHz)")


def kernel_row(name, launches, err, call, iters, plain, plain_iters, nbytes,
               flops, library=None, flop_per_s=F32_FLOP_PER_S, note="",
               shape="", bare=None, graph=False) -> dict:
    """Time ``call`` (the wrapper) and ``plain`` with CUDA events, and
    the kernel's own device time under the profiler: the median over
    the windows of PROFILER_WINDOWS single calls that hold device
    records (torch.profiler drops a one-call window's device records
    at random; the row says how many held them).  ``bare`` (a bare
    ``_cuda.launch`` into a preallocated output) is timed with CUDA
    events too, and with ``graph`` also replayed from a CUDA graph
    (graph_ms).  Print the row (with ``note``, and ``shape`` where it is
    not the row's main-path shape) and return it for the JSON line."""
    from repro_torch.kernels import _cuda
    ms = time_ms(call, iters)
    plain_ms = time_ms(plain, plain_iters)
    library_ms = time_ms(library, 10) if library else None
    windows = [device_busy(call)[1] for _ in range(PROFILER_WINDOWS)]
    held = [w for w in windows if w > 0.0]
    kernel_ms = f"{np.median(held):.4f}" if held else "none"
    launch_ms = f" launch_ms={time_ms(bare, iters):.4f}" if bare else ""
    if graph:
        launch_ms += f" graph_ms={graph_ms(bare):.5f}"
    b_ms, by = bound(nbytes, flops, flop_per_s)
    print(f"kernels: {name}{' at ' + shape if shape else ''} "
          f"max_abs_err={err} ms={ms:.4f}{launch_ms} "
          f"profiler_device_ms={kernel_ms} ({len(held)} of "
          f"{PROFILER_WINDOWS} windows held device records) "
          f"plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({by}) library_ms={library_ms}"
          f"{' ' + note if note else ''}", flush=True)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{_cuda.SOURCES[name]}",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms}


def device_busy(fn, n_top: int = 6) -> tuple[float, float, list]:
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
    return wall, sum(t for _, t in evs), evs[:n_top]


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


# ----------------------------------------------------------------- builder
def lims_index(X, metric, **kw):
    from repro_torch.core import LIMSIndex, MetricSpace
    return LIMSIndex(MetricSpace(X, metric), n_clusters=K_CLUSTERS, m=M,
                     n_rings=RINGS, degree=DEGREE, **kw)


def compare_structures(tag, X, metric, host, dev) -> None:
    """Centers, assignment and pivot ids of the device build against
    the host build's.  A difference passes only at a tie: the host's f64
    distances of the two candidates within one ulp (the reference's own
    allowance, repro/build/cluster.py:12-14).  The first differing
    center or assignment makes everything after it incomparable, so the
    comparison stops there."""
    from repro_torch.core.metrics import dist_one_to_many
    hc, dc = host.clustering, dev.clustering
    ties = []

    def tie(a, b, what):
        check(abs(a - b) <= np.spacing(max(abs(a), abs(b))),
              f"builder: {tag} {what} differs from the host build and is "
              f"no tie ({a!r} vs {b!r})")
        ties.append(f"{what}: {a!r} vs {b!r}")

    n_c = int((hc.center_idx != dc.center_idx).sum())
    n_a = int((hc.assign != dc.assign).sum())
    n_p = sum(int((h.pivot_idx != d.pivot_idx).sum())
              for h, d in zip(host.clusters, dev.clusters))
    if n_c:
        c = int(np.nonzero(hc.center_idx != dc.center_idx)[0][0])
        d_near = np.min([dist_one_to_many(X[g], X, metric)
                         for g in hc.center_idx[:c]], axis=0)
        tie(d_near[hc.center_idx[c]], d_near[dc.center_idx[c]],
            f"center {c}")
    elif n_a:
        for i in np.nonzero(hc.assign != dc.assign)[0]:
            both = hc.center_idx[[hc.assign[i], dc.assign[i]]]
            d = dist_one_to_many(X[i], X[both], metric)
            tie(d[0], d[1], f"assignment of row {i}")
    else:
        for h, d in zip(host.clusters, dev.clusters):
            bad = np.nonzero(h.pivot_idx != d.pivot_idx)[0]
            if len(bad):
                j = int(bad[0])
                d_near = h.pivot_d_stored[:, :j].min(axis=1)
                at = [int(np.nonzero(h.store_ids == g)[0][0])
                      for g in (h.pivot_idx[j], d.pivot_idx[j])]
                tie(d_near[at[0]], d_near[at[1]],
                    f"cluster {h.cid} pivot {j}")
    print(f"builder: {tag} structure differences from the host build: "
          f"centers={n_c} assignment={n_a} pivot_ids={n_p}; ties "
          f"(host f64 distances of the two candidates): {ties}",
          flush=True)


def print_build(tag, dev, t_dev, t_host, counts) -> None:
    t = {k: round(v, 4) for k, v in dev.device_build_timings.items()}
    print(f"builder: {tag} device build stages_s={json.dumps(t)} "
          f"LIMSIndex(backend='device') total_s={t_dev:.3f} (stages + host "
          f"f64 materialization); host build total_s={t_host:.3f}; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}; "
          f"launches {json.dumps(counts)}", flush=True)


def phase_builder_l2(X, ix, t_host, batches, host_range, host_knn):
    """(a): device build of main's GaussMix L2 index, its structures
    against main's host index, and every main batch through a snapshot
    of it on the card."""
    from repro_torch.core import LIMSSnapshot, QueryExecutor
    from repro_torch.kernels import _cuda
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    ixd = lims_index(X, "l2", backend="device")
    t_dev = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    check(counts["pdist"] > 0, "builder: l2 build launched no pdist")
    print_build("l2 GaussMix", ixd, t_dev, t_host, counts)
    compare_structures("l2", X, "l2", ix, ixd)
    ex = QueryExecutor(LIMSSnapshot.build(ixd, device=DEVICE))
    for (Q, rs), want_r, want_k in zip(batches, host_range, host_knn):
        for b, got in enumerate(ex.range_query_batch(Q, rs)):
            check(same_range(got, want_r[b]), f"builder: l2 range query {b} "
                  f"of the device-built snapshot differs from the host index")
        ids, ds = ex.knn_query_batch(Q, K_NN)
        for b in range(B):
            check(same_knn((ids[b], ds[b]), want_k[b]), f"builder: l2 kNN "
                  f"query {b} of the device-built snapshot differs")
    print(f"builder: l2 snapshot of the device-built index: all "
          f"{len(batches)} range and kNN batches equal the host index",
          flush=True)
    return ixd


def phase_builder_lp(metric, n, data="skewed", d=D, rows=True):
    """(b), (c) or (e): ``data`` (Skewed, the paper's L1 data set, or
    GaussMix) at width ``d`` with ``metric``: a host and a device build,
    their structures, 64 range and 64 kNN queries through both, query 0
    against brute force; the kernel launched once in the build; then
    the kernel against its plain version at pivot_columns' grouped
    launch shape and, with ``rows``, its row there (returned) and a
    printed line at the reference's chunked launch shape."""
    from repro_torch.build import cluster_major
    from repro_torch.core.metrics import dist_one_to_many
    from repro_torch.data.datasets import gauss_mix, skewed
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.pdist import METRICS
    name, plain = METRICS[metric]
    X = (skewed if data == "skewed" else gauss_mix)(n, d, seed=0)
    tag = f"{metric} {'Skewed' if data == 'skewed' else 'GaussMix'} n={n}" \
          + ("" if d == D else f" d={d}")
    t0 = time.perf_counter()
    host = lims_index(X, metric)
    t_host = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    dev = lims_index(X, metric, backend="device")
    t_dev = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    check(counts[name] == 1, f"builder: the {tag} build launched {name} "
          f"{counts[name]} times, not once")
    print_build(tag, dev, t_dev, t_host, counts)
    compare_structures(tag, X, metric, host, dev)

    (Q, rs), = make_queries(X, np.random.default_rng(2), 1, metric)
    t_q = {"host": 0.0, "device": 0.0}
    for b, (q, r) in enumerate(zip(Q, rs)):
        t0 = time.perf_counter()
        want_r, want_k = host.range_query(q, r)[:2], host.knn_query(q, K_NN)[:2]
        t1 = time.perf_counter()
        got_r, got_k = dev.range_query(q, r)[:2], dev.knn_query(q, K_NN)[:2]
        t_q["host"] += t1 - t0
        t_q["device"] += time.perf_counter() - t1
        check(same_range(got_r, want_r) and same_knn(got_k, want_k),
              f"builder: {tag} query {b}: the device-built index differs "
              f"from the host build")
        if b == 0:
            dist = dist_one_to_many(q, X, metric)
            hit = np.nonzero(dist <= r)[0]
            top = np.argsort(dist, kind="stable")[:K_NN]
            check(same_range(got_r, (hit, dist[hit]))
                  and same_knn(got_k, (top, dist[top])),
                  f"builder: {tag} query 0 differs from brute force")
    print(f"builder: {tag} {B} range (selectivity {SELECTIVITY}) and {B} "
          f"kNN (k={K_NN}) queries identical between the device- and "
          f"host-built index; query 0 equals the f64 brute-force scan; "
          f"host query path s={json.dumps(t_q)}", flush=True)

    # the kernel at the shape pivot_columns launches it with: every
    # cluster's m pivots against its own n_max member slots
    member_idx, _, _, n_max = cluster_major(dev.clustering.members)
    K = dev.K
    Xf = torch.from_numpy(X.astype(np.float32)).to(DEVICE)
    p = Xf[torch.from_numpy(member_idx).to(DEVICE)]
    q = Xf[torch.from_numpy(
        np.stack([ci.pivot_idx for ci in dev.clusters])).to(DEVICE)]
    del Xf, host, dev
    m = q.shape[1]
    got = ops.pdist_grouped(q, p, metric)
    want = plain(q, p)
    check(torch.equal(got, want), f"{name} differs from its plain version "
          f"at pivot_columns' shape ({K}, {m}, {n_max}, d {d})")
    err = float((got - want).abs().max())
    del got, want
    print(f"kernels: {name} at pivot_columns' grouped launch ({K}, {m}, "
          f"{n_max}, d {d}) equals its plain version bit for bit", flush=True)
    if not rows:
        return None
    p_norm = 1.0 if metric == "l1" else float("inf")
    out = torch.empty(K, m, n_max, device=DEVICE)
    row = kernel_row(
        name, counts[name], err, lambda: ops.pdist_grouped(q, p, metric), 20,
        lambda: plain(q, p), 3,
        4.0 * (K * m * d + K * n_max * d + K * m * n_max),
        3.0 * d * K * m * n_max,
        library=lambda: torch.cdist(q, p, p=p_norm),
        shape=f"pivot_columns' grouped launch ({K}, {m}, {n_max}, d {d})",
        bare=lambda: _cuda.launch(name, q.data_ptr(), p.data_ptr(),
                                  out.data_ptr(), K, m, n_max, d,
                                  device=q.device))

    # and at the reference's launch shape, the chunked (cc·m, cc·n_max)
    # pdist_pallas call (G = 1): a printed line only
    cc = min(16, K)
    q1 = q[:cc].reshape(cc * m, d)
    p1 = p[:cc].reshape(cc * n_max, d)
    del q, p, out
    got = ops.pdist(q1, p1, metric)
    check(torch.equal(got, plain(q1, p1)), f"{name} differs from its plain "
          f"version at ({cc * m}, {cc * n_max}, d {d})")
    del got
    nq, npts = q1.shape[0], p1.shape[0]
    out = torch.empty(nq, npts, device=DEVICE)
    kernel_row(
        name, counts[name], 0.0, lambda: ops.pdist(q1, p1, metric), 20,
        lambda: plain(q1, p1), 3, 4.0 * (nq * d + npts * d + nq * npts),
        3.0 * d * nq * npts,
        library=lambda: torch.cdist(q1, p1, p=p_norm),
        shape=f"the full function's ({nq}, {npts}, d {d}) (cc={cc}, "
              f"n_max={n_max})",
        note="(the reference's chunked launch; not on the path now)",
        bare=lambda: _cuda.launch(name, q1.data_ptr(), p1.data_ptr(),
                                  out.data_ptr(), 1, nq, npts, d,
                                  device=q1.device))
    return row


def phase_retrain(X, ix, ixd, batches):
    """(d): the largest cluster of the device-built index ``ixd`` and of
    the host-built ``ix`` loses 1% of its rows and gains as many new
    ones; a device retrain of one and a host retrain of the other must
    answer identically, and "auto" must pick the device."""
    from repro_torch.core.index import RETRAIN_AUTO_ROWS
    c = int(np.argmax([ci.n for ci in ixd.clusters]))
    rng = np.random.default_rng(3)
    stored = ixd.clusters[c].store_ids
    gone = rng.choice(stored, size=len(stored) // 100, replace=False)
    new = X[rng.choice(stored, size=len(gone))] + rng.normal(
        0.0, 0.003, (len(gone), D))
    for index in (ixd, ix):
        for g in gone:
            check(index.delete(X[g]) == 1, f"builder: delete of row {g}")
        for row in new:
            index.insert(row)
    rows = ixd.clusters[c].n - len(gone) + len(ixd.clusters[c].buf_ids)
    times = {}
    for index, backend in ((ixd, "device"), (ix, "host"), (ixd, "auto")):
        sync()
        t0 = time.perf_counter()
        index.retrain_cluster(c, backend=backend)
        sync()
        times[backend] = time.perf_counter() - t0
    check(ixd.last_retrain_backend == "device",
          f"builder: auto picked {ixd.last_retrain_backend} for {rows} rows")
    Q, rs = batches[0]
    for b, (q, r) in enumerate(zip(Q, rs)):
        check(same_range(ixd.range_query(q, r)[:2], ix.range_query(q, r)[:2])
              and same_knn(ixd.knn_query(q, K_NN)[:2],
                           ix.knn_query(q, K_NN)[:2]),
              f"builder: query {b} differs after the device and host "
              f"retrains")
    print(f"builder: retrain cluster {c} ({rows} rows after -{len(gone)} "
          f"+{len(new)}): device_s={times['device']:.4f} "
          f"host_s={times['host']:.4f} auto_s={times['auto']:.4f} (auto "
          f"picked {ixd.last_retrain_backend}; RETRAIN_AUTO_ROWS="
          f"{RETRAIN_AUTO_ROWS}); batch 0's {B} range and {B} kNN queries "
          f"identical after both", flush=True)


# ---------------------------------------------------------------------- lm
def lm_model(cfg, seed: int):
    """The port's own random parameters for ``cfg`` on the card."""
    from repro_torch.models import zoo
    from repro_torch.models.params import init_params
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return init_params(zoo.model_specs(cfg), g, cfg.dtype, device=DEVICE)


def lm_tokens(shape, vocab: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, vocab, size=shape).astype(np.int32)).to(DEVICE)


def assert_close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    except AssertionError as e:
        fail(f"{what}: {e}")
    return err


def exact_attention(q, k, v, kv_len=None):
    """Causal GQA attention of (B, H, S, D) tensors in f64 with the
    kernel's mask (top-left origin, keys at or beyond ``kv_len``
    masked): the arbiter where a kernel and its plain version part."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    pos = torch.arange(sk, device=q.device)
    ok = ((torch.arange(sq, device=q.device)[:, None] >= pos[None, :])
          & (pos < (sk if kv_len is None else kv_len))[None, :])
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for bi in range(b):
        for h in range(hk):
            s = torch.einsum("gqd,kd->gqk", q[bi, h * g:(h + 1) * g].double(),
                             k[bi, h].double()) / d ** 0.5
            out[bi, h * g:(h + 1) * g] = torch.softmax(
                s.masked_fill(~ok, float("-inf")), -1) @ v[bi, h].double()
    return out


def check_flash_bf16(got, q, k, v, kv_len, what):
    """Holds a bf16 flash_attention output to the f64 answer within
    rtol = atol = 2**-7 everywhere, and reads it against its plain
    version (flash_attention_ref) at the same bar: wherever the two part
    by more than the bar, the output must lie nearer the f64 answer than
    the plain version does.  The plain version's f32 scores carry the
    rounding of a sequential f32 dot product of q * scale and k; at rows
    whose leading keys nearly tie, with |v| ~ 100, that alone moves an
    output by about the bar (PERF.md, Findings).  Returns max |got - plain|
    and the readings."""
    from repro_torch.kernels.ref import flash_attention_ref
    tol = 2.0 ** -7
    plain = flash_attention_ref(q, k, v, causal=True, kv_len=kv_len).double()
    exact = exact_attention(q, k, v, kv_len)
    got = got.double()
    share = lambda a, ref: (a - ref).abs() / (tol * (1.0 + ref.abs()))
    got_off, plain_off = share(got, exact), share(plain, exact)
    beyond = share(got, plain) > 1
    n_beyond, n_plain_off = int(beyond.sum()), int((plain_off > 1).sum())
    n_blamed = int((beyond & (got_off >= plain_off)).sum())
    worst = float(got_off.max())
    err = float((got - plain).abs().max())
    readings = (f"max |diff| from plain {err:.4g}; {n_beyond} elements "
                f"beyond rtol = atol = 2**-7 of plain, {n_blamed} of them "
                f"no nearer the f64 answer than plain; max share of the bar "
                f"from the f64 answer: kernel {worst:.4g}, plain "
                f"{float(plain_off.max()):.4g} (plain beyond it at "
                f"{n_plain_off} elements)")
    check(n_blamed == 0 and worst <= 1.0, f"{what}: {readings}")
    return err, readings


def lm_deviations(params, tokens, cfg):
    """Logits of forward_seq + _unembed, and of prefill(tokens[:, :-1])
    and a decode step of tokens[:, -1], with the model's attention as
    it is patched."""
    from repro_torch.models import transformer as tr
    from repro_torch.models import zoo
    x, _, _ = tr.forward_seq(params, tokens, cfg)
    logits = tr._unembed(params, x, cfg)
    lp, cache = zoo.prefill_fn(cfg, tokens.shape[1] + 8)(
        params, {"tokens": tokens[:, :-1]})
    ld, _ = zoo.decode_fn(cfg)(params, tokens[:, -1], cache)
    return logits, lp[:, 0], ld[:, 0]


def rel_dev(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def phase_lm_consistency(seed: int):
    """(a): float32 at Llama-3-8B widths and a cut depth.  Prefill and
    decode against the forward, and the kernel forward against the
    dense_attention forward, within LM_F32_REL of the logits' scale;
    the plain path's own readings and a bf16-attention control are
    printed beside them, and the control must exceed the bar."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tr
    full = get_arch(LM_ARCH)
    print(f"lm: CUT: (a) float32 runs {LM_F32_LAYERS} of {full.n_layers} "
          f"layers at full width (d_model {full.d_model}, {full.n_q_heads} "
          f"q heads, {full.n_kv_heads} kv heads, hd {full.hd}, d_ff "
          f"{full.d_ff}, vocab {full.vocab})", flush=True)
    cfg = dataclasses.replace(full, n_layers=LM_F32_LAYERS, dtype="float32")
    params = lm_model(cfg, seed)
    tokens = lm_tokens((2, 64), cfg.vocab, seed)
    kernel = tr.attention

    def control(q, k, v, cfg_):
        """The model's attention on q, k and v rounded to bf16."""
        return kernel(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                      cfg_).to(q.dtype)

    runs = {}
    for path, attn in (("kernel", kernel), ("plain", tr.plain_attention),
                       ("control", control)):
        with mock.patch.object(tr, "attention", attn):
            runs[path] = lm_deviations(params, tokens, cfg)
    del params
    torch.cuda.empty_cache()
    p_fwd = runs["plain"][0]
    # (prefill at -2, decode at -1, whole forward) against their
    # references: a path's own forward, or the plain forward
    dev = {path: (rel_dev(lp, ref[:, -2]), rel_dev(ld, ref[:, -1]),
                  rel_dev(fwd, p_fwd))
           for path, (fwd, lp, ld) in runs.items()
           for ref in [p_fwd if path == "control" else fwd]}
    fmt = lambda t: " / ".join(f"{x:.3g}" for x in t)
    print(f"lm: (a) float32 {LM_F32_LAYERS} layers, B=2 S=64, logits max "
          f"|{float(p_fwd.abs().max()):.4g}|; max |diff| / max |want| of "
          f"prefill at -2 / decode at -1 / forward against the plain "
          f"forward: kernel path {fmt(dev['kernel'])}, plain path "
          f"{fmt(dev['plain'])} (prefill and decode against each path's "
          f"own forward); bf16-attention control against the plain "
          f"forward {fmt(dev['control'])}; bar {LM_F32_REL:g}", flush=True)
    check(all(bool(torch.isfinite(t).all()) for t in runs["kernel"]),
          "lm: (a) logits not finite")
    for what, d in zip(("prefill logits differ from forward_seq's at -2",
                        "decode logits differ from forward_seq's at -1",
                        "the forward with the flash kernel differs from "
                        "the one with dense_attention"), dev["kernel"]):
        check(d <= LM_F32_REL, f"lm: (a) {what}: {d:.3g} > {LM_F32_REL:g}")
    check(min(dev["control"]) > LM_F32_REL,
          f"lm: (a) the bar {LM_F32_REL:g} does not separate the bf16 "
          f"control ({fmt(dev['control'])})")


def phase_lm_serving(seed: int):
    """(b): bfloat16 Llama-3-8B at full depth: prefill of 4 x 2,000
    tokens and 32 greedy decode steps, the counted LM main path.
    Returns the kernel's launch count and the captured layer-0 q, k, v
    (for the kernel row)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import _cuda
    from repro_torch.models import transformer as tr
    from repro_torch.models import zoo
    from repro_torch.models.params import count_params, tree_bytes
    cfg = get_arch(LM_ARCH)
    specs = zoo.model_specs(cfg)
    cache_len = LM_PROMPT + LM_DECODE
    sync()
    t0 = time.perf_counter()
    params = lm_model(cfg, seed)
    sync()
    t_init = time.perf_counter() - t0
    c_bytes = 2 * np.prod(tr.cache_spec(cfg, LM_REQUESTS, cache_len)["k"][0]
                          ) * 2
    print(f"lm: (b) {cfg.name} bfloat16, {cfg.n_layers} layers, "
          f"{count_params(specs):,} parameters ({tree_bytes(specs, cfg.dtype):,}"
          f" bytes) drawn on the card in {t_init:.2f} s; cache {c_bytes:,} "
          f"bytes (B={LM_REQUESTS}, T={cache_len})", flush=True)
    prefill, decode = zoo.prefill_fn(cfg, cache_len), zoo.decode_fn(cfg)
    tokens = lm_tokens((LM_REQUESTS, LM_PROMPT), cfg.vocab, seed + 1)
    # warm-up (cuBLAS handles, the first launch), not counted
    lw, cw = prefill(params, {"tokens": tokens[:1, :128]})
    decode(params, lw[:, 0].argmax(-1), cw)
    del lw, cw

    captured = {}
    calls = []

    def spy(q, k, v, cfg_):
        o = real(q, k, v, cfg_)
        if len(calls) in (0, cfg.n_layers - 1):
            captured[len(calls)] = (q, k, v, o)
        calls.append(1)
        return o

    real = tr.attention
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(tr, "attention", spy):
        logits, cache = prefill(params, {"tokens": tokens})
    sync()
    t_prefill = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        token = logits[:, 0].argmax(-1)
        logits, cache = decode(params, token, cache)
        finite &= torch.isfinite(logits).all()
    sync()
    t_decode = time.perf_counter() - t0
    counts_all = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(bool(finite), "lm: (b) logits are not all finite")
    check(counts["flash_attention"] == cfg.n_layers,
          f"lm: (b) flash_attention launched {counts['flash_attention']} "
          f"times in the prefill, not once per layer ({cfg.n_layers})")
    check(cache["pos"] == cache_len, "lm: (b) the cache did not fill")
    n_tok = LM_REQUESTS * LM_PROMPT
    print(f"lm: (b) prefill {LM_REQUESTS} x {LM_PROMPT} tokens in "
          f"{t_prefill:.4f} s = {n_tok / t_prefill:.1f} tokens/s; "
          f"{LM_DECODE} greedy decode steps in {t_decode:.4f} s = "
          f"{t_decode * 1e3 / LM_DECODE:.3f} "
          f"ms/step, {LM_REQUESTS * LM_DECODE / t_decode:.1f} tokens/s; "
          f"max_memory_allocated={peak}; launches over the prefill "
          f"{json.dumps(counts)}, after decode {json.dumps(counts_all)}; "
          f"logits finite", flush=True)
    check(sorted(captured) == [0, cfg.n_layers - 1],
          "lm: (b) layers 0 and 31 were not captured")
    for layer, (q, k, v, o) in sorted(captured.items()):
        _, readings = check_flash_bf16(
            o.transpose(1, 2), q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), None, f"lm: (b) layer {layer}: "
            f"flash_attention differs by more than one bf16 ulp")
        print(f"lm: (b) layer {layer}: flash_attention against "
              f"flash_attention_ref and the f64 answer on its q, k, v: "
              f"{readings}", flush=True)
    # where the time goes: one prefill and one decode step under the
    # profiler, device activities by name (after the counted run)
    batch = {"tokens": tokens}
    del logits
    for what, fn in (("prefill", lambda: prefill(params, batch)),
                     ("decode step", lambda: decode(
                         params, token, dict(cache, pos=cache_len - 1)))):
        wall, dev, top = device_busy(fn, n_top=10)
        print(f"lm: (b) profile {what}: wall_ms={wall:.3f} device_ms="
              f"{dev:.3f} busy={dev / wall:.4f} top={json.dumps(top)}",
              flush=True)
    q, k, v, _ = captured[0]
    del params, cache, captured
    torch.cuda.empty_cache()
    return counts["flash_attention"], (q, k, v)


def dump_sass(lib):
    """(cuobjdump's path or None, its --dump-sass run on ``lib`` or
    None): the CUDA toolkit's cuobjdump or Triton's copy."""
    import importlib.util
    import shutil
    from repro_torch.kernels import _cuda
    exes = [shutil.which("cuobjdump"),
            *(str(Path(r, "bin", "cuobjdump")) for r in _cuda.CUDA_ROOTS)]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        exes.append(str(Path(spec.origin).parent / "backends" / "nvidia"
                        / "bin" / "cuobjdump"))
    exe = next((e for e in exes if e and Path(e).is_file()), None)
    sass = subprocess.run([exe, "--dump-sass", str(lib)],
                          capture_output=True, text=True,
                          timeout=300) if exe else None
    return exe, sass


def sass_instructions(kernel: str, template: str) -> str:
    """A note: the SASS instructions of ``template`` (a mangled-name
    fragment, say "rankeval_kernelILi9E") in ``kernel``'s library,
    counted statically: every instruction of the function, the division's
    slow-path code included."""
    from repro_torch.kernels import _cuda
    exe, sass = dump_sass(_cuda.build()[_cuda.SOURCES[kernel]].path)
    if sass is None or sass.returncode != 0:
        return f"sass_instructions(\"{template}\")=not available"
    for fn in re.split(r"\n\s*Function : ", sass.stdout)[1:]:
        if template in fn.split("\n", 1)[0]:
            n = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", fn))
            return f"sass_instructions(\"{template}\")={n}"
    return f"sass_instructions(\"{template}\")=not found"


def flash_bodies_and_sass():
    """Which body the flash library launches for each type and head
    width (its own flash_attention_body), and the HGMMA (wgmma)
    instructions in each kernel's SASS, read with cuobjdump from the CUDA
    toolkit or Triton's copy ("not available" without one).  Fails if
    bf16 at D 128 is not the tensor-core body, or if readable SASS shows
    no HGMMA in it."""
    import ctypes
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa
    lib = _cuda.build()[_cuda.SOURCES["flash_attention"]].path
    body = ctypes.CDLL(str(lib)).flash_attention_body
    body.argtypes = [ctypes.c_int, ctypes.c_int]
    names = {1: "tensor cores (flash_tc_kernel)",
             0: "CUDA cores (flash_kernel)"}
    print("kernels: flash_attention bodies: " + "; ".join(
        f"{dt} D {d}: {names[body(bf, d)]}" for dt, bf in (("f32", 0),
                                                          ("bf16", 1))
        for d in fa.HEAD_DIMS), flush=True)
    check(body(1, 128) == 1, "kernels: bf16 D 128 does not take the "
          "tensor-core body")
    exe, sass = dump_sass(lib)
    if sass is None or sass.returncode != 0:
        print("kernels: flash_attention SASS HGMMA count: not available "
              f"({'no cuobjdump' if exe is None else sass.stderr.strip()})",
              flush=True)
        return
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass.stdout)[1:]:
        m = re.search(r"(flash_tc_kernel|flash_kernel)I(f|13__nv_bfloat16)?"
                      r"Li(\d+)E", fn.split("\n", 1)[0])
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            counts[f"{m.group(1)}<{dt}, {m.group(3)}>"] = fn.count("HGMMA")
    print(f"kernels: flash_attention SASS HGMMA count ({exe}): "
          f"{json.dumps(counts)}", flush=True)
    check(counts.get("flash_tc_kernel<bf16, 128>", 0) > 0,
          "kernels: no HGMMA in flash_tc_kernel<bf16, 128>'s SASS")


def phase_flash_kernel(launches, qkv):
    """The kernel row at the prefill's padded shape, the bodies and
    HGMMA count of the flash library, and an f32 check of kernel against
    plain version at a small shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    flash_bodies_and_sass()
    for causal in (True, False):
        q, k, v = (torch.from_numpy(np.random.default_rng(i).normal(
            size=s).astype(np.float32)).to(DEVICE) for i, s in
            enumerate(((2, 8, 200, 128), (2, 2, 300, 128), (2, 2, 300, 128))))
        err = assert_close(ops.flash_attention(q, k, v, causal=causal),
                           flash_attention_ref(q, k, v, causal=causal), 1e-4,
                           "kernels: f32 flash_attention differs from plain")
        print(f"kernels: flash_attention f32 (2, 8, 200, 128) x (2, 2, 300, "
              f"128) causal={causal}: max |diff| from plain {err:.3g} "
              f"(bar 1e-4)", flush=True)
    q, k, v = (t.transpose(1, 2) for t in qkv)
    b, hq, s, d = q.shape
    hk = k.shape[1]
    pad = (-s) % fa.TILE
    qp, kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)).contiguous()
                  for t in (q, k, v))
    sp = s + pad
    err, readings = check_flash_bf16(
        fa.flash_attention(qp, kp, vp, causal=True, kv_len=s), qp, kp, vp, s,
        "kernels: flash_attention at the prefill shape")
    print(f"kernels: flash_attention at the prefill's padded shape against "
          f"flash_attention_ref and the f64 answer: {readings}", flush=True)
    # live (q, k) pairs the mask keeps: row i sees keys < min(i + 1, s)
    live = sum(min(i + 1, s) for i in range(sp))
    flops = 4.0 * b * hq * d * live
    nbytes = 2.0 * (2 * b * hq * sp * d + 2 * b * hk * sp * d)
    ms_at = lambda passes, rate: passes * flops / rate * 1e3
    print(f"kernels: flash_attention at the prefill's padded shape "
          f"({b}, {hq}, {sp}, {d}) x ({b}, {hk}, {sp}, {d}) bf16 causal, "
          f"kv_len {s}: {live:,} live pairs per head, {flops:.4g} flops; "
          f"bound at the work the tensor-core body does ({FLASH_TC_PASSES:g} "
          f"bf16 passes: Q K^T once, P V as P_hi V + P_lo V) at "
          f"{BF16_TC_FLOP_PER_S / 1e12:.0f} TFLOP/s "
          f"{ms_at(FLASH_TC_PASSES, BF16_TC_FLOP_PER_S):.4f} ms; notes: "
          f"3 bf16 passes (an f32 x bf16 product, the earlier bound) "
          f"{ms_at(3, BF16_TC_FLOP_PER_S):.4f} ms, the CUDA cores' f32 "
          f"rate {ms_at(1, F32_FLOP_PER_S):.4f} ms, one bf16 pass (SDPA's "
          f"precision) {ms_at(1, BF16_TC_FLOP_PER_S):.4f} ms", flush=True)
    try:
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qp, kp, vp, is_causal=True, enable_gqa=True)
        sdpa()
    except TypeError:       # a torch without enable_gqa: repeat k and v
        kr, vr = (t.repeat_interleave(hq // hk, 1) for t in (kp, vp))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qp, kr, vr, is_causal=True)
    return kernel_row(
        "flash_attention", launches, err,
        lambda: fa.flash_attention(qp, kp, vp, causal=True, kv_len=s), 10,
        lambda: flash_attention_ref(qp, kp, vp, causal=True, kv_len=s), 3,
        nbytes, FLASH_TC_PASSES * flops, library=sdpa,
        flop_per_s=BF16_TC_FLOP_PER_S)


# --------------------------------------------------------------- retrieval
def phase_retrieval(seed: int):
    """The port's twin of examples/retrieval_serving.py steps 1-4."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import BatchedLIMS, LIMSIndex, MetricSpace
    from repro_torch.core.metrics import dist_one_to_many
    from repro_torch.kernels import _cuda
    from repro_torch.models.transformer import forward_seq
    cfg = ModelConfig(**ENCODER)
    params = lm_model(cfg, seed)
    rng = np.random.default_rng(0)
    anchors = rng.integers(0, cfg.vocab, (100, 32))
    corpus_tokens = np.repeat(anchors, 50, axis=0)
    for i in range(5_000):
        corpus_tokens[i, rng.integers(0, 32)] = rng.integers(0, cfg.vocab)
    q_tokens = anchors[:16].copy()
    for i in range(16):
        q_tokens[i, rng.integers(0, 32)] = rng.integers(0, cfg.vocab)

    def encode(tokens):
        t = torch.from_numpy(tokens.astype(np.int32)).to(DEVICE)
        x, _, _ = forward_seq(params, t, cfg)
        return x.mean(dim=1)[:, :32].double().cpu().numpy()

    sync()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    corpus = encode(corpus_tokens)
    t_enc = time.perf_counter() - t0
    q_emb = encode(q_tokens)
    check(np.isfinite(corpus).all(), "retrieval: embeddings not finite")
    t0 = time.perf_counter()
    ix = LIMSIndex(MetricSpace(corpus, "l2"), n_clusters=100, m=3, n_rings=20)
    t_ix = time.perf_counter() - t0
    bx = BatchedLIMS(ix, device=DEVICE)
    bx.knn_query_batch(q_emb, 5)
    sync()
    t0 = time.perf_counter()
    ids, ds = bx.knn_query_batch(q_emb, 5)
    t_q = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    for name in ("flash_attention", "pdist", "rankeval", "pdist_rankeval"):
        check(counts[name] > 0, f"retrieval: {name} was not launched")
    for i, q in enumerate(q_emb):
        h_ids, h_ds = ix.knn_query(q, 5)[:2]
        d_all = dist_one_to_many(q, corpus, "l2")
        top = np.argsort(d_all, kind="stable")[:5]
        check(np.array_equal(ds[i], h_ds)
              and np.array_equal(np.sort(ids[i]), np.sort(h_ids)),
              f"retrieval: query {i} differs from the host index")
        check(np.array_equal(ds[i], d_all[top])
              and np.array_equal(np.sort(ids[i]), np.sort(top)),
              f"retrieval: query {i} differs from the f64 brute-force scan")
    print(f"retrieval: {cfg.name} (4 layers, d 256, f32) embedded "
          f"{len(corpus):,} docs of 32 tokens to d=32 in {t_enc:.3f} s on "
          f"the card; host LIMSIndex(K=100, m=3, N=20) in {t_ix:.2f} s; "
          f"BatchedLIMS 16 kNN (k=5) in {t_q * 1e3:.2f} ms; all 16 "
          f"identical to the host index and to the f64 brute-force scan; "
          f"launches {json.dumps(counts)}", flush=True)
    d32_bodies(torch.from_numpy(q_emb.astype(np.float32)).to(DEVICE),
               torch.from_numpy(corpus.astype(np.float32)).to(DEVICE), seed)


def d32_bodies(q_emb, corpus, seed: int) -> None:
    """pdist and range_filter at d = 32 through their register body and
    through the generic one (Points<0>, which the C entry points take for
    operands that are not 16-B aligned): equal bit for bit, and timed at
    the retrieval example's (16, 5,000) and at a shape that moves bytes."""
    from repro_torch.kernels import pdist as _pdist
    from repro_torch.kernels import range_filter as _rf

    def offset(t):          # the same values, 4 bytes past a 16-B boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    big = (torch.randn(B, 32, generator=g, device=DEVICE),
           torch.randn(1 << 20, 32, generator=g, device=DEVICE))
    for q, p in ((q_emb, corpus), big):
        p_gen = offset(p)
        d2 = _pdist.pdist(q, p)
        check(torch.equal(d2, _pdist.pdist(q, p_gen))
              and torch.equal(d2, _pdist.pdist_plain(q, p)),
              f"retrieval: pdist's d = 32 bodies differ at {tuple(q.shape)} "
              f"x {tuple(p.shape)}")
        r2 = d2.kthvalue(max(1, p.shape[0] // 100), dim=1).values
        m, c = _rf.range_filter(q, p, r2)
        m_g, c_g = _rf.range_filter(q, p_gen, r2)
        m_p, c_p = _rf.range_filter_plain(q, p, r2)
        check(all(torch.equal(a, b) for a, b in
                  ((m, m_g), (c, c_g), (m, m_p), (c, c_p))),
              f"retrieval: range_filter's d = 32 bodies differ at "
              f"{tuple(q.shape)} x {tuple(p.shape)}")
        del d2, m, c, m_g, c_g, m_p, c_p
        it = 200 if p.shape[0] < 100_000 else 20
        t = [time_ms(lambda: _pdist.pdist(q, p), it),
             time_ms(lambda: _pdist.pdist(q, p_gen), it),
             time_ms(lambda: _rf.range_filter(q, p, r2), it),
             time_ms(lambda: _rf.range_filter(q, p_gen, r2), it)]
        print(f"retrieval: d=32 at ({q.shape[0]}, {p.shape[0]}): pdist "
              f"register body {t[0]:.4f} ms, generic body {t[1]:.4f} ms; "
              f"range_filter register {t[2]:.4f} ms, generic {t[3]:.4f} ms "
              f"(wrapper ms, CUDA events; bit for bit equal)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="GaussMix rows (default 1,000,000)")
    ap.add_argument("--batches", type=int, default=8,
                    help="query batches of 64 per kind (default 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also print where one batch's time goes")
    ap.add_argument("--linf-n", type=int, default=LINF_N,
                    help=f"Skewed rows of the builder's L-infinity part "
                         f"(default {LINF_N:,}; the other parts run at --n)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LM phases' weights and tokens")
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

    X = gauss_mix(args.n, D, seed=0)
    t0 = time.perf_counter()
    ix = LIMSIndex(MetricSpace(X, "l2"), n_clusters=K_CLUSTERS, m=M,
                   n_rings=RINGS, degree=DEGREE)
    t_host = time.perf_counter() - t0
    sizes = [ci.n for ci in ix.clusters]
    print(f"main: GaussMix n={args.n} d={D}; host LIMSIndex K={ix.K} m={M} "
          f"N={RINGS} degree={DEGREE} built in {t_host:.2f} s; "
          f"cluster rows max={max(sizes)} mean={np.mean(sizes):.1f}",
          flush=True)
    batches = make_queries(X, np.random.default_rng(1), args.batches)

    counts, shapes, snap, host_range, host_knn = phase_main(
        X, ix, batches, LIMSSnapshot, QueryExecutor)
    phase_error_bound(ix, snap)
    kernels = phase_kernels(ix, snap, batches, counts, shapes)
    if args.profile:
        phase_profile(QueryExecutor(snap), batches)
    del snap

    t0 = time.perf_counter()
    ixd = phase_builder_l2(X, ix, t_host, batches, host_range, host_knn)
    kernels.append(phase_builder_lp("l1", args.n))
    if args.linf_n != args.n:
        print(f"builder: CUT: the L-infinity part (c) runs at "
              f"n={args.linf_n}, not {args.n}", flush=True)
    kernels.append(phase_builder_lp("linf", args.linf_n))
    for metric in ("l1", "linf"):
        phase_builder_lp(metric, WIDE_N, data="gaussmix", d=WIDE_D,
                         rows=False)
    phase_retrain(X, ix, ixd, batches)
    print(f"builder: all parts in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del X, ix, ixd, batches, host_range, host_knn
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_lm_consistency(args.seed)
    launches, qkv = phase_lm_serving(args.seed)
    kernels.append(phase_flash_kernel(launches, qkv))
    del qkv
    phase_retrieval(args.seed)
    print(f"lm: and retrieval: in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
