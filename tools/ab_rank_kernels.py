#!/usr/bin/env python3
"""Time the rank kernels of two source trees of this repo on one CUDA
card, in turns A, B, B, A.

    python3 tools/ab_rank_kernels.py --a OTHER_TREE [--b .] [--seed 0]

A tree is a checkout (or ``git archive``) of this repo.  Each turn is a
subprocess that imports ``repro_torch`` from the tree's ``src``, builds
the tree's kernels there (nvcc, as its ``_cuda.build`` does) and times,
on inputs made from ``--seed`` at the query path's shapes:

* ``rankeval`` at (192, 71,998), C 9 (the snapshot's E certification at
  n = 1,000,000): the wrapper and bare launches into preallocated
  outputs, CUDA events around 50 calls;
* ``pdist_rankeval`` at (64, 192), d 8, C 9 (the plan stage): the
  wrapper, with CUDA events and with the host clock over 1,000 calls;
  bare launches with CUDA events over 1,000 back-to-back launches and
  replayed from a CUDA graph (device time with no host cost); and the
  bare launch at (1, 1), the floor.

Each turn prints one JSON line; the last lines are each metric's mean
over the A and the B turns with B / A, and whether the two trees' outputs
agree bit for bit (hashes of rank, rid, dq and the ranks).  The card's
name and power limit head the table.  Exits nonzero without a card, or if
the outputs differ.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
G, NC, C = 192, 71_998, 9           # rankeval: groups, values, coefficients
B, D = 64, 8                        # pdist_rankeval: queries, width
N_RINGS = 20


def inputs(seed: int, device):
    """The two kernels' operands: rank models whose ranks span [0, n),
    sorted distance columns inside each model's [lo, hi]."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def models(g, n):
        coef = rng.normal(0.0, 5.0, (g, C)).astype(np.float32)
        coef[:, 0] = coef[:, 1] = n / 2.0
        lo = rng.uniform(0.0, 0.1, g).astype(np.float32)
        hi = (lo + rng.uniform(0.5, 1.5, g)).astype(np.float32)
        return coef, lo, hi, np.full(g, n, np.float32)

    coef, lo, hi, n = models(G, NC)
    x = np.sort(rng.uniform(0.0, 1.0, (G, NC)), axis=1)
    x = (lo[:, None] + x * (hi - lo)[:, None]).astype(np.float32)
    pcoef, plo, phi, pn = models(G, 15_000)
    q = rng.normal(0.0, 0.3, (B, D)).astype(np.float32)
    piv = rng.normal(0.0, 0.3, (G, D)).astype(np.float32)
    rg = rng.uniform(0.0, 0.1, B).astype(np.float32)
    put = (lambda a: torch.from_numpy(a).to(device))
    return ([put(a) for a in (x, coef, lo, hi, n)],
            [put(a) for a in (q, piv, pcoef, plo, phi, pn, rg)])


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree: Path, seed: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    from chip_smoke import graph_ms, host_us, time_ms
    from repro_torch.kernels import _cuda, ops
    dev = torch.device("cuda")
    (x, coef, lo, hi, n), pargs = inputs(seed, dev)
    out = {"tree": str(tree)}

    rk, rid = ops.rankeval(x, coef, lo, hi, n, N_RINGS)
    out["rankeval_hash"] = digest(rk, rid)
    outs = torch.empty(2, G, NC, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (x, coef, lo, hi, n, *outs)]
    out["rankeval_wrapper_ms"] = time_ms(
        lambda: ops.rankeval(x, coef, lo, hi, n, N_RINGS), 50)
    out["rankeval_bare_ms"] = time_ms(
        lambda: _cuda.launch("rankeval", *ptrs, G, NC, C, N_RINGS,
                             device=dev), 50)

    fused = ops.pdist_rankeval(*pargs, n_rings=N_RINGS)
    out["pdist_rankeval_hash"] = digest(*fused)

    def bare_at(b, g):
        res = torch.empty(3, g, b, dtype=torch.int32, device=dev)
        p = [t.data_ptr() for t in (*pargs, *res)]
        return lambda: _cuda.launch("pdist_rankeval", *p, b, g, D, C,
                                    N_RINGS, device=dev)

    call = (lambda: ops.pdist_rankeval(*pargs, n_rings=N_RINGS))
    out["pdist_rankeval_wrapper_ms"] = time_ms(call, 1000)
    out["pdist_rankeval_wrapper_host_us"] = host_us(call, 1000)
    bare, floor = bare_at(B, G), bare_at(1, 1)
    out["pdist_rankeval_bare_ms"] = time_ms(bare, 1000)
    out["pdist_rankeval_graph_ms"] = graph_ms(bare)
    out["pdist_rankeval_floor_ms"] = time_ms(floor, 1000)
    out["pdist_rankeval_graph_floor_ms"] = graph_ms(floor)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", type=Path, required=True, help="tree A")
    ap.add_argument("--b", type=Path, default=ROOT, help="tree B")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker.resolve(), args.seed)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_rank_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    turns = {"A": [], "B": []}
    for side in "ABBA":
        tree = (args.a if side == "A" else args.b).resolve()
        res = subprocess.run(
            [sys.executable, __file__, "--a", str(args.a), "--seed",
             str(args.seed), "--worker", str(tree)],
            capture_output=True, text=True)
        if res.returncode != 0:
            print(f"ab_rank_kernels: turn {side} ({tree}) failed:\n"
                  f"{res.stdout}{res.stderr}", file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{side} {json.dumps(row)}", flush=True)
        turns[side].append(row)
    print(f"card: {smi}")
    same = all(turns["A"][0][k] == r[k] for r in turns["A"] + turns["B"]
               for k in ("rankeval_hash", "pdist_rankeval_hash"))
    for k in turns["A"][0]:
        if k.endswith(("_ms", "_us")):
            a = sum(r[k] for r in turns["A"]) / 2
            b = sum(r[k] for r in turns["B"]) / 2
            print(f"{k}: A {a:.5f} B {b:.5f} B/A {b / a:.3f}")
    print(f"outputs bit for bit equal between the trees: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
