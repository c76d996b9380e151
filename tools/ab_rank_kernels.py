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

The turns, the means with B / A and the bit-for-bit check of the
outputs (hashes of rank, rid, dq and the ranks) are ``tools/abba.py``'s.
The wrappers run under ``--autotune`` (``abba.py``; default off); the
bare launches of a tree whose kernels take a tile take its static tile
(``static_tile``).
"""
from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import abba

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


def static_tile(kernel: str) -> tuple:
    """The tree's static tile as a bare launch's last ints
    (``autotune.tile_args``): () for a tree whose entry points take no
    tile (before the autotuner)."""
    try:
        from repro_torch.kernels.autotune import tile_args
    except ImportError:
        return ()
    return tile_args(kernel)


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree: Path, seed: int) -> dict:
    import torch
    from chip_smoke import graph_ms, host_us, time_ms
    from repro_torch.kernels import _cuda, ops
    dev = torch.device("cuda")
    (x, coef, lo, hi, n), pargs = inputs(seed, dev)
    out = {}

    rk, rid = ops.rankeval(x, coef, lo, hi, n, N_RINGS)
    out["rankeval_hash"] = digest(rk, rid)
    outs = torch.empty(2, G, NC, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (x, coef, lo, hi, n, *outs)]
    out["rankeval_wrapper_ms"] = time_ms(
        lambda: ops.rankeval(x, coef, lo, hi, n, N_RINGS), 50)
    ptrs += [G, NC, C, N_RINGS, *static_tile("rankeval")]
    out["rankeval_bare_ms"] = time_ms(
        lambda: _cuda.launch("rankeval", *ptrs, device=dev), 50)

    fused = ops.pdist_rankeval(*pargs, n_rings=N_RINGS)
    out["pdist_rankeval_hash"] = digest(*fused)

    tile = static_tile("pdist_rankeval")

    def bare_at(b, g):
        res = torch.empty(3, g, b, dtype=torch.int32, device=dev)
        p = [t.data_ptr() for t in (*pargs, *res)]
        p += [b, g, D, C, N_RINGS, *tile]
        return lambda: _cuda.launch("pdist_rankeval", *p, device=dev)

    call = (lambda: ops.pdist_rankeval(*pargs, n_rings=N_RINGS))
    out["pdist_rankeval_wrapper_ms"] = time_ms(call, 1000)
    out["pdist_rankeval_wrapper_host_us"] = host_us(call, 1000)
    bare, floor = bare_at(B, G), bare_at(1, 1)
    out["pdist_rankeval_bare_ms"] = time_ms(bare, 1000)
    out["pdist_rankeval_graph_ms"] = graph_ms(bare)
    out["pdist_rankeval_floor_ms"] = time_ms(floor, 1000)
    out["pdist_rankeval_graph_floor_ms"] = graph_ms(floor)
    return out


if __name__ == "__main__":
    sys.exit(abba.main(worker, __doc__, __file__))
