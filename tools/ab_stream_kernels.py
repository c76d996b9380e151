#!/usr/bin/env python3
"""Time the streaming kernels of two source trees of this repo on one
CUDA card, in turns A, B, B, A.

    python3 tools/ab_stream_kernels.py --a OTHER_TREE [--b .] [--seed 0]

A tree is a checkout (or ``git archive``) of this repo.  Each turn is a
subprocess that imports ``repro_torch`` from the tree's ``src``, builds
the tree's kernels there and times, on seeded GaussMix-like inputs at
the query path's shapes (d 8), CUDA events around 20 calls each of the
wrapper and of bare launches into preallocated outputs:

* ``pdist`` at (64, 4,607,872): f32 and bf16 points;
* ``range_filter`` at (64, 4,607,872) (f32 and bf16 points) and at the
  compacted bucket (64, 1,048,576);
* ``pdist_l1`` and ``pdist_linf`` at the builder's grouped launch (64,
  3, 289,664).

The wrappers run under ``--autotune`` (``abba.py``; default off); the
bare launches of a tree whose kernels take a tile take its static tile
(``ab_rank_kernels.static_tile``).
The turns, the means with B / A and the bit-for-bit check of the
outputs (hashes of every matrix, mask and count) are ``tools/abba.py``'s.
"""
from __future__ import annotations

import sys
from pathlib import Path

import abba
from ab_rank_kernels import digest, static_tile

B, P, P_COMPACT, D = 64, 4_607_872, 1_048_576, 8
GROUPS, M, N_MAX = 64, 3, 289_664           # the builder's grouped launch


def worker(tree: Path, seed: int) -> dict:
    import torch
    from chip_smoke import time_ms
    from repro_torch.kernels import _cuda, ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, D, generator=gen, device=dev)
    rows = torch.randn(P, D, generator=gen, device=dev)
    r = torch.full((B,), 2.5, device=dev)
    out = {}
    tile = static_tile("pdist")
    for tag, p in (("f32", rows), ("bf16", rows.to(torch.bfloat16))):
        name = "pdist" + ("" if tag == "f32" else "_" + tag)
        d2 = ops.pdist(q, p)
        out[f"pdist_{tag}_hash"] = digest(d2)
        ptrs = [q.data_ptr(), p.data_ptr(), d2.data_ptr(), B, P, D, *tile]
        out[f"pdist_{tag}_wrapper_ms"] = time_ms(lambda: ops.pdist(q, p), 20)
        out[f"pdist_{tag}_bare_ms"] = time_ms(
            lambda: _cuda.launch(name, *ptrs, device=dev), 20)
        del d2
        for n in (P, P_COMPACT) if tag == "f32" else (P,):
            pn = p[:n]
            mask, cnt = ops.range_filter(q, pn, r)
            key = f"range_filter_{tag}_{n}"
            out[f"{key}_hash"] = digest(mask, cnt)
            r2 = r * r
            rname = "range_filter" + ("" if tag == "f32" else "_" + tag)
            rptrs = [q.data_ptr(), pn.data_ptr(), r2.data_ptr(),
                     mask.data_ptr(), cnt.data_ptr(), B, n, D, *tile]
            out[f"{key}_wrapper_ms"] = time_ms(
                lambda: ops.range_filter(q, pn, r), 20)
            out[f"{key}_bare_ms"] = time_ms(
                lambda: _cuda.launch(rname, *rptrs, device=dev), 20)
            del mask, cnt
    del rows
    qg = torch.randn(GROUPS, M, D, generator=gen, device=dev)
    pg = torch.randn(GROUPS, N_MAX, D, generator=gen, device=dev)
    for metric in ("l1", "linf"):
        got = ops.pdist_grouped(qg, pg, metric)
        out[f"pdist_{metric}_hash"] = digest(got)
        gptrs = [qg.data_ptr(), pg.data_ptr(), got.data_ptr(), GROUPS, M,
                 N_MAX, D, *tile]
        out[f"pdist_{metric}_wrapper_ms"] = time_ms(
            lambda: ops.pdist_grouped(qg, pg, metric), 20)
        out[f"pdist_{metric}_bare_ms"] = time_ms(
            lambda: _cuda.launch(f"pdist_{metric}", *gptrs, device=dev), 20)
        del got
    return out


if __name__ == "__main__":
    sys.exit(abba.main(worker, __doc__, __file__))
