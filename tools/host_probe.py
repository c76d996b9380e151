#!/usr/bin/env python3
"""Host microseconds a call of the ``pdist_rankeval`` wrapper and its
parts cost in one source tree of this repo, on one CUDA card.

    python3 tools/host_probe.py TREE MODE

``TREE`` is a checkout (or ``git archive``) of this repo whose kernels
are built; ``MODE`` is its ``REPRO_AUTOTUNE``.  At the plan stage's
shape (``ab_rank_kernels.inputs``: (64, 192), d 8, C 9) it times, after
200 warm-up calls, 7 windows of 2,000 calls of each of: the wrapper
(``ops.pdist_rankeval``), a bare launch at the static tile, three
``torch.empty`` calls like the wrapper's (no code of the port: the
process's own host speed), and in a tree with the autotuner its lookup
(``autotune.tiles_for`` and ``ops._tiles``).  It prints one JSON line,
[min, median] of the windows per name.

A process's host speed varies from one process to the next, so run it
in many processes, the trees and modes in turns, for example

    for i in 1 2 3; do for spec in "A on" "B on" "B off"; do
      set -- $spec; python3 tools/host_probe.py $1 $2; done; done
"""
import json
import os
import statistics
import sys
import time
from pathlib import Path

tree, mode = sys.argv[1], sys.argv[2]
os.environ["REPRO_AUTOTUNE"] = mode
sys.path.insert(0, os.path.join(tree, "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch  # noqa: E402
from ab_rank_kernels import B, C, D, G, N_RINGS, inputs  # noqa: E402
from repro_torch.kernels import _cuda, ops  # noqa: E402

dev = torch.device("cuda")
_, pargs = inputs(0, dev)
try:
    from repro_torch.kernels.autotune import tile_args
    tile = tile_args("pdist_rankeval")
except ImportError:
    tile = ()
res = torch.empty(3, G, B, dtype=torch.int32, device=dev)
ptrs = [t.data_ptr() for t in (*pargs, *res)] + [B, G, D, C, N_RINGS, *tile]
fns = {
    "wrapper": lambda: ops.pdist_rankeval(*pargs, n_rings=N_RINGS),
    "bare": lambda: _cuda.launch("pdist_rankeval", *ptrs, device=dev),
    "empty3": lambda: (torch.empty(B, G, device=dev),
                       torch.empty(G, B, dtype=torch.int32, device=dev),
                       torch.empty(G, B, dtype=torch.int32, device=dev)),
}
if tile:
    from repro_torch.kernels import autotune
    q = pargs[0]
    dims = {"g": G, "b": B, "d": D, "c": C}
    fns["tiles_for"] = lambda: autotune.tiles_for("pdist_rankeval", None,
                                                  dims, q.device)
    fns["_tiles"] = lambda: ops._tiles("pdist_rankeval", None, dims, q)
out = {}
for name, fn in fns.items():
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    wins = []
    for _ in range(7):
        t0 = time.perf_counter_ns()
        for _ in range(2000):
            fn()
        wins.append((time.perf_counter_ns() - t0) / 2000 / 1e3)
        torch.cuda.synchronize()
    out[name] = [round(min(wins), 3), round(statistics.median(wins), 3)]
print(json.dumps({"tree": tree, "mode": mode, **out}))
