"""The A, B, B, A turns the kernel A/B tools share.

A tool defines ``worker(tree, seed) -> dict`` and calls
``sys.exit(abba.main(worker, __doc__, __file__))``.  Each turn is a
subprocess that runs the tool again with ``--worker TREE``: it puts the
tree's ``src`` (and this repo's root, for ``chip_smoke``'s timers) first
on ``sys.path`` and prints the worker's JSON dict, so every turn imports
and builds its own tree's kernels.  The parent prints each turn's dict,
the card's name and power limit, each ``*_ms`` / ``*_us`` key's mean over
the A and the B turns with B / A, and whether every ``*_hash`` key is
equal across the turns.  ``--autotune`` sets every turn's
``REPRO_AUTOTUNE`` (default ``off``; ``on`` is the port's default, under
which a tree with a tuning table reads it on every launch).  It exits 2
without a card, 1 if a turn fails or the outputs differ.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(worker, doc: str, script: str, argv=None) -> int:
    tool = Path(script).stem
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--a", type=Path, required=True, help="tree A")
    ap.add_argument("--b", type=Path, default=ROOT, help="tree B")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--autotune", choices=("off", "on"), default="off",
                    help="REPRO_AUTOTUNE of every turn (default off)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        tree = args.worker.resolve()
        sys.path.insert(0, str(tree / "src"))
        sys.path.insert(0, str(ROOT))
        print(json.dumps(dict(worker(tree, args.seed), tree=str(tree))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    turns = {"A": [], "B": []}
    for side in "ABBA":
        tree = (args.a if side == "A" else args.b).resolve()
        res = subprocess.run(
            [sys.executable, script, "--a", str(args.a), "--seed",
             str(args.seed), "--worker", str(tree)],
            capture_output=True, text=True,
            env=dict(os.environ, REPRO_AUTOTUNE=args.autotune))
        if res.returncode != 0:
            print(f"{tool}: turn {side} ({tree}) failed:\n"
                  f"{res.stdout}{res.stderr}", file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{side} {json.dumps(row)}", flush=True)
        turns[side].append(row)
    print(f"card: {smi}; REPRO_AUTOTUNE={args.autotune}")
    first, rows = turns["A"][0], turns["A"] + turns["B"]
    same = all(r[k] == first[k] for r in rows for k in first
               if k.endswith("_hash"))
    for k in first:
        if k.endswith(("_ms", "_us")):
            a = sum(r[k] for r in turns["A"]) / 2
            b = sum(r[k] for r in turns["B"]) / 2
            print(f"{k}: A {a:.5f} B {b:.5f} B/A {b / a:.3f}")
    print(f"outputs bit for bit equal between the trees: {same}")
    return 0 if same else 1
