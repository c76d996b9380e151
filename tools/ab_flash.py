#!/usr/bin/env python3
"""Time the flash_attention kernel of two source trees of this repo on one
CUDA card, in turns A, B, B, A.

    python3 tools/ab_flash.py --a OTHER_TREE [--b .] [--seed 0]

A tree is a checkout (or ``git archive``) of this repo.  Each turn times,
on inputs made from ``--seed``, the kernel entry
(``kernels.flash_attention.flash_attention`` on padded operands with
``kv_len``, CUDA events around 20 calls) at the Llama-3-8B prefill's
padded shape, (4, 32, 2048, 128) x (4, 8, 2048, 128) bf16 causal, kv_len
2000 (the tensor-core body), and at (2, 8, 2048, 128) x (2, 2, 2048, 128)
f32 (the CUDA-core body).  The turns, the means with B / A and the
bit-for-bit check of the outputs are ``tools/abba.py``'s.
"""
from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import abba

SHAPES = {"bf16_d128": (4, 32, 8, 2048, 128, "bfloat16"),
          "f32_d128": (2, 8, 2, 2048, 128, "float32")}
KV_LEN = 2000


def worker(tree: Path, seed: int) -> dict:
    import numpy as np
    import torch
    from chip_smoke import time_ms
    from repro_torch.kernels import flash_attention as fa
    out, rng = {}, np.random.default_rng(seed)
    for name, (b, hq, hk, s, d, dt) in SHAPES.items():
        q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   .to("cuda", getattr(torch, dt))
                   for sh in ((b, hq, s, d), (b, hk, s, d), (b, hk, s, d)))
        call = (lambda: fa.flash_attention(q, k, v, causal=True,
                                           kv_len=KV_LEN))
        h = hashlib.sha256(call().float().cpu().numpy().tobytes())
        out[f"{name}_hash"] = h.hexdigest()[:16]
        out[f"{name}_ms"] = time_ms(call, 20)
    return out


if __name__ == "__main__":
    sys.exit(abba.main(worker, __doc__, __file__))
