#!/usr/bin/env python3
"""Emulate how the flash kernel's tensor-core body accumulates Q K^T, and
hold each emulation, beside the kernel, to chip_smoke's flash_verdict at
a family's flash shape, on one CUDA card.

    python3 tools/flash_chain_emulation.py [--seed 0] [--internlm2]

For kimi-k2 (1 of 61 layers, D 112) and zamba2 (whole, D 80) it serves
the family in bf16 at full width (``chip_smoke.family_serve``) and takes
the first q, k, v the prefill gave ``flash_attention`` at that head
width.  With ``--internlm2`` it takes instead the first q, k, v that
chip_smoke's ``fsdp:`` training gives the kernel at D 128 (layer 0 of
internlm2-20b at full width, the first microbatch's row): (a)'s, at 8
layers and rank 0's row of a four-card batch, and (c)'s, at 4 layers
on one card.  An emulation repeats the body's arithmetic in torch on the card:
each k-step's 16 exact bf16 products summed and rounded into an f32
accumulator toward zero (the tensor core's rounding), either as one
chain over every k-step ("one chain") or as one chain per 64-column box
summed once with round-to-nearest ("box chains"); then the scale by
log2(e)/sqrt(D) rounded once to f32, exp2 against the row maximum, P as
bf16 hi + lo, P V in f64, the output rounded to bf16.  Each line gives
``flash_verdict``'s readings against the plain version and the f64
answer (the bar widened by ``score_rounding``) and the share of outputs
equal to the kernel's bit for bit.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FAMILIES = (("kimi-k2-1t-a32b", 1, 2, 16, 112),
            ("zamba2-2.7b", None, 4, 32, 80))
PROMPT = 2000


def toward_zero(x64):
    """f64 -> f32 rounded toward zero."""
    import torch
    x = x64.float()
    over = x.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x, torch.zeros_like(x)), x)


def emulate(q, k, v, kv_len, chains):
    """The body's output with Q K^T as ``chains`` (lists of k-steps),
    each rounded toward zero step by step, summed round-to-nearest."""
    import torch
    b_, hq, s, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    scale2 = torch.tensor(math.log2(math.e) / math.sqrt(d),
                          dtype=torch.float32, device=q.device)
    pos = torch.arange(s, device=q.device)
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] < kv_len)
    out = torch.empty_like(q)
    for b in range(b_):
        for h in range(hk):
            qg = q[b, h * g:(h + 1) * g].double()
            kg, vg = k[b, h].double(), v[b, h].double()
            raw = None
            for steps in chains:
                part = torch.zeros(g, s, s, dtype=torch.float32,
                                   device=q.device)
                for j in steps:
                    part = toward_zero(part.double() + qg[..., 16 * j:16 * j + 16]
                                       @ kg[:, 16 * j:16 * j + 16].T)
                raw = part if raw is None else raw + part
            sc = torch.where(ok, raw, torch.tensor(-1e30, device=q.device))
            sc = sc * scale2
            p = torch.exp2(sc - sc.amax(-1, keepdim=True))
            hi = p.bfloat16()
            lo = (p - hi.float()).bfloat16()
            o = (hi.double() @ vg + lo.double() @ vg) / p.double().sum(-1, keepdim=True)
            out[b, h * g:(h + 1) * g] = o.to(torch.bfloat16)
            del raw, sc, p, hi, lo, o
    return out


def training_operands(cs, seed: int, layers: int, world: int):
    """The first q, k, v chip_smoke's fsdp: training gives the kernel
    with internlm2-20b at ``layers`` layers over ``world`` ranks: layer 0
    on rank 0's first microbatch row of step 0."""
    import torch
    from repro_torch.data.pipeline import DataShard, _batch_for_step
    from repro_torch.models import zoo
    cfg = cs.fsdp_cfg(world, False, layers)
    params = cs.fsdp_params(cfg, seed, cs.DEVICE, lazy=False)
    batch = _batch_for_step(0, DataShard(0, world), cfg.vocab,
                            cs.FSDP_MICRO * world, cs.TRAIN_SEQ)
    row = {k: torch.from_numpy(v[:1]).to(cs.DEVICE) for k, v in batch.items()}
    (tally, first), spying = cs.family_flash_spy()
    with spying, torch.no_grad():
        zoo.loss_fn(cfg)(params, row)
    del params
    key = next(iter(tally))
    return key, first[key]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--internlm2", action="store_true",
                    help="fsdp:'s D 128 training operands, not the "
                         "families' prefills")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_chain_emulation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    cases = ([("internlm2-20b (a)", 8, 4, 128), ("internlm2-20b (c)", 4, 1,
                                                 128)]
             if args.internlm2 else FAMILIES)
    for case in cases:
        if args.internlm2:
            name, layers, world, d = case
            key, (q, k, v) = training_operands(cs, args.seed, layers, world)
        else:
            name, layers, bsz, steps, d = case
            _, tally, first = cs.family_serve(
                name, layers, bsz, PROMPT, steps, args.seed,
                cs.flash_expected(name, layers))
            key = next(kk for kk in tally if kk[0][3] == d)
            q, k, v = first[key]
            del first, tally
        _, _, causal, kv_len, window = key
        assert causal and window is None, key
        got = fa.flash_attention(q, k, v, causal=True, kv_len=kv_len)
        plain, exact = cs.flash_refs(q, k, v, kv_len)
        # the training rows are held at the strict bar (shift 0)
        shift = 0.0 if args.internlm2 else cs.score_rounding(
            q[:, :, :PROMPT], k, v, kv_len, True, None)[0]
        ok, _, readings = cs.flash_verdict(got, plain, exact, shift)
        print(f"emulation: {name} D {d} kernel: passes={ok}; {readings}",
              flush=True)
        ks = d // 16
        for label, chains in (("one chain", [range(ks)]),
                              ("box chains", [range(min(4, ks)),
                                              range(4, ks)])):
            e = emulate(q, k, v, kv_len, chains)
            ok, _, readings = cs.flash_verdict(e, plain, exact, shift)
            same = float((e == got).double().mean())
            print(f"emulation: {name} D {d} {label}: passes={ok}; "
                  f"{readings}; equal to the kernel's bits at {same:.6f} of "
                  f"the outputs", flush=True)
            del e
        del q, k, v, got, plain, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
