"""Gradient compression: int8 with stochastic rounding.

Port of ``repro/train/compress.py`` (``compress.py:1-34``): every
gradient leaf is quantized to int8 (per-tensor scale, stochastic
rounding) and dequantized, the numerical effect of a compressed
all-reduce.  Stochastic rounding keeps the compression unbiased:
E[q] = g.  :func:`compress_leaf` takes the uniforms as an argument, so
the same rounding can be fed any source of them (a test feeds the ones
``jax.random.uniform`` draws for the reference's split keys);
:func:`int8_compress_decompress` draws them from a ``torch.Generator``.
"""
from __future__ import annotations

import torch


def compress_leaf(g: torch.Tensor, u: torch.Tensor,
                  amax: torch.Tensor | None = None) -> torch.Tensor:
    """One leaf: ``u`` holds f32 uniforms in [0, 1) of ``g``'s shape.
    ``amax``: the whole leaf's max |g| where ``g`` is one rank's shard
    of it (ZeRO-1), else ``g``'s own."""
    gf = g.to(torch.float32)
    if amax is None:
        amax = torch.amax(torch.abs(gf))
    scale = amax / 127.0 + 1e-20
    x = gf / scale
    lo = torch.floor(x)
    frac = x - lo
    up = u < frac
    q = torch.clamp(lo + up.to(torch.float32), -127, 127)
    return (q * scale).to(g.dtype)


@torch.no_grad()
def int8_compress_decompress(grads, generator: torch.Generator):
    """Quantize every leaf of ``grads`` (nested dicts) to int8 and back,
    in place, and return ``grads``.  The uniforms are drawn from
    ``generator`` (on the leaves' device) one leaf at a time, in
    sorted-key order, so no second copy of the gradients is made."""
    if isinstance(grads, dict):
        for k in sorted(grads):
            int8_compress_decompress(grads[k], generator)
        return grads
    u = torch.rand(grads.shape, generator=generator, dtype=torch.float32,
                   device=grads.device)
    grads.copy_(compress_leaf(grads, u))
    return grads
