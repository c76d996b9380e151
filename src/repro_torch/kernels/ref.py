"""Torch oracles for the ported kernels (the correctness contract).

Port of ``repro/kernels/ref.py``: each function computes the same math
as its kernel with no tiling and a deliberately different formulation
(direct differences for the distance, the explicit T_k recurrence for
the rank model), so agreement with a kernel is evidence, not identity.
"""
from __future__ import annotations

import torch


def pdist_ref(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared L2 by direct differences, f32."""
    d = q.to(torch.float32)[:, None, :] - p.to(torch.float32)[None, :, :]
    return torch.sum(d * d, dim=-1)


def rankeval_ref(x, coef, lo, hi, n, n_rings: int = 20):
    """(rank, rid): vectorized Chebyshev eval + ring id, f32 math."""
    x = x.to(torch.float32)
    lo = lo.to(torch.float32)[:, None]
    hi = hi.to(torch.float32)[:, None]
    nn = n.to(torch.float32)[:, None]
    t = torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-30) * 2.0 - 1.0,
                    -1.0, 1.0)
    acc = torch.zeros_like(t)
    t_km1 = torch.ones_like(t)
    t_k = t
    for k in range(coef.shape[1]):
        term = coef[:, k].to(torch.float32)[:, None]
        if k == 0:
            acc = acc + term * t_km1
        elif k == 1:
            acc = acc + term * t_k
        else:
            t_km1, t_k = t_k, 2.0 * t * t_k - t_km1
            acc = acc + term * t_k
    rank = torch.minimum(torch.clamp(torch.round(acc), min=0.0),
                         torch.clamp(nn - 1.0, min=0.0))
    width = torch.clamp(torch.ceil(nn / float(n_rings)), min=1.0)
    rid = torch.clamp(torch.floor(rank / width), 0.0, float(n_rings - 1))
    return rank.to(torch.int32), rid.to(torch.int32)


def range_filter_ref(q, p, r, bp: int = 128):
    """(uint8 mask, int32 counts per ``bp``-point tile) for radii ``r``."""
    hit = pdist_ref(q, p) <= (r * r).to(torch.float32)[:, None]
    nq, npts = hit.shape
    hp = torch.nn.functional.pad(hit, (0, (-npts) % bp))
    cnt = hp.reshape(nq, -1, bp).sum(dim=-1, dtype=torch.int32)
    return hit.to(torch.uint8), cnt
