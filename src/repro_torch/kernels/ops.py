"""Public wrappers around the kernel pipeline.

Port of ``repro/kernels/ops.py``, with the reference's return contracts:

* ``pdist(q, p)`` -> (nq, np) f32 squared L2;
* ``rankeval(x, coef, lo, hi, n)`` -> (rank, rid), (G, B) int32;
* ``range_filter(q, p, r)`` -> (uint8 mask (nq, np), int32 counts per
  (query, 128-point tile));
* ``pdist_rankeval(q, piv, coef, lo, hi, n, rg)`` -> (dq (B, G) f32,
  rank_lo (G, B) int32, rank_hi (G, B) int32).

The wrappers cast to contiguous f32 and hand off to the kernel modules,
where the tensor's device picks the CUDA kernel or its plain version.
The CUDA kernels mask their ragged edges themselves, so only
``range_filter`` pads: its points grow to whole count tiles with the
finite far row ``FAR`` (the reference pads with +inf, whose Gram cells
are NaN; a far row's are +inf, which no ball holds), and the mask is
sliced back.
"""
from __future__ import annotations

import torch

from . import fused as _fused
from . import pdist as _pdist
from . import range_filter as _range_filter
from . import rankeval as _rankeval
from .dispatch import fused_plan_enabled

FAR = 1e30      # padding-row coordinate: outside every ball, finite


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def pdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(nq, np) f32 squared L2 distances."""
    return _pdist.pdist(_f32(q), _f32(p))


def rankeval(x, coef, lo, hi, n, n_rings: int = 20):
    """Batched rank-model eval (G groups x B values) + ring ids."""
    return _rankeval.rankeval(_f32(x), _f32(coef), _f32(lo), _f32(hi),
                              _f32(n), n_rings)


def range_filter(q: torch.Tensor, p: torch.Tensor, r: torch.Tensor):
    """Fused L2-ball membership for batched range queries with radii
    ``r`` (nq,): (mask (nq, np) uint8, counts (nq, ceil(np/128)) int32)."""
    q, p, r = _f32(q), _f32(p), _f32(r)
    npts = p.shape[0]
    pad = (-npts) % _range_filter.TILE
    if pad:
        p = torch.cat([p, torch.full((pad, p.shape[1]), FAR,
                                     dtype=torch.float32, device=p.device)])
    mask, cnt = _range_filter.range_filter(q, p, r * r)
    return mask[:, :npts], cnt


def pdist_rankeval(q, piv, coef, lo, hi, n, rg, n_rings: int = 20):
    """Fused plan stage: query->pivot L2 distances + rank eval at the
    widened-radius boundaries dq -/+ rg, one launch; bit-identical to
    the staged ``sqrt(pdist)`` + ``rankeval(cat(dq-rg, dq+rg))`` chain
    of the same device."""
    return _fused.pdist_rankeval(_f32(q), _f32(piv), _f32(coef), _f32(lo),
                                 _f32(hi), _f32(n), _f32(rg), n_rings)


__all__ = ["pdist", "rankeval", "range_filter", "pdist_rankeval",
           "fused_plan_enabled", "FAR"]
