"""pdist_rankeval: the planner's stage in one launch.

Port of ``repro/kernels/fused.py`` (``pdist_rankeval_pallas``).  For
queries ``q`` (B, d) and pivots ``piv`` (G, d): dq = sqrt(sql2) as
(B, G) f32, then the rank model at dq - rg and dq + rg as (G, B) int32.
On a CUDA tensor it launches ``csrc/fused.cu``; on a CPU tensor it runs
:func:`pdist_rankeval_plain`.  Both share their arithmetic with the
staged ``pdist`` -> sqrt -> ``rankeval`` chain of the same lane, so the
fused and staged plans agree bit for bit.
"""
from __future__ import annotations

import torch

from . import _cuda
from .pdist import check_operands, gram_sq_plain
from .rankeval import rank_math_plain


def pdist_rankeval_plain(q, piv, coef, lo, hi, n, rg, n_rings: int):
    dq = torch.sqrt(gram_sq_plain(q.to(torch.float32),
                                  piv.to(torch.float32)))
    rg = rg.to(torch.float32)[:, None]
    rank_lo, _ = rank_math_plain((dq - rg).T, coef, lo, hi, n, n_rings)
    rank_hi, _ = rank_math_plain((dq + rg).T, coef, lo, hi, n, n_rings)
    return dq, rank_lo, rank_hi


def pdist_rankeval_cuda(q, piv, coef, lo, hi, n, rg, n_rings: int):
    B, d = q.shape
    G, n_coef = coef.shape
    if piv.shape != (G, d) or rg.shape != (B,) or lo.shape != (G,) \
            or hi.shape != (G,) or n.shape != (G,):
        raise ValueError("pdist_rankeval operand shapes do not match")
    dq = torch.empty(B, G, dtype=torch.float32, device=q.device)
    rank_lo = torch.empty(G, B, dtype=torch.int32, device=q.device)
    rank_hi = torch.empty_like(rank_lo)
    _cuda.launch("pdist_rankeval", q.data_ptr(), piv.data_ptr(),
                 coef.data_ptr(), lo.data_ptr(), hi.data_ptr(), n.data_ptr(),
                 rg.data_ptr(), dq.data_ptr(), rank_lo.data_ptr(),
                 rank_hi.data_ptr(), B, G, d, n_coef, n_rings)
    return dq, rank_lo, rank_hi


def pdist_rankeval(q, piv, coef, lo, hi, n, rg, n_rings: int = 20):
    """(dq (B, G) f32, rank_lo (G, B) int32, rank_hi (G, B) int32)."""
    if check_operands(q, piv, coef, lo, hi, n, rg).type == "cuda":
        return pdist_rankeval_cuda(q, piv, coef, lo, hi, n, rg, n_rings)
    return pdist_rankeval_plain(q, piv, coef, lo, hi, n, rg, n_rings)
