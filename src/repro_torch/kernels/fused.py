"""pdist_rankeval: the planner's stage in one launch.

Port of ``repro/kernels/fused.py`` (``pdist_rankeval_pallas``).  For
queries ``q`` (B, d) and pivots ``piv`` (G, d): dq = sqrt(sql2) as
(B, G) f32, then the rank model at dq - rg and dq + rg as (G, B) int32.
On a CUDA tensor it launches ``csrc/fused.cu``; on a CPU tensor it runs
:func:`pdist_rankeval_plain`.  Both share their arithmetic with the
staged ``pdist`` -> sqrt -> ``rankeval`` chain of the same lane, so the
fused and staged plans agree bit for bit.  A CUDA launch takes a tile
of ``bb`` queries x ``bg`` groups a block (each 8 or 16),
``STATIC_TILES`` by default; no output depends on it.
"""
from __future__ import annotations

import torch

from . import _cuda
from .pdist import check_operands, gram_sq_plain
from .rankeval import rank_math_plain

STATIC_TILES = {"bg": 8, "bb": 8}


def tile_args(tiles: dict | None = None) -> tuple:
    """The tile ints a ``pdist_rankeval`` launch takes last, in their
    order: (bb, bg); ``STATIC_TILES`` if None."""
    t = tiles or STATIC_TILES
    return t["bb"], t["bg"]


def pdist_rankeval_plain(q, piv, coef, lo, hi, n, rg, n_rings: int):
    dq = torch.sqrt(gram_sq_plain(q.to(torch.float32),
                                  piv.to(torch.float32)))
    rg = rg.to(torch.float32)[:, None]
    rank_lo, _ = rank_math_plain((dq - rg).T, coef, lo, hi, n, n_rings)
    rank_hi, _ = rank_math_plain((dq + rg).T, coef, lo, hi, n, n_rings)
    return dq, rank_lo, rank_hi


def pdist_rankeval_cuda(q, piv, coef, lo, hi, n, rg, n_rings: int,
                        tiles: dict | None = None):
    B, d = q.shape
    G, n_coef = coef.shape
    if piv.shape != (G, d) or rg.shape != (B,) or lo.shape != (G,) \
            or hi.shape != (G,) or n.shape != (G,):
        raise ValueError("pdist_rankeval operand shapes do not match")
    # three allocations: one viewed as the three outputs (unbind, then an
    # f32 view) costs the host as much (chip_smoke's wrapper breakdown)
    dq = torch.empty(B, G, dtype=torch.float32, device=q.device)
    rank_lo = torch.empty(G, B, dtype=torch.int32, device=q.device)
    rank_hi = torch.empty_like(rank_lo)
    _cuda.launch("pdist_rankeval", q.data_ptr(), piv.data_ptr(),
                 coef.data_ptr(), lo.data_ptr(), hi.data_ptr(), n.data_ptr(),
                 rg.data_ptr(), dq.data_ptr(), rank_lo.data_ptr(),
                 rank_hi.data_ptr(), B, G, d, n_coef, n_rings,
                 *tile_args(tiles), device=q.device)
    return dq, rank_lo, rank_hi


def pdist_rankeval(q, piv, coef, lo, hi, n, rg, n_rings: int = 20,
                   tiles: dict | None = None):
    """(dq (B, G) f32, rank_lo (G, B) int32, rank_hi (G, B) int32);
    ``tiles``: the CUDA launch's."""
    if check_operands(q, piv, coef, lo, hi, n, rg).type == "cuda":
        return pdist_rankeval_cuda(q, piv, coef, lo, hi, n, rg, n_rings,
                                   tiles)
    return pdist_rankeval_plain(q, piv, coef, lo, hi, n, rg, n_rings)
