"""rankeval: Chebyshev rank-model evaluation + ring id per group.

Port of ``repro/kernels/rankeval.py`` (``rankeval_pallas`` with
``rank_math``).  On a CUDA tensor :func:`rankeval` launches
``csrc/rankeval.cu``; on a CPU tensor it runs :func:`rank_math_plain`,
which repeats ``csrc/rank_math.cuh`` step for step in f32.  The CUDA
``rank_math`` is one device function shared with ``csrc/fused.cu`` and
``rank_math_plain`` is shared the same way with ``fused.py``: the
bit-identity of the fused and staged plans rests on that sharing.  A CUDA launch takes
``bb`` values a block (512, 1,024 or 2,048; a block is one group's),
``STATIC_TILES`` by default; no output depends on it.
"""
from __future__ import annotations

import torch

from . import _cuda
from .pdist import check_operands

STATIC_TILES = {"bb": 1024}


def tile_args(tiles: dict | None = None) -> tuple:
    """The tile ints a ``rankeval`` launch takes last: (bb,);
    ``STATIC_TILES`` if None."""
    return ((tiles or STATIC_TILES)["bb"],)


def rank_math_plain(x: torch.Tensor, coef: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, n: torch.Tensor, n_rings: int):
    """(rank, rid) int32 for ``x`` (G, B) f32 against the group tables
    ``coef`` (G, C) and ``lo``/``hi``/``n`` (G,)."""
    x = x.to(torch.float32)
    lo = lo.to(torch.float32)[:, None]
    hi = hi.to(torch.float32)[:, None]
    n = n.to(torch.float32)[:, None]
    coef = coef.to(torch.float32)
    den = torch.clamp(hi - lo, min=1e-30)
    t = ((x - lo) / den) * 2.0 - 1.0
    t = torch.clamp(t, -1.0, 1.0)
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(coef.shape[1] - 1, 0, -1):
        b1, b2 = (coef[:, k, None] + t2 * b1) - b2, b1
    r = (coef[:, 0, None] + t * b1) - b2
    hi_rank = torch.clamp(n - 1.0, min=0.0)
    rank = torch.minimum(torch.clamp(torch.round(r), min=0.0), hi_rank)
    width = torch.ceil(n / float(n_rings))
    rid = torch.clamp(torch.floor(rank / torch.clamp(width, min=1.0)),
                      0.0, float(n_rings - 1))
    return _int32(rank), _int32(rid)


def _int32(v: torch.Tensor) -> torch.Tensor:
    """int32 of the integer-valued f32 ``v``, a NaN as 0: what the
    kernels' ``cvt.rzi.s32.f32`` and XLA's conversion give (a bare cast
    gives INT_MIN on x86).  Every clip above keeps a NaN, as the
    reference's ``jnp.clip`` does, so a NaN distance ranks 0, ring 0."""
    return torch.where(torch.isnan(v), 0.0, v).to(torch.int32)


def rankeval_cuda(x, coef, lo, hi, n, n_rings: int,
                  tiles: dict | None = None):
    g, b = x.shape
    if coef.shape[0] != g or lo.shape != (g,) or hi.shape != (g,) \
            or n.shape != (g,):
        raise ValueError("group tables do not match x's G")
    rank = torch.empty(g, b, dtype=torch.int32, device=x.device)
    rid = torch.empty_like(rank)
    _cuda.launch("rankeval", x.data_ptr(), coef.data_ptr(), lo.data_ptr(),
                 hi.data_ptr(), n.data_ptr(), rank.data_ptr(),
                 rid.data_ptr(), g, b, coef.shape[1], n_rings,
                 *tile_args(tiles), device=x.device)
    return rank, rid


def rankeval(x, coef, lo, hi, n, n_rings: int = 20,
             tiles: dict | None = None):
    """(rank, rid), both (G, B) int32; ``tiles``: the CUDA launch's."""
    if check_operands(x, coef, lo, hi, n).type == "cuda":
        return rankeval_cuda(x, coef, lo, hi, n, n_rings, tiles)
    return rank_math_plain(x, coef, lo, hi, n, n_rings)
