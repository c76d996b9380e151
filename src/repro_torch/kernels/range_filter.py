"""range_filter: squared L2 distance fused with the per-query ball test.

Port of ``repro/kernels/range_filter.py`` (``range_filter_pallas``).  On
a CUDA tensor :func:`range_filter` launches ``csrc/range_filter.cu``; on
a CPU tensor it runs :func:`range_filter_plain`, whose distances are
``pdist.gram_sq_plain`` (the kernel's operation order).  Returns a uint8
mask (nq, np) and int32 hit counts per (query, ``TILE``-point tile).
Points may be f32, bf16 or f16 (entry points ``range_filter``,
``range_filter_bf16`` and ``range_filter_f16`` of one template, which
convert each coordinate exactly to f32 as they load it); queries and
radii are f32.
"""
from __future__ import annotations

import torch

from . import _cuda
from .pdist import POINT_TYPES, check_operands, gram_sq_plain

TILE = 128      # points per count tile (the kernel's block width)


def range_filter_plain(q: torch.Tensor, p: torch.Tensor, r2: torch.Tensor):
    """``r2`` (nq,) f32 squared radii.  A ragged last tile counts only
    its real points."""
    hit = gram_sq_plain(q.to(torch.float32), p.to(torch.float32)) \
        <= r2[:, None]
    nq, npts = hit.shape
    pad = (-npts) % TILE
    hp = torch.nn.functional.pad(hit, (0, pad))
    cnt = hp.reshape(nq, -1, TILE).sum(dim=-1, dtype=torch.int32)
    return hit.to(torch.uint8), cnt


def range_filter_cuda(q: torch.Tensor, p: torch.Tensor, r2: torch.Tensor):
    nq, d = q.shape
    npts, d2 = p.shape
    if d != d2 or r2.shape != (nq,):
        raise ValueError(f"shapes q {tuple(q.shape)}, p {tuple(p.shape)}, "
                         f"r2 {tuple(r2.shape)} do not match")
    mask = torch.empty(nq, npts, dtype=torch.uint8, device=q.device)
    cnt = torch.empty(nq, -(-npts // TILE), dtype=torch.int32,
                      device=q.device)
    _cuda.launch("range_filter" + POINT_TYPES[p.dtype], q.data_ptr(),
                 p.data_ptr(), r2.data_ptr(), mask.data_ptr(),
                 cnt.data_ptr(), nq, npts, d, device=q.device)
    return mask, cnt


def range_filter(q: torch.Tensor, p: torch.Tensor, r2: torch.Tensor):
    """(mask (nq, np) uint8, counts (nq, ceil(np / TILE)) int32) for the
    L2 balls d2(q_i, p_j) <= r2_i."""
    if check_operands(q, r2, points=p).type == "cuda":
        return range_filter_cuda(q, p, r2)
    return range_filter_plain(q, p, r2)
