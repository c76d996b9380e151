"""pdist (sql2): squared L2 distances by the Gram trick.

Port of ``repro/kernels/pdist.py`` (``pdist_pallas``, body
``_pdist_l2_kernel``); the l1/linf bodies are not ported yet.  On a CUDA
tensor :func:`pdist` launches ``csrc/pdist.cu``; on a CPU tensor it runs
:func:`pdist_plain`, which repeats the kernel's f32 operation order
(``csrc/gram.cuh``): every sum taken over d from k = 0 upwards, every
product and sum rounded on its own, then ``(qn + pn) - 2g`` clamped at 0
in a way that keeps a NaN.
"""
from __future__ import annotations

import torch

from . import _cuda


def sq_norm_plain(x: torch.Tensor) -> torch.Tensor:
    """(n,) f32 squared row norms, summed over d in order."""
    s = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        s = s + x[:, k] * x[:, k]
    return s


def gram_sq_plain(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(nq, np) f32 squared distances in ``gram.cuh``'s operation order."""
    qn = sq_norm_plain(q)
    pn = sq_norm_plain(p)
    g = torch.zeros(q.shape[0], p.shape[0], dtype=torch.float32,
                    device=q.device)
    for k in range(q.shape[1]):
        g = g + q[:, k, None] * p[None, :, k]
    v = (qn[:, None] + pn[None, :]) - 2.0 * g
    return torch.where(v < 0.0, torch.zeros_like(v), v)


def pdist_plain(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return gram_sq_plain(q.to(torch.float32), p.to(torch.float32))


def check_operands(*ts: torch.Tensor) -> torch.device:
    """The common device of ``ts``; raises on mixed devices, non-f32 or
    non-contiguous CUDA operands (the kernels take dense f32 only)."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if dev.type == "cuda" and (t.dtype != torch.float32
                                   or not t.is_contiguous()):
            raise ValueError("CUDA kernels take contiguous float32 "
                             f"operands, got {t.dtype}")
    return dev


def pdist_cuda(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    nq, d = q.shape
    npts, d2 = p.shape
    if d != d2:
        raise ValueError(f"feature widths differ: {d} vs {d2}")
    out = torch.empty(nq, npts, dtype=torch.float32, device=q.device)
    _cuda.launch("pdist", q.data_ptr(), p.data_ptr(), out.data_ptr(), nq,
                 npts, d)
    return out


def pdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(nq, np) f32 squared L2 distances between rows of q and p."""
    if check_operands(q, p).type == "cuda":
        return pdist_cuda(q, p)
    return pdist_plain(q, p)
