"""pdist: pairwise distances, squared L2 (sql2), L1 and L-infinity.

Port of ``repro/kernels/pdist.py`` (``pdist_pallas`` with its three
bodies ``_pdist_l2_kernel``, ``_pdist_l1_kernel`` and
``_pdist_linf_kernel``).  On a CUDA tensor :func:`pdist` launches
``csrc/pdist.cu`` (sql2) or ``csrc/pdist_lp.cu`` (l1, linf); on a CPU
tensor it runs the plain version, which repeats its kernel's f32
operation order:

* sql2 (``csrc/gram.cuh``): every sum taken over d from k = 0 upwards,
  every product and sum rounded on its own, then ``(qn + pn) - 2g``
  clamped at 0 in a way that keeps a NaN;
* l1: ``|q_k - p_k|`` summed from k = 0 upwards;
* linf: the running max from 0 over k = 0 upwards, taking a NaN operand
  (as ``jnp.max`` does).

:func:`pdist_grouped` (l1, linf) takes G groups at once, q (G, nq, d)
against p (G, np, d), in one launch of the same kernels: the device
builder's per-cluster pivot columns.

The sql2 kernel also reads bf16 or f16 points natively (the snapshot's
reduced-precision filter plane): entry points ``pdist_sql2_bf16`` and
``pdist_sql2_f16`` of the same template convert each coordinate exactly
to f32 as they load it, so the arithmetic and the result equal the
plain version's, which upcasts first.  Queries stay f32; l1 and linf
take f32 points only.

Each CUDA launch takes a tile (``stream.cuh``): ``bp`` points a block
(128, 256, 512 or 1,024) and ``bq`` query rows a chunk (at most bp / 4).
``STATIC_TILES`` is the tile every launch took before it was a
parameter; ``ops`` passes the tuning table's (``kernels/autotune.py``)
where it has one.  No output depends on the tile.
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


def _diff_abs(q: torch.Tensor, p: torch.Tensor, k: int) -> torch.Tensor:
    return torch.abs(q[..., :, k, None] - p[..., None, :, k])


def _lp_zeros(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(*q.shape[:-1], p.shape[-2], dtype=torch.float32,
                       device=q.device)


def pdist_l1_plain(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(nq, np) f32 L1 distances in ``pdist_lp.cu``'s operation order;
    (G, nq, np) for groups q (G, nq, d) and p (G, np, d)."""
    q, p = q.to(torch.float32), p.to(torch.float32)
    s = _lp_zeros(q, p)
    for k in range(q.shape[-1]):
        s = s + _diff_abs(q, p, k)
    return s


def pdist_linf_plain(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(nq, np) f32 L-infinity distances in ``pdist_lp.cu``'s order
    (the max takes ``a`` when ``a > m`` or ``a`` is NaN); (G, nq, np)
    for groups q (G, nq, d) and p (G, np, d)."""
    q, p = q.to(torch.float32), p.to(torch.float32)
    m = _lp_zeros(q, p)
    for k in range(q.shape[-1]):
        a = _diff_abs(q, p, k)
        m = torch.where((a > m) | torch.isnan(a), a, m)
    return m


# the streaming kernels' static tile (autotune's names; qb, the
# reference's query sub-block, is pinned to bq)
STATIC_TILES = {"bq": 64, "bp": 512, "qb": 64}


def tile_args(tiles: dict | None = None) -> tuple:
    """The tile ints a streaming launch (``pdist*``, ``range_filter*``)
    takes last, in their order: (bp, bq); ``STATIC_TILES`` if None."""
    t = tiles or STATIC_TILES
    return t["bp"], t["bq"]

# metric -> (CUDA kernel name, plain version)
METRICS = {"sql2": ("pdist", pdist_plain),
           "l1": ("pdist_l1", pdist_l1_plain),
           "linf": ("pdist_linf", pdist_linf_plain)}
# the metrics whose kernels take groups (pdist_grouped)
GROUPED = ("l1", "linf")


# point type -> suffix of the kernel name whose entry point reads it
# (the sql2 pdist and range_filter bodies; every other operand is f32)
POINT_TYPES = {torch.float32: "", torch.bfloat16: "_bf16",
               torch.float16: "_f16"}


def check_operands(*ts: torch.Tensor,
                   points: torch.Tensor | None = None) -> torch.device:
    """The common device of ``ts`` and ``points``; raises on mixed
    devices and on CUDA operands that are not contiguous float32, where
    ``points`` may also be bfloat16 or float16 (a body that reads
    2-byte points)."""
    dev = ts[0].device
    for t in ts + (() if points is None else (points,)):
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        types = POINT_TYPES if t is points else (torch.float32,)
        if dev.type == "cuda" and (t.dtype not in types
                                   or not t.is_contiguous()):
            raise ValueError(
                "CUDA kernels take contiguous operands of "
                f"{', '.join(map(str, types))}, got {t.dtype}")
    return dev


def pdist_cuda(q: torch.Tensor, p: torch.Tensor, kernel: str = "pdist",
               tiles: dict | None = None) -> torch.Tensor:
    """One launch at ``tiles`` (``STATIC_TILES`` if None): (nq, np) from
    q (nq, d) and p (np, d); the l1 / linf kernels also take groups, q
    (G, nq, d) and p (G, np, d) -> (G, nq, np).  The sql2 kernel's entry
    point is the one for p's type."""
    *gq, nq, d = q.shape
    *gp, npts, d2 = p.shape
    if d != d2:
        raise ValueError(f"feature widths differ: {d} vs {d2}")
    if gq != gp or len(gq) > (0 if kernel == "pdist" else 1):
        raise ValueError(f"{kernel}: groups of q {tuple(q.shape)} and p "
                         f"{tuple(p.shape)} do not match")
    out = torch.empty(*gq, nq, npts, dtype=torch.float32, device=q.device)
    groups = () if kernel == "pdist" else (gq[0] if gq else 1,)
    if kernel == "pdist":
        kernel += POINT_TYPES[p.dtype]
    _cuda.launch(kernel, q.data_ptr(), p.data_ptr(), out.data_ptr(),
                 *groups, nq, npts, d, *tile_args(tiles), device=q.device)
    return out


def pdist(q: torch.Tensor, p: torch.Tensor, metric: str = "sql2",
          tiles: dict | None = None) -> torch.Tensor:
    """(nq, np) f32 distances between rows of q and p: squared L2
    (``sql2``; p may be bf16 or f16), L1 or L-infinity.  ``tiles``: the
    CUDA launch's (``STATIC_TILES`` if None); the plain version has
    none."""
    if metric not in METRICS:
        raise ValueError(f"pdist: unknown metric {metric!r}")
    kernel, plain = METRICS[metric]
    dev = check_operands(q, points=p) if metric == "sql2" \
        else check_operands(q, p)
    if dev.type == "cuda":
        return pdist_cuda(q, p, kernel, tiles)
    return plain(q, p)


def pdist_grouped(q: torch.Tensor, p: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """(G, nq, np) f32 distances between the rows of q[g] and p[g] for
    every group g, q (G, nq, d) and p (G, np, d): L1 or L-infinity only.
    On CUDA tensors one launch for all groups, at the static tile."""
    if metric not in GROUPED:
        raise ValueError(f"pdist_grouped: metric {metric!r} is not one of "
                         f"{GROUPED}")
    if q.dim() != 3 or p.dim() != 3 or q.shape[0] != p.shape[0] \
            or q.shape[2] != p.shape[2]:
        raise ValueError(f"pdist_grouped: q {tuple(q.shape)} and p "
                         f"{tuple(p.shape)} are not (G, nq, d), (G, np, d)")
    kernel, plain = METRICS[metric]
    if check_operands(q, p).type == "cuda":
        return pdist_cuda(q, p, kernel)
    return plain(q, p)
