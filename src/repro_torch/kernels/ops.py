"""Public wrappers around the kernel pipeline.

Port of ``repro/kernels/ops.py``, with the reference's return contracts:

* ``pdist(q, p, metric="sql2")`` -> (nq, np) f32 squared L2, or L1 /
  L-infinity for ``metric="l1"`` / ``"linf"``;
* ``pdist_grouped(q, p, metric)`` -> (G, nq, np) f32 L1 / L-infinity
  for G groups at once (no reference counterpart: the device builder's
  per-cluster launch, ``pdist`` of each group);
* ``rankeval(x, coef, lo, hi, n)`` -> (rank, rid), (G, B) int32;
* ``range_filter(q, p, r)`` -> (uint8 mask (nq, np), int32 counts per
  (query, 128-point tile));
* ``pdist_rankeval(q, piv, coef, lo, hi, n, rg)`` -> (dq (B, G) f32,
  rank_lo (G, B) int32, rank_hi (G, B) int32);
* ``flash_attention(q, k, v, causal)`` -> (B, Hq, Sq, D) in q's dtype.

The wrappers cast to contiguous f32 and hand off to the kernel modules,
where the tensor's device picks the CUDA kernel or its plain version.
One exception: a bf16 or f16 point operand of ``pdist`` (sql2) and
``range_filter`` (the snapshot's reduced-precision filter plane) passes
through uncast, to the entry points that read 2-byte points; an f32
copy of the plane would undo what the plane saves.
The CUDA kernels mask their ragged edges themselves, so only
``range_filter`` pads: its points grow to whole count tiles with the
far row ``FAR`` in the points' type (the reference pads with +inf,
whose Gram cells are NaN; an f32 or bf16 far row's are +inf, which no
finite ball holds; in f16, FAR is +inf itself), and the mask is sliced
back.  ``flash_attention`` pads Sq and Sk to whole 128-row
tiles, masks the padded keys with ``kv_len`` and slices the rows back,
as the reference's wrapper does.

Each wrapper counts its call in the observability registry, as the
reference's ``_count_launch`` does: ``kernels.<name>.launches`` and a
per-lane ``kernels.<name>.<lane>``, where the lane is ``cuda`` (the
hand-written kernel, one launch a call) or ``torch`` (the plain version
on a CPU tensor).  The count lands after the call returns, so on CUDA
tensors it equals ``_cuda.LAUNCHES``' tally of the same calls.  Under
a CUDA graph the count follows the launches that run, as
``_cuda.LAUNCHES`` does: a call made while ``_cuda.recording()`` is open
(the graph's warm-up and capture) lands in the recording's tally, and
:func:`count_replayed` counts the tally once per replay that ran it.
The reference counts a call under ``jit`` once, when it traces; the
port counts every launch the card runs.

A CUDA launch of ``pdist``, ``range_filter``, ``rankeval`` or
``pdist_rankeval`` takes its tile from the tuning table
(``kernels/autotune.py``, under ``REPRO_AUTOTUNE``) where it has one for
the card and the shape bucket, else the kernel's static tile;
``pdist_grouped`` and the plain versions on a CPU tensor read no table.
"""
from __future__ import annotations

import torch

from . import _cuda
from . import autotune
from . import flash_attention as _flash
from . import fused as _fused
from . import pdist as _pdist
from . import range_filter as _range_filter
from . import rankeval as _rankeval
from .dispatch import fused_plan_enabled
from .pdist import GROUPED
from ..obs import registry as _obs

FAR = 1e30      # padding-row coordinate: outside every ball, finite


def _count_launch(name: str, probe: torch.Tensor) -> None:
    """Per-kernel call counter (``kernels.<name>.launches``) plus its
    lane, ``cuda`` or ``torch`` by the operands' device; no-op and
    allocation-free with ``REPRO_OBS=off``."""
    tally = _cuda.current_recording()
    if tally is not None:       # whatever the mode: replays count by it
        tally.calls[name] = tally.calls.get(name, 0) + 1
        return
    if not _obs.enabled():
        return
    _obs.count(f"kernels.{name}.launches")
    _obs.count(f"kernels.{name}.{'cuda' if probe.is_cuda else 'torch'}")


def count_replayed(calls: dict, times: int) -> None:
    """Count the wrapper calls a recording tallied (``calls``: name ->
    calls a replay makes) ``times`` times, on the ``cuda`` lane: the
    calls a CUDA graph's replays ran."""
    if not _obs.enabled() or times <= 0:
        return
    for name, n in calls.items():
        _obs.count(f"kernels.{name}.launches", n * times)
        _obs.count(f"kernels.{name}.cuda", n * times)


def _tiles(kernel: str, metric: str | None, dims: dict,
           probe: torch.Tensor) -> dict | None:
    """The tuning table's tile for a CUDA launch (None: the kernel's
    static tile); a CPU tensor's plain version has none."""
    if not probe.is_cuda:
        return None
    return autotune.tiles_for(kernel, metric, dims, probe.device)


def far_rows(n: int, like: torch.Tensor) -> torch.Tensor:
    """(n, d) padding rows at ``FAR`` in ``like``'s type and device
    (rounded from f32: +inf in f16, whose largest value is 65,504)."""
    return torch.full((n, like.shape[1]), FAR, dtype=torch.float32,
                      device=like.device).to(like.dtype)


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32 and t.is_contiguous():
        return t                # no dispatch for what is already dense f32
    return t.to(torch.float32).contiguous()


def _points(p: torch.Tensor, metric: str = "sql2") -> torch.Tensor:
    """A point operand as the kernels take it: bf16 / f16 points stay
    in their type for the sql2 bodies, which read 2-byte points;
    anything else becomes dense f32."""
    if metric == "sql2" and p.dtype in (torch.bfloat16, torch.float16):
        return p.contiguous()
    return _f32(p)


def pdist(q: torch.Tensor, p: torch.Tensor,
          metric: str = "sql2") -> torch.Tensor:
    """(nq, np) f32 pairwise distances. metric: sql2 | l1 | linf; sql2
    returns squared distances (take ``torch.sqrt`` or square radii) and
    reads bf16 / f16 points as they are."""
    q, p = _f32(q), _points(p, metric)
    kernel = "pdist" + (_pdist.POINT_TYPES[p.dtype] if metric == "sql2"
                        else "")
    tiles = _tiles(kernel, metric, {"q": q.shape[0], "p": p.shape[0],
                                    "d": q.shape[1]}, q)
    out = _pdist.pdist(q, p, metric, tiles)
    _count_launch("pdist", q)
    return out


def pdist_grouped(q: torch.Tensor, p: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """(G, nq, np) f32 distances of q (G, nq, d) to p (G, np, d) within
    each group, ``pdist(q[g], p[g], metric)`` for every g in one launch.
    metric: l1 | linf (ValueError for any other)."""
    out = _pdist.pdist_grouped(_f32(q), _f32(p), metric)
    _count_launch("pdist_grouped", q)
    return out


def rankeval(x, coef, lo, hi, n, n_rings: int = 20):
    """Batched rank-model eval (G groups x B values) + ring ids."""
    x, coef = _f32(x), _f32(coef)
    tiles = _tiles("rankeval", None, {"g": x.shape[0], "b": x.shape[1],
                                      "c": coef.shape[1]}, x)
    out = _rankeval.rankeval(x, coef, _f32(lo), _f32(hi), _f32(n), n_rings,
                             tiles)
    _count_launch("rankeval", x)
    return out


def range_filter(q: torch.Tensor, p: torch.Tensor, r: torch.Tensor):
    """Fused L2-ball membership for batched range queries with radii
    ``r`` (nq,): (mask (nq, np) uint8, counts (nq, ceil(np/128)) int32).
    Points may be f32, bf16 or f16."""
    q, p, r = _f32(q), _points(p), _f32(r)
    npts = p.shape[0]
    pad = (-npts) % _range_filter.TILE
    if pad:
        p = torch.cat([p, far_rows(pad, p)])
    tiles = _tiles("range_filter" + _pdist.POINT_TYPES[p.dtype], "sql2",
                   {"q": q.shape[0], "p": p.shape[0], "d": q.shape[1]}, q)
    mask, cnt = _range_filter.range_filter(q, p, r * r, tiles)
    _count_launch("range_filter", q)
    return mask[:, :npts], cnt


def pdist_rankeval(q, piv, coef, lo, hi, n, rg, n_rings: int = 20):
    """Fused plan stage: query->pivot L2 distances + rank eval at the
    widened-radius boundaries dq -/+ rg, one launch; bit-identical to
    the staged ``sqrt(pdist)`` + ``rankeval(cat(dq-rg, dq+rg))`` chain
    of the same device."""
    q, coef = _f32(q), _f32(coef)
    tiles = _tiles("pdist_rankeval", None,
                   {"g": coef.shape[0], "b": q.shape[0], "d": q.shape[1],
                    "c": coef.shape[1]}, q)
    out = _fused.pdist_rankeval(q, _f32(piv), coef, _f32(lo), _f32(hi),
                                _f32(n), _f32(rg), n_rings, tiles)
    _count_launch("pdist_rankeval", q)
    return out


def flash_attention(q, k, v, causal: bool = True, bq: int = 128,
                    bk: int = 128, window: int | None = None):
    """Padded flash attention: (B,Hq,Sq,D) x (B,Hk,Sk,D) -> (B,Hq,Sq,D).
    ``bq`` and ``bk`` are the padding multiples, multiples of 128 (the
    kernel's tiles divide 128; the plain version steps over 128-wide kv
    blocks).  ``window`` (a sliding window) masks keys with
    ``qpos - kpos >= window``.

    The CUDA kernel writes a fresh tensor through a raw pointer, so its
    output carries no ``grad_fn``: a CUDA operand that requires grad
    raises here while grad mode is on.  Differentiate through
    ``models.layers.flash_attention`` (an autograd Function whose
    backward is the plain attention's), inside whose forward grad mode
    is off."""
    if torch.is_grad_enabled() and q.is_cuda and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "ops.flash_attention has no backward: a CUDA operand requires "
            "grad; call models.layers.flash_attention, which gives the "
            "kernel the plain attention's gradient")
    if bq % _flash.TILE or bk % _flash.TILE:
        raise ValueError(f"bq {bq} and bk {bk} must be multiples of "
                         f"{_flash.TILE}")
    sq, sk = q.shape[2], k.shape[2]
    pq, pk = (-sq) % bq, (-sk) % bk
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, pq))
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, pk))
    out = _flash.flash_attention(q, k, v, causal=causal,
                                 kv_len=sk if pk else None, window=window)
    _count_launch("flash_attention", q)
    return out[:, :, :sq]


__all__ = ["pdist", "pdist_grouped", "rankeval", "range_filter",
           "pdist_rankeval", "flash_attention", "fused_plan_enabled", "FAR",
           "GROUPED", "far_rows", "count_replayed"]
