"""Torch oracles for the ported kernels (the correctness contract).

Port of ``repro/kernels/ref.py``: each function computes the same math
as its kernel with no tiling and a deliberately different formulation
(direct differences for the distance, the explicit T_k recurrence for
the rank model), so agreement with a kernel is evidence, not identity.
"""
from __future__ import annotations

import torch


def pdist_ref(q: torch.Tensor, p: torch.Tensor,
              metric: str = "sql2") -> torch.Tensor:
    """Squared L2, L1 or L-infinity by direct differences, f32."""
    d = q.to(torch.float32)[:, None, :] - p.to(torch.float32)[None, :, :]
    if metric == "sql2":
        return torch.sum(d * d, dim=-1)
    if metric == "l1":
        return torch.sum(torch.abs(d), dim=-1)
    if metric == "linf":
        return torch.amax(torch.abs(d), dim=-1)
    raise ValueError(f"pdist_ref: unknown metric {metric!r}")


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


_NEG = -1e30    # the masked score of repro/kernels/flash_attention.py:23
_BK = 128       # kv block width of the reference wrapper's default tiling


def flash_attention_ref(q, k, v, causal: bool = True,
                        kv_len: int | None = None,
                        window: int | None = None):
    """Online-softmax GQA attention: the plain version of
    ``csrc/flash_attention.cu`` and the CPU lane of
    ``ops.flash_attention``.

    q (B, Hq, Sq, D), k and v (B, Hk, Sk, D) -> (B, Hq, Sq, D) in q's
    dtype.  It repeats ``_flash_kernel``'s recurrence over 128-wide kv
    blocks: q cast to f32 and scaled by 1/sqrt(D) in f32, f32 scores,
    masked scores at -1e30, running max and sum, the output divided by
    max(l, 1e-30).  The causal mask is ``qpos >= kpos`` from the top left
    (the kernel's, not ``attention_ref``'s bottom-right alignment); keys
    at or beyond ``kv_len`` are masked, and with ``window`` keys with
    ``qpos - kpos >= window`` (the sliding window of
    ``repro/models/layers.py:89-90``)."""
    b, hq, sq, d = q.shape
    _, hk, sk, _ = k.shape
    g = hq // hk
    f32 = torch.float32
    qf = (q.to(f32) * (1.0 / (d ** 0.5))).reshape(b, hk, g, sq, d)
    m = torch.full((b, hk, g, sq), _NEG, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hk, g, sq, d, dtype=f32, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for j0 in range(0, sk, _BK):
        if causal and j0 > sq - 1:
            break                   # this block and all after lie above
        kb = k[:, :, j0:j0 + _BK].to(f32)
        vb = v[:, :, j0:j0 + _BK].to(f32)
        s = torch.einsum("bkgqd,bktd->bkgqt", qf, kb)
        if causal or kv_len is not None or window is not None:
            kpos = j0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            ok = qpos >= kpos if causal else torch.ones_like(qpos >= kpos)
            if kv_len is not None:
                ok = ok & (kpos < kv_len)
            if window is not None:
                ok = ok & (qpos - kpos < window)
            s = torch.where(ok, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        m = m_new
        acc = acc * alpha[..., None] + torch.einsum("bkgqt,bktd->bkgqd", p,
                                                    vb)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)
