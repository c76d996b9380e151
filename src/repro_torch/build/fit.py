"""Batched rank-model fitting: one pass for every model in the index.

Port of ``repro/build/fit.py``.  The host build fits K·m distance→rank
models plus K LIMS-value→position models one ``chebfit`` at a time.
Here all G = K·m + K groups solve together: a Chebyshev-Vandermonde
basis over the padded (G, n_max) column matrix, normal equations per
group, and one batched ``torch.linalg.solve_ex`` on the (G, C, C) stack
(the reference leaves the same solve to XLA, outside its kernels).
Plain torch in f32; the einsums run in full f32 under torch's defaults
(TF32 off for matmuls).

Numerical notes (f32):

* the basis is Chebyshev on x normalized to [-1, 1], the same model
  class as the host's ``PolyRankModel.fit`` (degree-g polynomials),
  same normalization, so device coefficients drop straight into
  ``PolyRankModel`` records;
* normal equations square the basis condition number, so each group
  gets a scale-aware Tikhonov jitter, the per-group degree is capped
  exactly like the hardened host fit (``min(degree, max(1, n//8),
  n_distinct - 1)``), and any group whose solve fails or goes
  non-finite falls back to the exact linear ramp rank ≈ (n-1)(t+1)/2;
* model quality never affects exactness: a worse fit only widens the
  certified error bound E.

The same pass certifies a device-side rank-error estimate per group
(max deviation at the data points + the Chebyshev derivative bound for
the gaps).  Snapshots built from the materialized index re-certify E
against the exact f64 columns through the ``rankeval`` kernel; the
device estimate is for diagnostics.
"""
from __future__ import annotations

import torch

_E_SLACK = 2.0      # rint half-steps + f32 eval slop (mirrors snapshot)


def cheb_basis(t: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., n) → (..., n, degree+1) Chebyshev-Vandermonde basis via the
    T_k recurrence (numerically benign on [-1, 1])."""
    cols = [torch.ones_like(t), t]
    for _ in range(2, degree + 1):
        cols.append(2.0 * t * cols[-1] - cols[-2])
    return torch.stack(cols[:degree + 1], dim=-1)


def _fit_kernel(cols: torch.Tensor, counts: torch.Tensor,
                deg_req: torch.Tensor, max_degree: int):
    """The batched fit.  ``cols`` (G, n_max) ascending per group with
    arbitrary padding past ``counts[g]``; ``deg_req`` (G,) per-group
    requested degree (rank vs position models differ)."""
    G, n_max = cols.shape
    C = max_degree + 1
    dev = cols.device
    idx = torch.arange(n_max, device=dev)
    n = counts.to(torch.float32)                                  # (G,)
    w = (idx[None, :] < counts[:, None]).to(torch.float32)        # (G, n_max)

    lo = cols[:, 0]
    last = torch.clamp(counts - 1, 0, n_max - 1).to(torch.int64)
    hi = torch.gather(cols, 1, last[:, None])[:, 0]
    span = hi - lo
    degenerate = (span <= 0) | (counts <= 1)
    span_safe = torch.where(span > 0, span, 1.0)
    t = torch.clamp((cols - lo[:, None]) / span_safe[:, None] * 2.0 - 1.0,
                    -1.0, 1.0)

    # ties-low ranks within each sorted column: the last index that
    # started a new value, propagated by a running max
    prev = torch.cat([torch.full((G, 1), -torch.inf, dtype=cols.dtype,
                                 device=dev), cols[:, :-1]], dim=1)
    newv = cols != prev
    ranks = torch.cummax(torch.where(newv, idx[None, :], 0),
                         dim=1).values.to(torch.float32)
    n_distinct = torch.sum(newv.to(torch.int32) * (w > 0), dim=1)

    # hardened per-group degree: over-determined and tie-aware
    dg = torch.minimum(torch.minimum(deg_req, torch.clamp(counts // 8, min=1)),
                       torch.clamp(n_distinct - 1, min=1)).to(torch.int32)
    c_idx = torch.arange(C, device=dev)
    cmask = (c_idx[None, :] <= dg[:, None]).to(torch.float32)     # (G, C)

    T = cheb_basis(t, max_degree)                                 # (G,n,C)
    Tw = T * w[:, :, None] * cmask[:, None, :]
    A = torch.einsum("gnc,gnd->gcd", Tw, Tw)
    b = torch.einsum("gnc,gn->gc", Tw, ranks)
    del Tw
    # identity rows pin masked coefficients to 0; live rows get a
    # scale-aware jitter (diag(A) ≈ n/2 per Chebyshev coefficient)
    jitter = 1e-6 * torch.clamp(n, min=1.0)
    diag = torch.where(cmask > 0, jitter[:, None], 1.0)
    A = A + torch.eye(C, device=dev)[None] * diag[:, None, :]
    sol, info = torch.linalg.solve_ex(A, b[..., None])
    coef = sol[..., 0] * cmask

    # exact linear-ramp fallback for any solve that failed or went
    # non-finite
    r_last = torch.gather(ranks, 1, last[:, None])[:, 0]
    ramp = torch.zeros((G, C), dtype=coef.dtype, device=dev)
    ramp[:, 0] = r_last / 2.0
    if C > 1:
        ramp[:, 1] = r_last / 2.0
    bad = ~torch.all(torch.isfinite(coef), dim=1) | (info != 0)
    coef = torch.where(bad[:, None], ramp, coef)
    coef = torch.where(degenerate[:, None], 0.0, coef)
    hi_out = torch.where(span > 0, hi, lo + 1.0)
    lo_out = torch.where(counts > 0, lo, 0.0)
    hi_out = torch.where(counts > 0, hi_out, 1.0)

    # device-side certified error estimate: deployed-polynomial
    # deviation at the data points + derivative bound × largest t-gap
    pred = torch.minimum(
        torch.clamp(torch.round(torch.einsum("gnc,gc->gn", T, coef)),
                    min=0.0),
        torch.clamp(n - 1.0, min=0.0)[:, None])
    del T
    err_pt = torch.amax(torch.abs(pred - ranks) * w, dim=1)
    deriv = torch.sum((c_idx.to(torch.float32) ** 2)[None, :]
                      * torch.abs(coef), dim=1)
    t_next = torch.cat([t[:, 1:], t[:, -1:]], dim=1)
    pair_ok = (idx[None, :] + 1 < counts[:, None]).to(torch.float32)
    gap = torch.amax((t_next - t) * pair_ok, dim=1)
    err = torch.minimum(err_pt + deriv * gap + _E_SLACK, n)
    err = torch.where(counts > 0, err, 0.0)
    return coef, lo_out, hi_out, n, dg, err


def batched_chebfit(cols, counts, deg_req, max_degree: int):
    """Fit every group's rank model in one pass.

    ``cols`` (G, n_max) ascending (any padding), ``counts`` (G,) valid
    lengths, ``deg_req`` (G,) requested degree per group; tensors stay on
    their device, arrays go to the CPU.  Returns ``(coef (G,
    max_degree+1), lo, hi, n, dg, err)``: ``dg`` the per-group effective
    degree actually fit, ``err`` the device-side certified rank-error
    estimate.
    """
    cols = torch.as_tensor(cols, dtype=torch.float32)
    dev = cols.device
    return _fit_kernel(cols,
                       torch.as_tensor(counts, device=dev).to(torch.int32),
                       torch.as_tensor(deg_req, device=dev).to(torch.int32),
                       int(max_degree))


__all__ = ["batched_chebfit", "cheb_basis"]
