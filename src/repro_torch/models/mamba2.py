"""Mamba2 / SSD (state-space duality) blocks, chunked.

Port of ``repro/models/mamba2.py`` (``mamba2.py:22-209``): the SSD
algorithm splits the sequence into chunks; the intra-chunk term is a
masked, decay-weighted attention-like product, the inter-chunk term a
short loop over chunk states (the reference's ``lax.scan``), in f32.
Decode is the O(1) recurrent update on a (B, H, P, N) state cache.
Plain torch on both devices, as the reference computes it in jnp.

Shapes: d_inner = expand * d_model; H = d_inner / head_dim heads; state
N.  in_proj emits [z, x, B, C, dt]; a depthwise causal conv runs over
(x, B, C).

Under tensor parallelism (the training step over a ``model`` axis of
several ranks: ``collective.model_line()``) every mixer leaf is held as
the guard leaves it: a contiguous chunk of its ``ssm_inner`` dim, or
whole where that dim does not divide the line.  A chunk of ``in_proj``'s
or ``conv_w``'s columns crosses the z | x | B | C | dt boundaries, so
:func:`mamba_forward` joins them first: the rank's ``in_proj`` output
columns and its ``conv_w`` / ``conv_b`` chunks are gathered whole
(``collective.gather_to_model``, whose backward reduce-scatters), or a
whole leaf passes ``collective.to_model``; the rank then runs its own
heads (:func:`model_heads`: z, x and dt by head, the B and C groups
those heads read, its chunks of ``A_log``, ``dt_bias``, ``D`` and
``norm_w``), the gated norm's sum of squares summed over the line
(``collective.sum_to_model``), and the row-split ``out_proj`` leaves
through ``collective.from_model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding import collective
from .layers import gated_rmsnorm
from .params import ParamSpec

F32 = torch.float32


def mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_dim


def mamba_specs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, n_heads, conv_dim = mamba_dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + n_heads
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.d_conv, conv_dim), ("conv", "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "A_log": ParamSpec((n_heads,), ("ssm_inner",), init="zeros",
                           dtype="float32"),
        "dt_bias": ParamSpec((n_heads,), ("ssm_inner",), init="zeros",
                             dtype="float32"),
        "D": ParamSpec((n_heads,), ("ssm_inner",), init="ones",
                       dtype="float32"),
        "norm_w": ParamSpec((d_in,), ("ssm_inner",), init="ones",
                            dtype="float32"),
        "out_proj": ParamSpec((d_in, d), ("ssm_inner", "embed")),
    }


def model_heads(cfg: ModelConfig, n: int) -> int:
    """The SSM heads each rank of a model line of ``n`` ranks runs (the
    guard's ``ssm_inner`` split of the (H,) leaves).  A head count that
    does not divide the line raises ``NotImplementedError``: a rank's
    chunk of ``d_inner`` would cut a head (ROADMAP Queue A item 11)."""
    _, n_heads, _ = mamba_dims(cfg)
    if n_heads % n:
        raise NotImplementedError(
            f"the {cfg.family} family over a model axis of {n} ranks (tensor "
            f"parallelism) at {n_heads} SSM heads is not ported: the line "
            "would cut a head (ROADMAP Queue A item 11)")
    return n_heads // n


def _whole_on_line(w: torch.Tensor, full: int) -> torch.Tensor:
    """A leaf whose last dim is the ``ssm_inner`` concatenation, whole on
    every rank of the model line: the rank's chunk gathered (its
    gradient reduce-scattered), or a leaf the guard left whole through
    ``collective.to_model`` (its gradient, a part on each rank, summed)."""
    if w.shape[-1] < full:
        return collective.gather_to_model(w)
    return collective.to_model(w)


def _head_groups(m: torch.Tensor, first: int, hc: int,
                 n_heads: int) -> torch.Tensor:
    """The groups of B or C (B, S, G, N) that heads first .. first+hc-1
    read (group g serves H / G consecutive heads): a slice where those
    heads take them evenly, else one group a head."""
    rep = n_heads // m.shape[2]
    g = [(first + i) // rep for i in range(hc)]
    lo, used = g[0], g[-1] - g[0] + 1
    if hc % used == 0 and all(j - lo == i // (hc // used)
                              for i, j in enumerate(g)):
        return m[:, :, lo:lo + used]
    return m[:, :, torch.tensor(g, device=m.device)]


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_in, n_heads, _ = mamba_dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, n_heads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv along S.  xbc: (B, S, C); w: (K, C).
    Returns (out, new_state) with state = the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(xbc.shape[0], k - 1, xbc.shape[2], dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                     # (B, S+K-1, C)
    sl = xbc.shape[1]
    out = xp[:, 0:sl, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + sl, :] * w[i][None, None, :]
    out = out + b[None, None, :].to(out.dtype)
    new_state = xp[:, -(k - 1):, :]
    return F.silu(out).to(xbc.dtype), new_state


def ssd_chunked(x, dt, a_neg, bmat, cmat, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); a_neg: (H,) negative;
    bmat/cmat: (B, S, G, N) with G groups broadcast over H.
    Returns y (B, S, H, P) in x's dtype, final_state (B, H, P, N) f32.
    """
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    pad = (-s) % chunk
    if pad:
        # zero-dt padding steps are identities: decay = exp(0) = 1, input
        # contribution dt * x = 0; the state passes through untouched
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g
    state = (torch.zeros(b, h, p, n, dtype=F32, device=x.device)
             if init_state is None else init_state)
    li = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                               device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xk, dtk, bk, ck = x[:, sl], dt[:, sl], bmat[:, sl], cmat[:, sl]
        a = dtk * a_neg[None, None, :]                     # (b, L, h) <= 0
        cums = torch.cumsum(a, dim=1)                      # (b, L, h)
        seg = cums[:, :, None, :] - cums[:, None, :, :]    # (b, i, j, h)
        # masked before the exp (the reference masks after it): above the
        # diagonal seg is -(a's sum) > 0 and its exp overflows once a chunk
        # sums past ~88 (mamba2's 256 steps at dt ~0.7), where the
        # gradient of where(mask, exp(seg), 0) is 0 * inf = NaN; the
        # values are the reference's, exp(-inf) = 0
        lmat = torch.exp(torch.where(li[None, :, :, None], seg,
                                     torch.full((), float("-inf"), dtype=F32,
                                                device=x.device)))
        bh = torch.repeat_interleave(bk, rep, dim=2).to(F32)  # (b, L, h, n)
        ch = torch.repeat_interleave(ck, rep, dim=2).to(F32)
        gmat = torch.einsum("bihn,bjhn->bijh", ch, bh)
        xt = xk.to(F32) * dtk[..., None]                   # (b, L, h, p)
        y_intra = torch.einsum("bijh,bjhp->bihp", gmat * lmat, xt)
        # inter-chunk: the contribution of the carried state
        y_inter = torch.einsum("bihn,bhpn->bihp",
                               ch * torch.exp(cums)[..., None], state)
        # state update
        decay_end = torch.exp(cums[:, -1:, :] - cums)      # (b, L, h)
        state = state * torch.exp(cums[:, -1, :])[:, :, None, None] + \
            torch.einsum("bjhn,bjhp->bhpn", bh * decay_end[..., None], xt)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    if pad:
        y = y[:, :s - pad]
    return y.to(x.dtype), state


def _refuse_on_line(what: str) -> None:
    if collective.model_line() is not None:
        raise NotImplementedError(
            f"{what} over a model line of ranks is not ported (ROADMAP "
            "Queue A item 10(b))")


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  cache: dict | None = None):
    """Full-sequence forward.  Returns (y, new cache state or None).
    Under an active model line the rank's heads (the module docstring);
    a cache there raises ``NotImplementedError`` (item 10(b))."""
    s = cfg.ssm
    d_in, n_heads, conv_dim = mamba_dims(cfg)
    gn = s.n_groups * s.d_state
    mp = collective.model_line()
    if mp is None:
        first, hc = 0, n_heads
        zxbcdt = x @ p["in_proj"]
        z, xc, bb, ccm, dt = _split_proj(cfg, zxbcdt)
        conv_w, conv_b = p["conv_w"], p["conv_b"]
    else:
        if cache is not None:
            _refuse_on_line("a mamba cache (prefill)")
        hc = model_heads(cfg, mp.size)
        first = mp.index * hc
        x = collective.to_model(x)
        w = p["in_proj"]
        if w.shape[-1] < 2 * d_in + 2 * gn + n_heads:
            zxbcdt = collective.gather_to_model(x @ w)
        else:
            zxbcdt = x @ collective.to_model(w)
        z, xc, bb, ccm, dt = _split_proj(cfg, zxbcdt)
        cols = slice(first * s.head_dim, (first + hc) * s.head_dim)
        z, xc, dt = z[..., cols], xc[..., cols], dt[..., first:first + hc]
        conv_w, conv_b = (_whole_on_line(p[k], conv_dim)
                          for k in ("conv_w", "conv_b"))
        conv_w = torch.cat([conv_w[:, cols], conv_w[:, d_in:]], dim=-1)
        conv_b = torch.cat([conv_b[cols], conv_b[d_in:]], dim=-1)
    xbc = torch.cat([xc, bb, ccm], dim=-1)
    conv_state = None if cache is None else cache["conv"]
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state)
    xc, bb, ccm = torch.split(xbc, [hc * s.head_dim, gn, gn], dim=-1)
    b_, sl, _ = xc.shape
    xh = xc.reshape(b_, sl, hc, s.head_dim)
    bmat = bb.reshape(b_, sl, s.n_groups, s.d_state)
    cmat = ccm.reshape(b_, sl, s.n_groups, s.d_state)
    if hc < n_heads:
        bmat, cmat = (_head_groups(m, first, hc, n_heads)
                      for m in (bmat, cmat))
    dtv = F.softplus(dt.to(F32) + p["dt_bias"][None, None, :])
    a_neg = -torch.exp(p["A_log"].to(F32))
    init = None if cache is None else cache["ssm"]
    y, final = ssd_chunked(xh, dtv, a_neg, bmat, cmat, s.chunk, init)
    y = y + xh.to(F32) * p["D"][None, None, :, None]
    y = y.reshape(b_, sl, hc * s.head_dim).to(x.dtype)
    y = gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps, width=d_in)
    out = y @ p["out_proj"]
    if mp is not None:
        out = collective.from_model(out)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "ssm": final}
    return out, new_cache


def mamba_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Single-token recurrent step.  x: (B, 1, D).  Under an active model
    line it raises ``NotImplementedError`` (item 10(b))."""
    _refuse_on_line("mamba decode")
    s = cfg.ssm
    d_in, n_heads, _ = mamba_dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z, xc, bb, ccm, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xc, bb, ccm], dim=-1)[:, 0]            # (B, C)
    window = torch.cat([cache["conv"].to(xbc.dtype), xbc[:, None, :]],
                       dim=1)                               # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    new_conv = window[:, 1:, :]
    gn = s.n_groups * s.d_state
    xc2, bb2, cc2 = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    b_ = x.shape[0]
    xh = xc2.reshape(b_, n_heads, s.head_dim).to(F32)
    bmat = bb2.reshape(b_, s.n_groups, s.d_state).to(F32)
    cmat = cc2.reshape(b_, s.n_groups, s.d_state).to(F32)
    rep = n_heads // s.n_groups
    bh = torch.repeat_interleave(bmat, rep, dim=1)          # (B, H, N)
    ch = torch.repeat_interleave(cmat, rep, dim=1)
    dtv = F.softplus(dt[:, 0].to(F32) + p["dt_bias"])
    a_neg = -torch.exp(p["A_log"].to(F32))
    decay = torch.exp(dtv * a_neg)[..., None, None]         # (B, H, 1, 1)
    xt = xh * dtv[..., None]                                # (B, H, P)
    state = cache["ssm"] * decay + xt[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(b_, 1, d_in).to(x.dtype)
    y = gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], {"conv": new_conv.to(cache["conv"].dtype),
                               "ssm": state}


__all__ = ["mamba_dims", "mamba_specs", "model_heads", "mamba_forward",
           "mamba_decode", "ssd_chunked"]
