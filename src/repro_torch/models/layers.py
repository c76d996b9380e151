"""Shared transformer building blocks: RMSNorm (and Mamba2's gated
RMSNorm), RoPE (partial rotary), GQA attention (dense / chunked /
decode, sliding-window aware) and the SwiGLU MLP.

Port of ``repro/models/layers.py``: pure functions over parameter
subtrees (dicts of tensors), f32 softmax and norm math, matmuls in the
model dtype.  Products the reference takes with
``preferred_element_type=float32`` cast their operands to f32 first, so
their outputs are never rounded to bf16 (TF32 stays off, PyTorch's
default).  On a CUDA tensor the model's prefill attention is the
hand-written ``kernels.ops.flash_attention``, called through
:func:`flash_attention`, an autograd Function whose backward is the
vector-Jacobian product of the plain attention recomputed on the saved
q, k and v (the reference never differentiates its Pallas kernel: it
trains through ``dense_attention`` / ``chunked_attention``, ref
``transformer.py:105-113``); the other functions here are the plain
versions the CPU runs.  ``q0`` is the
absolute position of query row 0; ``window`` masks keys with
``qpos - kpos >= window``; a windowed decode cache is a ring buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding import collective
from .params import ParamSpec

_NEG = -1e30
F32 = torch.float32


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.to(F32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(F32)).to(x.dtype)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5, width: int | None = None):
    """Mamba2 output norm: rmsnorm(x * silu(z)) * w.  Under tensor
    parallelism ``x``, ``z`` and ``w`` hold the rank's columns of the
    line's ``width``: the mean of squares is the line's
    (``collective.sum_to_model``)."""
    xf = x.to(F32) * F.silu(z.to(F32))
    if width is None or width == x.shape[-1]:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ms = collective.sum_to_model(
            torch.sum(xf * xf, dim=-1, keepdim=True)) / width
    y = xf * torch.rsqrt(ms + eps)
    return (y * w.to(F32)).to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope_tables(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions (...,) -> cos/sin tables (..., rot_dim/2), f32."""
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=F32,
                                        device=positions.device) / rot_dim))
    ang = positions.to(F32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """x: (..., S, H, hd); rotate the first rot_dim dims, pairing
    elements 0::2 with 1::2 (not HF Llama's rotate_half), in f32."""
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = rot[..., 0::2], rot[..., 1::2]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(rot.shape)
    return torch.cat([out, rest.to(out.dtype)], dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention
def attention_specs(d_model: int, n_heads: int, n_kv: int, hd: int) -> dict:
    return {
        "wq": ParamSpec((d_model, n_heads, hd), ("embed", "heads", "qkv")),
        "wk": ParamSpec((d_model, n_kv, hd), ("embed", "kv_heads", "qkv")),
        "wv": ParamSpec((d_model, n_kv, hd), ("embed", "kv_heads", "qkv")),
        "wo": ParamSpec((n_heads, hd, d_model), ("heads", "qkv", "embed")),
    }


def _grouped_scores(q, k):
    """q: (B, Hk, G, Sq, hd), k: (B, Hk, T, hd) -> (B, Hk, G, Sq, T) f32."""
    return torch.einsum("bkgqh,bkth->bkgqt", q.to(F32), k.to(F32))


def _grouped_out(w, v):
    return torch.einsum("bkgqt,bkth->bkgqh", w.to(v.dtype), v)


def _causal_mask(sq: int, t: int, q0: int, window: int | None, device):
    """(sq, t) boolean mask; q0 = absolute position of q row 0."""
    qpos = q0 + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    ok = qpos >= kpos
    if window is not None:
        ok = ok & ((qpos - kpos) < window)
    return ok


def dense_attention(q, k, v, q0: int = 0, causal=True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, T, Hk, hd).  Full-score f32 softmax;
    q is scaled in its own dtype before the product, as the reference
    does (``layers.py:104``).  The window applies with the causal mask
    only, as there."""
    b, sq, hq, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.transpose(1, 2).reshape(b, hk, g, sq, hd)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    s = _grouped_scores(qg * (hd ** -0.5), kt)
    if causal:
        m = _causal_mask(sq, t, q0, window, q.device)
        s = torch.where(m[None, None, None], s, _NEG)
    w = torch.softmax(s, dim=-1)
    o = _grouped_out(w, vt)
    return o.reshape(b, hq, sq, hd).transpose(1, 2)


def chunked_attention(q, k, v, q0: int = 0, causal=True,
                      window: int | None = None, chunk_q: int = 2048,
                      chunk_k: int = 2048):
    """Two-level online-softmax attention in plain torch: a loop over q
    chunks, an inner loop over kv chunks (the reference's two scans).
    Fully masked kv chunks are computed and masked, as there."""
    b, sq, hq, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    sq_real, t_real = sq, t
    pad_q, pad_k = (-sq) % chunk_q, (-t) % chunk_k
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        sq += pad_q
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        t += pad_k
    kv_limit = t_real if (pad_k and not causal) else None
    nq, nk = sq // chunk_q, t // chunk_k
    qg = q.transpose(1, 2).reshape(b, hk, g, sq, hd) * (hd ** -0.5)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    outs = []
    for iq in range(nq):
        qc = qg[:, :, :, iq * chunk_q:(iq + 1) * chunk_q]
        m_p = torch.full((b, hk, g, chunk_q), _NEG, dtype=F32,
                         device=q.device)
        l_p = torch.zeros_like(m_p)
        acc = torch.zeros(b, hk, g, chunk_q, hd, dtype=F32, device=q.device)
        for jk in range(nk):
            kc = kt[:, :, jk * chunk_k:(jk + 1) * chunk_k]
            vc = vt[:, :, jk * chunk_k:(jk + 1) * chunk_k]
            s = _grouped_scores(qc, kc)
            if causal or kv_limit is not None:
                qpos = q0 + iq * chunk_q + torch.arange(
                    chunk_q, device=q.device)[:, None]
                kpos = jk * chunk_k + torch.arange(
                    chunk_k, device=q.device)[None, :]
                ok = (qpos >= kpos) if causal else (qpos >= -1)
                if window is not None:
                    ok = ok & ((qpos - kpos) < window)
                if kv_limit is not None:
                    ok = ok & (kpos < kv_limit)
                s = torch.where(ok[None, None, None], s, _NEG)
            m_n = torch.maximum(m_p, s.amax(dim=-1))
            p = torch.exp(s - m_n[..., None])
            alpha = torch.exp(m_p - m_n)
            l_p = alpha * l_p + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,bkth->bkgqh", p.to(vc.dtype), vc)
            m_p = m_n
        outs.append((acc / torch.clamp(l_p, min=1e-30)[..., None])
                    .to(q.dtype))
    o = torch.cat(outs, dim=3).reshape(b, hq, sq, hd).transpose(1, 2)
    return o[:, :sq_real]


class _FlashAttention(torch.autograd.Function):
    """Forward: ``ops.flash_attention`` (the CUDA kernel on a card, its
    plain version ``flash_attention_ref`` on the CPU); backward: the
    plain attention ``plain(q, k, v)`` recomputed under grad on the
    saved inputs, and its vector-Jacobian product.  Tensors are in the
    model's (B, S, H, hd) layout."""

    @staticmethod
    def forward(ctx, q, k, v, plain, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window)
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[:3])]
            o = ctx.plain(*inputs)
            want = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(o, want, grad_out))
        grads = [next(got) if t.requires_grad else None for t in inputs]
        return (*grads, None, None, None)


def flash_attention(q, k, v, plain, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Attention of (B, Sq, Hq, hd) x (B, T, Hk, hd) tensors by the flash
    kernel, differentiable: its gradient is that of ``plain`` (a
    function of q, k, v computing the same attention in plain torch,
    e.g. :func:`dense_attention`), recomputed in the backward pass.
    Under remat the forward runs again in the recompute, so the kernel
    launches twice a layer."""
    return _FlashAttention.apply(q, k, v, plain, causal, window)


def decode_attention(q, k_cache, v_cache, pos: int,
                     window: int | None = None) -> torch.Tensor:
    """Single-step attention against a (possibly ring-buffered) cache.

    q: (B, 1, Hq, hd); caches: (B, T, Hk, hd); pos: the absolute
    position of the new token.  Entries with index > pos (or outside
    the sliding window) are masked.  The scores contract against the
    cache layout directly (no transposed copy of the cache)."""
    b, _, hq, hd = q.shape
    t = k_cache.shape[1]
    s = _decode_scores(q, k_cache)
    ok = _valid_slots(torch.arange(t, device=q.device), pos, t, window)
    s = torch.where(ok[None, None, None], s, _NEG)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", w.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, hq, hd)


def _decode_scores(q, k_cache):
    """q (B, 1, Hq, hd) against a cache (B, T, Hk, hd): the grouped f32
    scores (B, Hk, G, T), q scaled in its own dtype first."""
    b, _, hq, hd = q.shape
    hk = k_cache.shape[2]
    qg = q.reshape(b, hk, hq // hk, hd) * (hd ** -0.5)
    return torch.einsum("bkgh,btkh->bkgt", qg.to(F32), k_cache.to(F32))


def _valid_slots(idx, pos: int, t: int, window: int | None):
    """Which of the cache slots ``idx`` (of ``t``) hold a position the
    token at ``pos`` attends to."""
    if window is None:
        return idx <= pos
    # ring buffer (cache size t == min(window, seq)): slot i holds the
    # largest absolute position p <= pos with p % t == i; p >= 0 means
    # valid (p is within the window because t <= window)
    return (pos - torch.remainder(pos - idx, t)) >= 0


def decode_partial(q, k_cache, v_cache, pos: int, first: int, slots: int,
                   window: int | None = None):
    """A rank's part of :func:`decode_attention` over its chunk of the
    cache: slots ``first`` .. ``first`` + T - 1 of ``slots``, the mask
    read at those global slot indices.  Returns f32 (m, l, o): per (B,
    Hk, G) row the largest valid score (``_NEG`` where the chunk holds
    no valid slot), the sum of ``exp(s - m)`` over the valid slots and
    that sum of ``exp(s - m) v`` (B, Hk, G, hd), unnormalised; an
    invalid slot adds exactly 0 (``collective.merge_softmax`` merges the
    ranks' parts)."""
    t = k_cache.shape[1]
    s = _decode_scores(q, k_cache)
    ok = _valid_slots(first + torch.arange(t, device=q.device), pos, slots,
                      window)[None, None, None]
    s = torch.where(ok, s, _NEG)
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bkgt,btkh->bkgh", p, v_cache.to(F32))
    return m, p.sum(dim=-1), o


# -------------------------------------------------------------------- MLP
def mlp_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w1": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w3": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w2": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def swiglu(p: dict, x: torch.Tensor, d_ff: int | None = None
           ) -> torch.Tensor:
    """SwiGLU.  Under tensor parallelism (an active model line, and
    ``w1`` holding fewer than ``d_ff`` columns: the rank's chunk of
    ``mlp``) ``w1`` / ``w3`` are split by column and ``w2`` by row: ``x``
    enters through ``collective.to_model`` and the partial sums leave
    through ``collective.from_model``."""
    split = d_ff is not None and p["w1"].shape[-1] < d_ff \
        and collective.model_line() is not None
    if split:
        x = collective.to_model(x)
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    out = h @ p["w2"]
    return collective.from_model(out) if split else out
