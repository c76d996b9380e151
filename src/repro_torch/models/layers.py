"""Shared transformer building blocks: RMSNorm, RoPE (partial rotary),
GQA attention (dense / chunked / decode) and the SwiGLU MLP.

Port of ``repro/models/layers.py``: pure functions over parameter
subtrees (dicts of tensors), f32 softmax and norm math, matmuls in the
model dtype.  Products the reference takes with
``preferred_element_type=float32`` cast their operands to f32 first, so
their outputs are never rounded to bf16 (TF32 stays off, PyTorch's
default).  On a CUDA tensor the model's prefill attention is the
hand-written ``kernels.ops.flash_attention`` (``transformer.attention``);
the functions here are the plain versions the CPU runs.
``gated_rmsnorm`` waits for mamba2, and the reference's ``q0`` (a query
offset) and ``window`` (sliding window, ring cache in decode) wait for
the slice that ports sliding-window configurations (ROADMAP A14): every
query here starts at position 0 and sees every earlier key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import ParamSpec

_NEG = -1e30
F32 = torch.float32


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.to(F32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
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


def _causal_mask(sq: int, t: int, device):
    """(sq, t) boolean mask, both positions counted from 0."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    return qpos >= kpos


def dense_attention(q, k, v, causal=True) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, T, Hk, hd).  Full-score f32 softmax;
    q is scaled in its own dtype before the product, as the reference
    does (``layers.py:104``)."""
    b, sq, hq, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.transpose(1, 2).reshape(b, hk, g, sq, hd)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    s = _grouped_scores(qg * (hd ** -0.5), kt)
    if causal:
        m = _causal_mask(sq, t, q.device)
        s = torch.where(m[None, None, None], s, _NEG)
    w = torch.softmax(s, dim=-1)
    o = _grouped_out(w, vt)
    return o.reshape(b, hq, sq, hd).transpose(1, 2)


def chunked_attention(q, k, v, causal=True, chunk_q: int = 2048,
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
                qpos = iq * chunk_q + torch.arange(
                    chunk_q, device=q.device)[:, None]
                kpos = jk * chunk_k + torch.arange(
                    chunk_k, device=q.device)[None, :]
                ok = (qpos >= kpos) if causal else (qpos >= -1)
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


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """Single-step attention against the cache.

    q: (B, 1, Hq, hd); caches: (B, T, Hk, hd); pos: the absolute
    position of the new token.  Entries with index > pos are masked.
    The scores contract against the cache layout directly (no
    transposed copy of the cache)."""
    b, _, hq, hd = q.shape
    t, hk = k_cache.shape[1], k_cache.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, hd) * (hd ** -0.5)
    s = torch.einsum("bkgh,btkh->bkgt", qg.to(F32), k_cache.to(F32))
    ok = torch.arange(t, device=q.device) <= pos
    s = torch.where(ok[None, None, None], s, _NEG)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", w.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, hq, hd)


# -------------------------------------------------------------------- MLP
def mlp_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w1": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w3": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w2": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]
