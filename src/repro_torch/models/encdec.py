"""Encoder-decoder backbone (seamless-m4t style), serving half: a
bidirectional encoder over stub modality-frontend frame embeddings and
a causal decoder with cross-attention.

Port of ``repro/models/encdec.py`` (``encdec.py:21-249``): ``encode``,
the teacher-forced ``decode_train`` (the decoder over a whole target
sequence, which prefill runs over the prime tokens), ``encdec_loss``,
``encdec_prefill`` and ``encdec_decode_step``.  Each encoder and
decoder layer runs under ``transformer._remat`` (ref ``:95``, ``:123``).  The speech /
text frontend is a stub: ``src_embeds`` are precomputed (B, S_src, D)
frames.  On a CUDA tensor the encoder's, the decoder's and the
cross-attention's full-sequence attention is the hand-written
``kernels.ops.flash_attention`` (non-causal with Sq != Sk for the
cross-attention), differentiable through ``layers.flash_attention``
with the gradient of :func:`plain_attention`; on the CPU it is
:func:`plain_attention`, ``dense_attention`` or ``chunked_attention``
picked as ``encdec.py:67`` picks them.  Decode attention is plain
torch.  Under FSDP each layer gathers its chunks inside the remat'd
layer function and the loss gathers ``embed`` and ``lm_head`` once, as
``transformer`` does.  Under tensor parallelism (a ``model`` axis over
ranks) every attention runs the rank's heads and the MLP its columns,
as ``transformer`` splits them; the embedding, head and NLL are the
vocabulary-split ones where the guard splits the vocabulary.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import ModelConfig
from .layers import (apply_rope, attention_specs, chunked_attention,
                     decode_attention, dense_attention, flash_attention,
                     mlp_specs, rmsnorm, rope_tables, swiglu)
from .params import ParamSpec, torch_dtype
from ..sharding import collective
from .transformer import (_embed, _nll_loss, _qkv, _rank_heads,
                          _refuse_on_line, _remat, _rope, _stack, _unembed,
                          gather_outside, layer_params, zeros_cache)


def enc_block_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                               dtype="float32"),
        "attn": attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
        "mlp_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                              dtype="float32"),
        "mlp": mlp_specs(d, cfg.d_ff),
    }


def dec_block_specs(cfg: ModelConfig) -> dict:
    sp = enc_block_specs(cfg)
    d = cfg.d_model
    sp["cross_norm"] = ParamSpec((d,), ("embed_noshard",), init="ones",
                                 dtype="float32")
    sp["cross"] = attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    return sp


def encdec_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab
    n_dec = cfg.n_dec_layers or cfg.n_layers
    return {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="normal"),
        "enc_final_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                                    dtype="float32"),
        "final_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                                dtype="float32"),
        "lm_head": ParamSpec((d, v), ("embed", "vocab")),
        "enc_layers": _stack(enc_block_specs(cfg), cfg.n_layers),
        "dec_layers": _stack(dec_block_specs(cfg), n_dec),
    }


def attention(q, k, v, cfg: ModelConfig, causal: bool):
    """(B, Sq, H, hd) x (B, T, Hk, hd) attention: the flash kernel on a
    CUDA tensor (its gradient that of :func:`plain_attention`),
    :func:`plain_attention` on the CPU."""
    if not q.is_cuda:
        return plain_attention(q, k, v, cfg, causal)
    return flash_attention(q, k, v, functools.partial(
        plain_attention, cfg=cfg, causal=causal), causal=causal)


def plain_attention(q, k, v, cfg: ModelConfig, causal: bool):
    """Dense attention when ``attn_impl="dense"`` or both lengths fit
    one chunk, else the chunked online softmax over whole chunks
    (``encdec.py:67-75``)."""
    sq, t = q.shape[1], k.shape[1]
    if cfg.attn_impl == "dense" or max(sq, t) <= cfg.attn_chunk:
        return dense_attention(q, k, v, causal=causal)
    ck = min(cfg.attn_chunk, sq, t)
    if sq % ck or t % ck:
        raise ValueError(f"chunked attention needs whole chunks: Sq {sq}, "
                         f"T {t}, chunk {ck}")
    return chunked_attention(q, k, v, causal=causal, chunk_q=ck, chunk_k=ck)


def _attend(p, xq, xkv, cfg, cos_q, sin_q, cos_k, sin_k, causal,
            rope: bool = True):
    """Attention of ``xq``'s queries against ``xkv``'s keys and values
    (the same tensor for self-attention).  Under tensor parallelism the
    rank's heads (``transformer._rank_heads``): both inputs enter through
    ``collective.to_model`` (so the cross-attention's ``memory`` carries
    its gradient summed over the line out of every decoder layer) and
    the row-split ``wo``'s partial sums leave through ``from_model``."""
    p, split = _rank_heads(p, cfg)
    if split:
        same = xkv is xq
        xq = collective.to_model(xq)
        xkv = xq if same else collective.to_model(xkv)
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"])
    rot = int(cfg.hd * cfg.partial_rotary)
    if rope:
        q = apply_rope(q, cos_q, sin_q, rot)
        k = apply_rope(k, cos_k, sin_k, rot)
    o = attention(q, k, v, cfg, causal)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return (collective.from_model(out) if split else out), (k, v)


def encode(params, src_embeds, cfg: ModelConfig):
    """src_embeds: (B, S_src, D) stub frontend output -> encoder
    memory."""
    x = src_embeds.to(torch_dtype(cfg.dtype))
    cos, sin = _rope(x.shape[1], cfg, x.device)
    layer = _remat(_enc_layer, cfg)
    for i in range(cfg.n_layers):
        x = layer(layer_params(params["enc_layers"], i), x, cfg, cos, sin)
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def _enc_layer(lp, x, cfg: ModelConfig, cos, sin):
    lp = collective.gathered(lp)
    xn = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    a, _ = _attend(lp["attn"], xn, xn, cfg, cos, sin, cos, sin,
                   causal=False)
    x = x + a
    f = swiglu(lp["mlp"], rmsnorm(x, lp["mlp_norm"], cfg.norm_eps),
               cfg.d_ff)
    return (x + f).to(x.dtype)


def _dec_layer(lp, x, memory, cfg: ModelConfig, cos, sin):
    """One decoder layer; returns (hidden, its self-attention (k, v))."""
    lp = collective.gathered(lp)
    xn = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    a, kv = _attend(lp["attn"], xn, xn, cfg, cos, sin, cos, sin,
                    causal=True)
    x = x + a
    xn = rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
    c, _ = _attend(lp["cross"], xn, memory, cfg, None, None, None, None,
                   causal=False, rope=False)
    x = x + c
    f = swiglu(lp["mlp"], rmsnorm(x, lp["mlp_norm"], cfg.norm_eps),
               cfg.d_ff)
    return (x + f).to(x.dtype), kv


def _decoder(params, memory, tokens, cfg: ModelConfig, on_kv=None):
    """The decoder over the whole of ``tokens`` against ``memory``;
    ``on_kv(i, k, v)`` receives layer i's self-attention keys and
    values.  Returns the hidden states."""
    x = _embed(params, tokens, vocab=cfg.vocab)
    cos, sin = _rope(x.shape[1], cfg, x.device)
    layer = _remat(_dec_layer, cfg)
    for i in range(cfg.n_dec_layers or cfg.n_layers):
        x, kv = layer(layer_params(params["dec_layers"], i), x, memory, cfg,
                      cos, sin)
        if on_kv is not None:
            on_kv(i, *kv)
    return x


def decode_train(params, memory, tokens, cfg: ModelConfig):
    """Teacher-forced decoder over the full target sequence -> logits
    (B, S, V) f32."""
    return _unembed(params, _decoder(params, memory, tokens, cfg), cfg)


def encdec_loss(params, batch: dict, cfg: ModelConfig):
    """batch: src_embeds (B, S_src, D), tokens and labels (B, S) (-1 =
    masked).  The masked mean NLL of the teacher-forced decoder's f32
    logits (ref ``encdec.py:130-140``; under data parallelism the mean
    over the whole microbatch, ``transformer._nll_loss``).  Returns
    (nll, {"nll"})."""
    params = gather_outside(params, ("enc_layers", "dec_layers"))
    memory = encode(params, batch["src_embeds"], cfg)
    logits = decode_train(params, memory, batch["tokens"], cfg)
    return _nll_loss(logits, batch["labels"], cfg, None)


# ------------------------------------------------------------------ serving
def encdec_cache_spec(cfg: ModelConfig, batch: int, cache_len: int,
                      mem_len: int):
    n_dec = cfg.n_dec_layers or cfg.n_layers
    kv = (n_dec, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    mem_kv = (n_dec, batch, mem_len, cfg.n_kv_heads, cfg.hd)
    axes = ("layers", "batch", "kv_seq", "kv_heads", "qkv")
    return {
        "k": (kv, axes, cfg.dtype),
        "v": (kv, axes, cfg.dtype),
        "mem_k": (mem_kv, axes, cfg.dtype),
        "mem_v": (mem_kv, axes, cfg.dtype),
        "pos": ((), (), "int32"),
    }


def encdec_prefill(params, src_embeds, tokens, cfg: ModelConfig,
                   cache_len: int):
    """Encode the source, prime the decoder with ``tokens`` (B, S),
    build the caches (self-attention k/v and the cross-attention's
    memory k/v, computed once a request).  Returns (last-token logits
    (B, 1, V) f32, cache).  Over the data axes of a mesh of ranks the
    rows are the rank's (its FSDP chunks gathered where read); under a
    model line it raises ``NotImplementedError`` (ROADMAP Queue A item
    10(b))."""
    _refuse_on_line(cfg, "prefill")
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                         f"{cache_len}")
    params = gather_outside(params, ("enc_layers", "dec_layers"))
    memory = encode(params, src_embeds, cfg)
    cache = zeros_cache(encdec_cache_spec(cfg, b, cache_len,
                                          memory.shape[1]), tokens.device)
    for i in range(cfg.n_dec_layers or cfg.n_layers):
        cross = collective.gathered(
            layer_params(params["dec_layers"], i)["cross"])
        cache["mem_k"][i] = torch.einsum("bsd,dhk->bshk", memory, cross["wk"])
        cache["mem_v"][i] = torch.einsum("bsd,dhk->bshk", memory, cross["wv"])

    def store(i, k, v):
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v

    x = _decoder(params, memory, tokens, cfg, store)
    cache["pos"] = s
    return _unembed(params, x[:, -1:], cfg), cache


def encdec_decode_step(params, token, cache, cfg: ModelConfig):
    """token: (B,) int, the token at position ``cache["pos"]``.  Returns
    (logits (B, 1, V) f32, cache), the self-attention cache updated in
    place.  Over ranks as :func:`encdec_prefill`."""
    _refuse_on_line(cfg, "a decode step")
    params = gather_outside(params, ("enc_layers", "dec_layers"))
    pos = int(cache["pos"])
    kall, vall = cache["k"], cache["v"]
    if pos >= kall.shape[2]:
        raise ValueError(f"the cache of {kall.shape[2]} slots is full")
    x = params["embed"][token.long()][:, None, :]
    cos, sin = rope_tables(torch.tensor([pos], device=x.device),
                           int(cfg.hd * cfg.partial_rotary), cfg.rope_theta)
    mem_last = cache["mem_k"].shape[2] - 1
    for i in range(cfg.n_dec_layers or cfg.n_layers):
        lp = collective.gathered(layer_params(params["dec_layers"], i))
        xn = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q, kn, vn = _qkv(lp["attn"], xn, cfg, cos, sin)
        kall[i, :, pos] = kn[:, 0].to(kall.dtype)
        vall[i, :, pos] = vn[:, 0].to(vall.dtype)
        o = decode_attention(q, kall[i], vall[i], pos)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        # cross attention against the precomputed memory k/v (all valid)
        xn = rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
        qc = torch.einsum("bsd,dhk->bshk", xn, lp["cross"]["wq"])
        oc = decode_attention(qc, cache["mem_k"][i], cache["mem_v"][i],
                              mem_last)
        x = x + torch.einsum("bshk,hkd->bsd", oc, lp["cross"]["wo"])
        f = swiglu(lp["mlp"], rmsnorm(x, lp["mlp_norm"], cfg.norm_eps))
        x = (x + f).to(x.dtype)
    return _unembed(params, x, cfg), dict(cache, pos=pos + 1)
