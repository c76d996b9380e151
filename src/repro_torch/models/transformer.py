"""Decoder-only LM of the dense family: full-sequence forward, prefill and
greedy-decode steps against a KV cache.

Port of ``repro/models/transformer.py`` (``transformer.py:35-150``,
``:257-327``, ``:396-460``), dense family only.  Parameters are nested
dicts of tensors with the reference's leaf names; the stacked
``layers`` tensors (leading dim L) run as a Python loop, with no scan
or remat.  Modes:

* ``forward_seq``: tokens -> final hidden states (and the per-layer
  keys and values with ``collect_cache``);
* ``prefill``: tokens -> (last-position logits, populated cache);
* ``decode_step``: one token + cache -> (logits, cache).

On a CUDA tensor the full-sequence attention is the hand-written
``kernels.ops.flash_attention`` (causal, from position 0: for those
inputs it computes what ``dense_attention`` computes, with q scaled in
f32); on the CPU it is ``dense_attention`` or ``chunked_attention``,
picked as ``transformer.py:105`` picks them.  Decode attention is plain
torch on both, as in the reference.  The moe, ssm, hybrid, vlm and
encdec families and sliding-window configurations raise
``NotImplementedError`` (ROADMAP A14): they never take a plain path on
the card unannounced.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.dispatch import resolve_device
from .layers import (F32, apply_rope, attention_specs, chunked_attention,
                     decode_attention, dense_attention, mlp_specs, rmsnorm,
                     rope_tables, swiglu)
from .params import ParamSpec, map_specs, torch_dtype


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run."""
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; only "
            f"dense is (ROADMAP A14)")
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not ported yet "
            f"(ROADMAP A14)")


# --------------------------------------------------------------- specs
def _stack(specs: dict, n: int) -> dict:
    return map_specs(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                         s.init, s.scale, s.dtype), specs)


def block_specs(cfg: ModelConfig) -> dict:
    """One transformer block (attention + FFN)."""
    d = cfg.d_model
    return {
        "attn_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                               dtype="float32"),
        "attn": attention_specs(d, cfg.n_q_heads, cfg.n_kv_heads, cfg.hd),
        "mlp_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                              dtype="float32"),
        "mlp": mlp_specs(d, cfg.d_ff),
    }


def model_specs(cfg: ModelConfig) -> dict:
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab
    sp: dict = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="normal"),
        "final_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                                dtype="float32"),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    sp["layers"] = _stack(block_specs(cfg), cfg.n_layers)
    return sp


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# --------------------------------------------------------------- blocks
def plain_attention(q, k, v, cfg: ModelConfig):
    """The reference's choice (``transformer.py:105``): dense attention
    for ``attn_impl="dense"`` or a sequence within one chunk, else the
    chunked online softmax."""
    sq = q.shape[1]
    if cfg.attn_impl == "dense" or sq <= cfg.attn_chunk:
        return dense_attention(q, k, v, causal=True)
    ck = min(cfg.attn_chunk, sq)
    return chunked_attention(q, k, v, causal=True, chunk_q=ck, chunk_k=ck)


def attention(q, k, v, cfg: ModelConfig):
    """Full-sequence causal attention of (B, S, H, hd) tensors: the flash
    kernel on a CUDA tensor, :func:`plain_attention` on the CPU."""
    if not q.is_cuda:
        return plain_attention(q, k, v, cfg)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True)
    return o.transpose(1, 2)


def attn_block(p: dict, x, cfg: ModelConfig, cos, sin):
    """Full-sequence attention sub-block (pre-norm, residual outside).
    Returns (output, (k, v))."""
    xn = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", xn, p["attn"]["wq"])
    k = torch.einsum("bsd,dhk->bshk", xn, p["attn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", xn, p["attn"]["wv"])
    rot = int(cfg.hd * cfg.partial_rotary)
    q = apply_rope(q, cos, sin, rot)
    k = apply_rope(k, cos, sin, rot)
    o = attention(q, k, v, cfg)
    return torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"]), (k, v)


def _zero_aux(device) -> dict:
    z = torch.zeros((), dtype=F32, device=device)
    return {"load_balance": z, "router_z": z}


def ffn_block(p: dict, x, cfg: ModelConfig):
    xn = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return swiglu(p["mlp"], xn), _zero_aux(x.device)


def transformer_layer(p, x, cfg: ModelConfig, cos, sin):
    a, kv = attn_block(p, x, cfg, cos, sin)
    x = x + a
    f, aux = ffn_block(p, x, cfg)
    return (x + f).to(x.dtype), aux, kv


# --------------------------------------------- full-sequence forward pass
def _embed(params, tokens):
    return params["embed"][tokens.long()]


def _unembed(params, x, cfg: ModelConfig):
    """Logits in f32: the operands are cast to f32 first, as the
    reference's ``preferred_element_type=float32`` keeps them."""
    xn = rmsnorm(x, params["final_norm"], cfg.norm_eps).to(F32)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", xn, params["embed"].to(F32))
    return xn @ params["lm_head"].to(F32)


def _run_layers(params, tokens, cfg: ModelConfig, on_kv=None):
    """Embed and run every layer; ``on_kv(i, k, v)`` receives layer i's
    keys and values (B, S, Hk, hd)."""
    check_supported(cfg)
    x = _embed(params, tokens)
    s = x.shape[1]
    rot = int(cfg.hd * cfg.partial_rotary)
    cos, sin = rope_tables(torch.arange(s, device=x.device), rot,
                           cfg.rope_theta)
    for i in range(cfg.n_layers):
        x, _, (k, v) = transformer_layer(layer_params(params["layers"], i),
                                         x, cfg, cos, sin)
        if on_kv is not None:
            on_kv(i, k, v)
    return x


def forward_seq(params, tokens, cfg: ModelConfig,
                collect_cache: bool = False):
    """Full-sequence forward.  Returns (hidden, aux, (k, v) stacked
    (L, B, S, Hk, hd) with ``collect_cache``, else None)."""
    kvs: list = []
    x = _run_layers(params, tokens, cfg,
                    (lambda i, k, v: kvs.append((k, v))) if collect_cache
                    else None)
    cache = None
    if collect_cache:
        cache = (torch.stack([k for k, _ in kvs]),
                 torch.stack([v for _, v in kvs]))
    return x, _zero_aux(x.device), cache


# ---------------------------------------------------------------- serving
def cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    """Logical description of the decode cache: {name: (shape, axes,
    dtype)}."""
    check_supported(cfg)
    kv = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    axes = ("layers", "batch", "kv_seq", "kv_heads", "qkv")
    return {"k": (kv, axes, cfg.dtype), "v": (kv, axes, cfg.dtype),
            "pos": ((), (), "int32")}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Zeroed k and v (L, B, T, Hk, hd) on ``device`` (default ``cuda``),
    and ``pos``, which the port keeps as a Python int: the host always
    knows it, so a decode step never waits for the card to read it."""
    dev = resolve_device(device)
    out = {name: torch.zeros(shape, dtype=torch_dtype(dt), device=dev)
           for name, (shape, _, dt) in cache_spec(cfg, batch,
                                                  cache_len).items()
           if shape}
    out["pos"] = 0
    return out


def prefill(params, tokens, cfg: ModelConfig, cache_len: int):
    """Run the prompt (B, S), return (last-token logits (B, 1, V) f32,
    populated cache).  Each layer's keys and values go straight into the
    cache, not through a stacked copy."""
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens exceeds cache_len "
                         f"{cache_len}")
    cache = init_cache(cfg, b, cache_len, device=tokens.device)

    def store(i, k, v):
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v

    x = _run_layers(params, tokens, cfg, store)
    cache["pos"] = s
    return _unembed(params, x[:, -1:], cfg), cache


def decode_step(params, token, cache, cfg: ModelConfig):
    """token: (B,) int, the token at position ``cache["pos"]``.  Returns
    (logits (B, 1, V) f32, cache).  The k and v tensors are updated in
    place (one slot per layer); the returned dict holds them and the
    advanced ``pos``."""
    check_supported(cfg)
    pos = int(cache["pos"])
    kall, vall = cache["k"], cache["v"]
    if pos >= kall.shape[2]:
        raise ValueError(f"the cache of {kall.shape[2]} slots is full")
    x = _embed(params, token)[:, None, :]                  # (B, 1, D)
    rot = int(cfg.hd * cfg.partial_rotary)
    cos, sin = rope_tables(torch.tensor([pos], device=x.device), rot,
                           cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        xn = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = torch.einsum("bsd,dhk->bshk", xn, lp["attn"]["wq"])
        kn = torch.einsum("bsd,dhk->bshk", xn, lp["attn"]["wk"])
        vn = torch.einsum("bsd,dhk->bshk", xn, lp["attn"]["wv"])
        q = apply_rope(q, cos, sin, rot)
        kn = apply_rope(kn, cos, sin, rot)
        kall[i, :, pos] = kn[:, 0].to(kall.dtype)
        vall[i, :, pos] = vn[:, 0].to(vall.dtype)
        o = decode_attention(q, kall[i], vall[i], pos)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        f, _ = ffn_block(lp, x, cfg)
        x = (x + f).to(x.dtype)
    logits = _unembed(params, x, cfg)
    return logits, dict(cache, pos=pos + 1)
