"""Decoder-only LM of the dense, moe, ssm, hybrid and vlm families:
full-sequence forward, prefill and greedy-decode steps against a cache.

Port of ``repro/models/transformer.py`` (``transformer.py:28-512``).
Parameters are nested dicts of tensors with the reference's leaf names;
the stacked ``layers`` tensors (leading dim L) run as a Python loop,
each layer (each hybrid super-block) wrapped by :func:`_remat`.  Modes:

* ``lm_loss``: tokens + labels -> (loss, metrics), the training loss;
* ``forward_seq``: tokens (after an optional ``prefix_embeds``) ->
  final hidden states (and the per-layer keys and values with
  ``collect_cache``);
* ``prefill``: tokens -> (last-position logits, populated cache);
* ``decode_step``: one token + cache -> (logits, cache).

On a CUDA tensor the full-sequence attention is the hand-written
``kernels.ops.flash_attention`` (causal from position 0, with the
configuration's sliding window: for those inputs it computes what
``dense_attention`` computes, with q scaled in f32), called through
``layers.flash_attention``, whose backward is that of
:func:`plain_attention`; on the CPU it is :func:`plain_attention`,
``dense_attention`` or ``chunked_attention`` picked as
``transformer.py:105`` picks them.  Decode attention, the MoE dispatch
and the SSD scan are plain torch on both, as the reference computes
them in jnp.  A sliding-window cache is a ring of min(cache_len,
window) slots: prefill keeps the last slots rolled so slot = pos % t,
and decode writes slot pos % t.

Under the training step's data parallelism over processes
(``sharding.collective.data_parallel``) each rank holds a block of the
microbatch's rows: the NLL's sum and its count of unmasked labels are
summed over the ranks before the division (the reference's mean is over
the whole microbatch), and :func:`_remat` re-enters the same group when
the backward pass recomputes a layer.

Under FSDP (the training step over ranks with ``run.fsdp``) the
parameters are each rank's chunks of their ``embed`` dim, tagged with
their ``Shard``.  :func:`layer_params` gives layer i's chunks, and the
layer function (:func:`transformer_layer`, :func:`_mamba_layer`), the
one :func:`_remat` checkpoints, gathers them first
(``collective.gathered``): the gathered weights are then the
checkpoint's own intermediates, not its inputs, so under ``remat=
"full"`` they are dropped after the layer and gathered again when the
backward pass recomputes it.  Under ``remat="none"`` autograd keeps
every gathered weight for the backward pass, so FSDP saves no
parameter memory there (as in the reference, whose GSPMD keeps them
too).  The leaves outside the layer stacks (``embed``, ``lm_head``,
the hybrid's ``shared`` block and ``shared_proj``) are gathered once
where the loss begins, so a tied ``embed`` has one gather, one
gradient and one reduce-scatter.  The norms are never sharded.

Under tensor parallelism (the training step over a ``model`` axis of
several ranks: ``collective.model_line()``) each rank
holds its chunks of the weights the guard puts on ``model`` and the
model reads the split from their shapes: attention runs the rank's
q heads (``wq`` by column, ``wo`` by row, then
``collective.from_model``) against its kv heads (split alike, or,
where the guard left ``wk`` / ``wv`` whole, the kv heads of its own q
heads, their gradient summed over the line by ``collective.to_model``
on the weights); the MLP is ``swiglu``'s split; the embedding looks up
the rank's vocabulary rows (other tokens give zeros) and sums over the
line (a vlm's prefix is concatenated after that sum, once); the head
gives the rank's vocabulary columns in f32, and the NLL takes its
logsumexp and the label's logit over the line
(``collective.model_max`` / ``from_model``); the MoE block splits as
``moe.moe_ffn`` says, the mamba mixer as ``mamba2.mamba_forward`` says;
the hybrid's shared block splits as the attention and MLP above in
every super-block, behind its ``shared_proj``, which the guard leaves
whole (every rank computes its input alike).  A tied head (mamba2)
takes both gradients on the rank's vocabulary rows: the lookup's and
the head's.

Serving over ranks (``zoo.prefill_fn`` / ``decode_fn`` with a mesh of
processes) runs the same forward on the rank's rows and chunks, with
the cache as the rank's chunk of the reference's layout
(:func:`cache_splits`): prefill's keys and values are joined whole over
the model line and each rank keeps its slots (:func:`_store_kv`); a
decode step attends every head over the rank's slots and merges the
ranks' partial softmax (:func:`_decode_attn_line`); the logits are
joined whole (:func:`_logits`).  The ssm and hybrid families serve over
the data axes alone (ROADMAP Queue A item 10(b)).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..kernels.dispatch import resolve_device
from ..sharding import collective
from ..sharding.logical import default_rules, guarded_sharding
from .layers import (F32, apply_rope, attention_specs, chunked_attention,
                     decode_attention, decode_partial, dense_attention,
                     flash_attention, mlp_specs, rmsnorm, rope_tables,
                     swiglu)
from .mamba2 import mamba_decode, mamba_dims, mamba_forward, mamba_specs
from .moe import moe_ffn, moe_specs
from .params import ParamSpec, map_specs, torch_dtype

ATTN_FAMILIES = ("dense", "moe", "vlm")


# --------------------------------------------------------------- specs
def _stack(specs: dict, n: int) -> dict:
    return map_specs(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                         s.init, s.scale, s.dtype), specs)


def block_specs(cfg: ModelConfig) -> dict:
    """One transformer block (attention + FFN or MoE)."""
    d = cfg.d_model
    sp = {
        "attn_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                               dtype="float32"),
        "attn": attention_specs(d, cfg.n_q_heads, cfg.n_kv_heads, cfg.hd),
        "mlp_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                              dtype="float32"),
    }
    if cfg.moe is not None:
        sp["moe"] = moe_specs(cfg)
    else:
        sp["mlp"] = mlp_specs(d, cfg.d_ff)
    return sp


def mamba_block_specs(cfg: ModelConfig) -> dict:
    return {
        "norm": ParamSpec((cfg.d_model,), ("embed_noshard",), init="ones",
                          dtype="float32"),
        "mixer": mamba_specs(cfg),
    }


def model_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab
    sp: dict = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="normal"),
        "final_norm": ParamSpec((d,), ("embed_noshard",), init="ones",
                                dtype="float32"),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
    if cfg.family in ATTN_FAMILIES:
        sp["layers"] = _stack(block_specs(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        sp["layers"] = _stack(mamba_block_specs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        n_inv = cfg.n_layers // cfg.shared_every
        sp["layers"] = _stack(mamba_block_specs(cfg), cfg.n_layers)
        sp["shared"] = block_specs(cfg)          # ONE shared block
        sp["shared_proj"] = ParamSpec((n_inv, 2 * d, d),
                                      ("layers", "embed", "embed_noshard"))
    else:
        raise ValueError(cfg.family)
    return sp


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors (of an
    FSDP chunk, a tagged chunk of the layer, ``collective.layer``)."""
    return {k: layer_params(v, i) if isinstance(v, dict)
            else collective.layer(v, i) for k, v in layers.items()}


def gather_outside(params: dict, stacks: tuple) -> dict:
    """``params`` with every FSDP chunk outside the layer stacks
    ``stacks`` gathered (once a microbatch, where the loss begins)."""
    return {k: v if k in stacks else collective.gathered(v)
            for k, v in params.items()}


# --------------------------------------------------------------- blocks
def _save_dots(ctx, op, *args, **kwargs):
    """The selective policy, the reference's
    ``dots_with_no_batch_dims_saveable``: save the output of every matmul
    without a batch dimension, recompute the rest (attention included).
    A 2-D ``x @ w`` dispatches to ``aten.mm``; an einsum such as
    ``bsd,dhk->bshk`` folds its free dimensions and dispatches to
    ``aten.bmm`` with a batch of 1.  (An attention product whose batch
    times kv heads is 1 is also a batch-1 ``bmm`` and is saved: memory
    differs, values do not.)"""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SELECTIVE = functools.partial(create_selective_checkpoint_contexts,
                               _save_dots)


def _needs_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(v) for v in tree)
    return False


def _remat(fn, cfg: ModelConfig):
    """``cfg.remat`` (ref ``transformer.py:85-92``): ``"none"`` returns
    ``fn``; ``"full"`` checkpoints it (activations recomputed in the
    backward pass); otherwise the selective policy :func:`_save_dots`.
    Non-reentrant ``torch.utils.checkpoint``; a call that records no
    gradient (grad mode off, or no tensor argument requiring grad) runs
    ``fn`` as it is.  The recompute runs in the data-parallel group
    active at the forward call: the backward pass may run it on another
    thread (the autograd engine's, on a card), where that context is
    not set."""
    if cfg.remat == "none":
        return fn
    kw = {} if cfg.remat == "full" else {"context_fn": _SELECTIVE}

    def run(*args):
        if not (torch.is_grad_enabled() and _needs_grad(args)):
            return fn(*args)
        dp = collective.active()

        def in_group(*a):
            with collective.data_parallel(dp):
                return fn(*a)
        return checkpoint(in_group, *args, use_reentrant=False, **kw)
    return run


def plain_attention(q, k, v, cfg: ModelConfig):
    """The reference's choice (``transformer.py:105``): dense attention
    for ``attn_impl="dense"`` or a sequence within one chunk, else the
    chunked online softmax; causal, with the configuration's window."""
    sq = q.shape[1]
    if cfg.attn_impl == "dense" or sq <= cfg.attn_chunk:
        return dense_attention(q, k, v, causal=True,
                               window=cfg.sliding_window)
    ck = min(cfg.attn_chunk, sq)
    return chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                             chunk_q=ck, chunk_k=ck)


def attention(q, k, v, cfg: ModelConfig):
    """Full-sequence causal attention of (B, S, H, hd) tensors with the
    configuration's sliding window: the flash kernel on a CUDA tensor,
    its gradient that of :func:`plain_attention`; :func:`plain_attention`
    on the CPU."""
    if not q.is_cuda:
        return plain_attention(q, k, v, cfg)
    return flash_attention(q, k, v, functools.partial(plain_attention,
                                                      cfg=cfg),
                           causal=True, window=cfg.sliding_window)


def _qkv(p: dict, xn, cfg: ModelConfig, cos, sin):
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xn, p["wv"])
    rot = int(cfg.hd * cfg.partial_rotary)
    return apply_rope(q, cos, sin, rot), apply_rope(k, cos, sin, rot), v


def _rank_heads(p: dict, cfg: ModelConfig) -> tuple:
    """(the attention weights this rank runs, whether its heads are a
    split of them).  Under tensor parallelism with ``wq`` holding the
    rank's q heads and ``wk`` / ``wv`` left whole by the guard, the kv
    heads of those q heads: a slice where they group evenly (as GQA
    groups them), else one kv head a q head; the whole weight passes
    ``collective.to_model`` first, so its gradient, a part on each
    rank, is summed over the line."""
    mp = collective.model_line()
    h = p["wq"].shape[-2]
    if mp is None or h == cfg.n_q_heads:
        return p, False
    if p["wk"].shape[-2] < cfg.n_kv_heads:
        return p, True                     # the kv heads split alike
    pick = _kv_pick(h, cfg, mp.index, p["wk"].device)
    return dict(p, wk=collective.to_model(p["wk"])[..., pick, :],
                wv=collective.to_model(p["wv"])[..., pick, :]), True


def _kv_pick(h: int, cfg: ModelConfig, index: int, device):
    """The kv heads of rank ``index``'s ``h`` q heads: a slice where they
    group evenly (as GQA groups them), else one kv head a q head (an
    index tensor)."""
    g = cfg.n_q_heads // cfg.n_kv_heads
    first = index * h
    kv = [(first + i) // g for i in range(h)]
    lo, used = kv[0], kv[-1] - kv[0] + 1
    if h % used == 0 and all(j - lo == i // (h // used)
                             for i, j in enumerate(kv)):
        return slice(lo, lo + used)
    return torch.tensor(kv, device=device)


def _whole_kv_weights(p: dict, cfg: ModelConfig) -> bool:
    """Whether, under a model line, the rank's q heads are a split while
    ``wk`` / ``wv`` are whole (the guard left the kv heads whole)."""
    return collective.model_line() is not None and \
        p["wq"].shape[-2] < cfg.n_q_heads and \
        p["wk"].shape[-2] == cfg.n_kv_heads


def attn_block(p: dict, x, cfg: ModelConfig, cos, sin,
               whole_kv: bool = False):
    """Full-sequence attention sub-block (pre-norm, residual outside).
    Returns (output, (k, v)).  Under tensor parallelism the rank's heads
    (:func:`_rank_heads`), the output's partial sums summed over the
    model line.  ``whole_kv`` (prefill over ranks, no gradient): where
    the kv weights are whole on the line, the keys and values of every
    kv head, computed from them (the rank's q heads attend to their own
    kv heads of those), for the cache."""
    xn = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    if whole_kv and _whole_kv_weights(p["attn"], cfg):
        q, k, v = _qkv(p["attn"], xn, cfg, cos, sin)
        pick = _kv_pick(q.shape[2], cfg, collective.model_line().index,
                        k.device)
        o = attention(q, k[:, :, pick], v[:, :, pick], cfg)
        out = torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"])
        return collective.from_model(out), (k, v)
    attn, split = _rank_heads(p["attn"], cfg)
    if split:
        xn = collective.to_model(xn)
    q, k, v = _qkv(attn, xn, cfg, cos, sin)
    o = attention(q, k, v, cfg)
    out = torch.einsum("bshk,hkd->bsd", o, attn["wo"])
    return (collective.from_model(out) if split else out), (k, v)


def _zero_aux(device) -> dict:
    z = torch.zeros((), dtype=F32, device=device)
    return {"load_balance": z, "router_z": z}


def ffn_block(p: dict, x, cfg: ModelConfig):
    xn = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.moe is not None:
        return moe_ffn(p["moe"], xn, cfg)
    return swiglu(p["mlp"], xn, cfg.d_ff), _zero_aux(x.device)


def transformer_layer(p, x, cfg: ModelConfig, cos, sin,
                      whole_kv: bool = False):
    p = collective.gathered(p)
    a, kv = attn_block(p, x, cfg, cos, sin, whole_kv)
    x = x + a
    f, aux = ffn_block(p, x, cfg)
    return (x + f).to(x.dtype), aux, kv


def _mamba_layer(lp: dict, h, cfg: ModelConfig, cache=None):
    lp = collective.gathered(lp)
    y, nc = mamba_forward(lp["mixer"], rmsnorm(h, lp["norm"], cfg.norm_eps),
                          cfg, cache=cache)
    return (h + y).to(h.dtype), nc


# --------------------------------------------- full-sequence forward pass
def _vocab_split(w: torch.Tensor, dim: int, vocab: int | None):
    """The active model line where ``w``'s ``dim`` holds the rank's chunk
    of the vocabulary (fewer than ``vocab`` entries), else None."""
    mp = collective.model_line()
    if mp is None or vocab is None or w.shape[dim] == vocab:
        return None
    return mp


def _embed(params, tokens, prefix_embeds=None, vocab: int | None = None):
    """The token embeddings.  Under tensor parallelism with ``embed``
    holding the rank's rows of the ``vocab``: those tokens' rows, zeros
    for the others, summed over the model line."""
    emb = params["embed"]
    mp = _vocab_split(emb, 0, vocab)
    if mp is None:
        x = emb[tokens.long()]
    else:
        n = emb.shape[0]
        t = tokens.long() - mp.index * n
        mine = (t >= 0) & (t < n)
        x = collective.from_model(torch.where(
            mine[..., None], emb[t.clamp(0, n - 1)], 0))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _unembed(params, x, cfg: ModelConfig):
    """Logits in f32: the operands are cast to f32 first, as the
    reference's ``preferred_element_type=float32`` keeps them.  Under
    tensor parallelism with the head split by vocabulary: the rank's
    columns (the normed input through ``collective.to_model``)."""
    xn = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if _vocab_split(w, 0 if cfg.tie_embeddings else 1, cfg.vocab):
        xn = collective.to_model(xn)
    xn = xn.to(F32)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", xn, w.to(F32))
    return xn @ w.to(F32)


def _rope(s: int, cfg: ModelConfig, device):
    return rope_tables(torch.arange(s, device=device),
                       int(cfg.hd * cfg.partial_rotary), cfg.rope_theta)


def _run_layers(params, x, cfg: ModelConfig, on_kv=None,
                whole_kv: bool = False):
    """Run every transformer layer over embedded ``x``; ``on_kv(i, k,
    v)`` receives layer i's keys and values (B, S, Hk, hd; under a model
    line the rank's kv heads, or with ``whole_kv`` every kv head where
    the kv weights are whole).  Returns (hidden, aux summed over the
    layers)."""
    cos, sin = _rope(x.shape[1], cfg, x.device)
    aux = _zero_aux(x.device)
    layer = _remat(transformer_layer, cfg)
    for i in range(cfg.n_layers):
        x, a, (k, v) = layer(layer_params(params["layers"], i), x, cfg, cos,
                             sin, whole_kv)
        aux = {n: aux[n] + a[n] for n in aux}
        if on_kv is not None:
            on_kv(i, k, v)
    return x, aux


def _super_block(params, h, x0, j: int, cfg: ModelConfig, cos, sin,
                 cache=None):
    """Hybrid super-block j: ``shared_every`` mamba layers, then the
    SHARED attention block on their output concatenated with the
    embeddings ``x0``.  Returns (hidden, the block's (k, v))."""
    k = cfg.shared_every
    shared = params["shared"]
    for i in range(j * k, (j + 1) * k):
        lc = None if cache is None else {"conv": cache["conv"][i],
                                         "ssm": cache["ssm"][i]}
        h, nc = _mamba_layer(layer_params(params["layers"], i), h, cfg, lc)
        if cache is not None:
            cache["conv"][i], cache["ssm"][i] = nc["conv"], nc["ssm"]
    inp2 = torch.cat([h, x0], dim=-1) @ params["shared_proj"][j]
    a, kv = attn_block(shared, inp2, cfg, cos, sin)
    f, _ = ffn_block(shared, inp2 + a, cfg)
    return (h + a + f).to(h.dtype), kv


def _hybrid_layers(params, x, cfg: ModelConfig, cache=None, on_kv=None):
    """Zamba2-style: super-blocks of ``shared_every`` mamba layers, each
    followed by one invocation of the SHARED attention block (common
    weights, per-invocation concat down-projection), each super-block
    under :func:`_remat` (ref ``transformer.py:229``).  With ``cache``
    the mamba layers start from and update its conv and ssm state
    (layer by layer); ``on_kv(j, k, v)`` receives invocation j's keys
    and values."""
    cos, sin = _rope(x.shape[1], cfg, x.device)
    x0 = x                                 # residual stream of embeddings
    block = _remat(_super_block, cfg)
    for j in range(cfg.n_layers // cfg.shared_every):
        x, kv = block(params, x, x0, j, cfg, cos, sin, cache)
        if on_kv is not None:
            on_kv(j, *kv)
    return x


def forward_seq(params, tokens, cfg: ModelConfig, prefix_embeds=None,
                collect_cache: bool = False):
    """Full-sequence forward.  Returns (hidden, aux, (k, v) stacked
    (L, B, S, Hk, hd) with ``collect_cache`` for the attention families,
    else None)."""
    x = _embed(params, tokens, prefix_embeds, cfg.vocab)
    if cfg.family in ATTN_FAMILIES:
        kvs: list = []
        x, aux = _run_layers(params, x, cfg,
                             (lambda i, k, v: kvs.append((k, v)))
                             if collect_cache else None)
        cache = None
        if collect_cache:
            cache = (torch.stack([k for k, _ in kvs]),
                     torch.stack([v for _, v in kvs]))
        return x, aux, cache
    if cfg.family == "ssm":
        layer = _remat(_mamba_layer, cfg)
        for i in range(cfg.n_layers):
            x, _ = layer(layer_params(params["layers"], i), x, cfg)
        return x, _zero_aux(x.device), None
    if cfg.family == "hybrid":
        return _hybrid_layers(params, x, cfg), _zero_aux(x.device), None
    raise ValueError(cfg.family)


# --------------------------------------------------------------- training
def lm_loss(params, batch: dict, cfg: ModelConfig):
    """batch: tokens (B, S) int, labels (B, S) int (-1 = masked),
    optional prefix_embeds (B, P, D).  The masked mean negative
    log-likelihood in f32 over ``logsumexp`` of the f32 logits (the vlm
    prefix positions dropped), plus the MoE router terms weighted by
    ``router_aux_weight`` and ``router_z_weight`` (ref
    ``transformer.py:235-253``).  Returns (loss, {"nll", "load_balance",
    "router_z"})."""
    params = gather_outside(params, ("layers",))
    prefix = batch.get("prefix_embeds")
    x, aux, _ = forward_seq(params, batch["tokens"], cfg, prefix)
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    return _nll_loss(_unembed(params, x, cfg), batch["labels"], cfg, aux)


def _nll_loss(logits, labels, cfg: ModelConfig, aux: dict | None):
    """The masked mean NLL of f32 ``logits`` against ``labels`` (-1 =
    masked), plus the MoE terms of ``aux`` when ``cfg.moe`` is set.
    Under data parallelism the sum and the count are the group's
    (``collective.global_sum``): every rank's value is the microbatch's,
    its gradient the part through its own rows.  Under tensor
    parallelism with ``logits`` the rank's vocabulary columns the
    logsumexp shifts by the line's max and sums over it, and the label's
    logit comes from the rank that holds it."""
    logits = logits.to(F32)
    labels = labels.long()
    mask = (labels >= 0).to(F32)
    safe = torch.clamp(labels, min=0)
    mp = _vocab_split(logits, -1, cfg.vocab)
    if mp is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        m = collective.model_max(torch.amax(logits.detach(), dim=-1))
        lse = m + torch.log(collective.from_model(
            torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
        t = safe - mp.index * n
        mine = (t >= 0) & (t < n)
        ll = collective.from_model(torch.where(
            mine, torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])
            [..., 0], 0.0))
    total, count = collective.global_sum(
        torch.stack([torch.sum((lse - ll) * mask), torch.sum(mask)]))
    nll = total / torch.clamp(count, min=1.0)
    if aux is None:
        return nll, {"nll": nll}
    loss = nll
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux["load_balance"] \
                    + cfg.moe.router_z_weight * aux["router_z"]
    return loss, {"nll": nll, **aux}


# ---------------------------------------------------------------- serving
def cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    """Logical description of the decode cache: {name: (shape, axes,
    dtype)}."""
    out = {}
    t = cache_len
    if cfg.sliding_window is not None:
        t = min(cache_len, cfg.sliding_window)
    axes = ("layers", "batch", "kv_seq", "kv_heads", "qkv")
    if cfg.family in ATTN_FAMILIES:
        kv = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.hd)
        out["k"] = (kv, axes, cfg.dtype)
        out["v"] = (kv, axes, cfg.dtype)
    elif cfg.family in ("ssm", "hybrid"):
        _, n_heads, conv_dim = mamba_dims(cfg)
        s = cfg.ssm
        out["conv"] = ((cfg.n_layers, batch, s.d_conv - 1, conv_dim),
                       ("layers", "batch", "conv", "ssm_inner"), cfg.dtype)
        out["ssm"] = ((cfg.n_layers, batch, n_heads, s.head_dim, s.d_state),
                      ("layers", "batch", "ssm_inner", "qkv", "ssm_state"),
                      "float32")
        if cfg.family == "hybrid":
            n_inv = cfg.n_layers // cfg.shared_every
            kv = (n_inv, batch, t, cfg.n_kv_heads, cfg.hd)
            out["k"] = (kv, axes, cfg.dtype)
            out["v"] = (kv, axes, cfg.dtype)
    out["pos"] = ((), (), "int32")
    return out


def zeros_cache(spec: dict, device, splits: dict | None = None) -> dict:
    """Zeroed tensors of a cache spec on ``device``, and ``pos`` = 0,
    which the port keeps as a Python int: the host always knows it, so
    a decode step never waits for the card to read it.  ``splits``
    (:func:`cache_splits`) gives each tensor as a rank holds it: its
    chunk, tagged with its data and model ``Shard``s."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, _, dt) in spec.items():
        if not shape:
            continue
        sh, m = (splits or {}).get(name, (None, None))
        for x in (sh, m):
            if x is not None:
                shape = x.shape(shape)
        out[name] = collective.tag_model(collective.tag(torch.zeros(
            shape, dtype=torch_dtype(dt), device=dev), sh), m)
    out["pos"] = 0
    return out


def cache_splits(cfg: ModelConfig, batch: int, cache_len: int,
                 mesh) -> dict:
    """Per cache tensor (``cache_spec`` of the global ``batch``) the
    (data ``Shard``, model ``Shard``) of this rank's chunk over a mesh of
    ranks, from its guarded sharding under ``default_rules()`` (FSDP
    moves no cache axis), as the reference's dry-run lays the cache out:
    ``batch`` on the data axes, ``kv_seq`` on ``model``, ``kv_heads`` on
    ``model`` only where ``kv_seq`` does not divide the line (the guard
    uses an axis once a tensor), each None where the guard leaves the
    dim whole."""
    rules = default_rules()
    dp = tuple(a for a in collective.DP_AXES if a in mesh.axis_names)
    out = {}
    for name, (shape, axes, _) in cache_spec(cfg, batch, cache_len).items():
        if not shape:
            continue
        spec = guarded_sharding(shape, axes, rules, mesh).spec
        out[name] = (collective.shard_for(spec, shape, mesh, dp),
                     collective.model_split(spec, shape, mesh, dp))
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               mesh=None):
    """The zeroed cache of :func:`cache_spec` on ``device`` (default
    ``cuda``); over a mesh of ranks (``mesh.group``) this rank's chunks
    of it (:func:`cache_splits`, ``batch`` the global batch)."""
    splits = None
    if mesh is not None and getattr(mesh, "group", None) is not None:
        splits = cache_splits(cfg, batch, cache_len, mesh)
    return zeros_cache(cache_spec(cfg, batch, cache_len), device, splits)


def _cache_slots(k: torch.Tensor) -> int:
    """The whole cache's slot count of a (chunk of a) k cache."""
    m = collective.model_of(k)
    return m.full if m is not None and m.dim == 2 else k.shape[2]


def _store_kv(cache, total: int, roll: bool):
    """``on_kv`` writing layer i's keys and values straight into the
    cache: positions 0..total-1 from slot 0, or, for a sliding window
    with more positions than slots, the last t rotated so slot =
    pos % t (``transformer.py:305-312``).  Over a model line the cache
    may hold the rank's chunk of the slots (``kv_seq``) or of the kv
    heads: the rank's kv heads are gathered whole over the line where
    the cache holds them all (the roll then runs on the whole, so slot
    s lives on the rank that owns s), and a rank keeps its own slots or
    heads."""
    split = collective.model_of(cache["k"])
    slots, heads = _cache_slots(cache["k"]), cache["k"].shape[3]

    def fit(x):
        if x.shape[2] < heads:          # the rank's kv heads of all
            x = collective.model_gather(x, 2)
        elif x.shape[2] > heads:        # all kv heads, the rank's kept
            x = x.narrow(2, split.index * heads, heads)
        if roll and total > slots:
            x = torch.roll(x[:, total - slots:], total % slots, dims=1)
        if split is not None and split.dim == 2:
            x = x[:, split.index * split.size:(split.index + 1) * split.size]
        return x

    def store(i, k, v):
        k, v = fit(k), fit(v)
        cache["k"][i, :, :k.shape[1]] = k
        cache["v"][i, :, :v.shape[1]] = v
    return store


def _refuse_on_line(cfg: ModelConfig, what: str) -> None:
    if collective.model_line() is not None and \
            cfg.family not in ATTN_FAMILIES:
        raise NotImplementedError(
            f"{what} of the {cfg.family} family over a model line of ranks "
            "is not ported (ROADMAP Queue A item 10(b))")


def _logits(params, x, cfg: ModelConfig):
    """The f32 logits of every vocabulary entry: under a model line with
    the head split by vocabulary, the ranks' columns gathered."""
    out = _unembed(params, x, cfg)
    if out.shape[-1] < cfg.vocab:
        out = collective.model_gather(out, -1)
    return out


def prefill(params, tokens, cfg: ModelConfig, cache_len: int,
            prefix_embeds=None, mesh=None):
    """Run the prompt (B, S) (after ``prefix_embeds`` (B, P, D) for a
    vlm), return (last-token logits (B, 1, V) f32, populated cache).
    Each layer's keys and values go straight into the cache, not
    through a stacked copy.

    Over a mesh of ranks (``mesh.group``, inside the group of
    ``zoo.prefill_fn``'s ``mesh``: ``collective.data_parallel``, whose
    size is the data line's) the rows are this rank's block of the
    batch, the parameters its chunks (``zoo.rank_params``; FSDP chunks
    are gathered a layer at a time) and the cache its chunk
    (:func:`cache_splits`); the forward is the tensor-parallel one of
    the training step, and the logits are whole.  The ssm and hybrid families run over the data
    axes only: under a model line they raise ``NotImplementedError``
    (ROADMAP Queue A item 10(b))."""
    _refuse_on_line(cfg, "prefill")
    b, s = tokens.shape
    total = s + (0 if prefix_embeds is None else prefix_embeds.shape[1])
    if total > cache_len and (cfg.sliding_window is None
                              or cfg.family not in ATTN_FAMILIES):
        raise ValueError(f"prompt of {total} positions exceeds cache_len "
                         f"{cache_len}")
    dp = collective.active() if mesh is not None else None
    cache = init_cache(cfg, b * (dp.size if dp is not None else 1),
                       cache_len, device=tokens.device, mesh=mesh)
    params = gather_outside(params, ("layers",))
    x = _embed(params, tokens, prefix_embeds, cfg.vocab)
    if cfg.family in ATTN_FAMILIES:
        x, _ = _run_layers(params, x, cfg, _store_kv(
            cache, total, roll=cfg.sliding_window is not None),
            whole_kv=collective.model_line() is not None)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, nc = _mamba_layer(layer_params(params["layers"], i), x, cfg,
                                 {"conv": cache["conv"][i],
                                  "ssm": cache["ssm"][i]})
            cache["conv"][i], cache["ssm"][i] = nc["conv"], nc["ssm"]
    elif cfg.family == "hybrid":
        x = _hybrid_layers(params, x, cfg, cache,
                           _store_kv(cache, total, roll=False))
    else:
        raise ValueError(cfg.family)
    cache["pos"] = total
    return _logits(params, x[:, -1:], cfg), cache


def _decode_attn(p: dict, xn, kall, vall, i: int, slot: int, pos: int,
                 cfg: ModelConfig, cos, sin, window):
    """One token's attention sub-block against cache layer ``i``: its
    key and value written at ``slot``; returns the projected output
    (under a model line :func:`_decode_attn_line`)."""
    if collective.model_line() is not None:
        return _decode_attn_line(p, xn, kall, vall, i, slot, pos, cfg, cos,
                                 sin, window)
    q, kn, vn = _qkv(p["attn"], xn, cfg, cos, sin)
    kall[i, :, slot] = kn[:, 0].to(kall.dtype)
    vall[i, :, slot] = vn[:, 0].to(vall.dtype)
    o = decode_attention(q, kall[i], vall[i], pos, window=window)
    return torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"])


def _decode_attn_line(p: dict, xn, kall, vall, i: int, slot: int, pos: int,
                      cfg: ModelConfig, cos, sin, window):
    """:func:`_decode_attn` over a model line.  The rank computes q and
    the new key and value of its heads (:func:`_rank_heads`).  Where the
    cache holds the rank's kv heads (``kv_heads`` on ``model``) it
    writes them and attends its own heads.  Otherwise the new key and
    value are joined whole (gathered, or computed from whole kv
    weights), written by the rank that holds ``slot`` (every rank where
    the cache is whole on the line), q is gathered whole, and each rank
    attends every head over its slots (the mask read at global slot
    indices: ``layers.decode_partial``), the parts merged over the line
    in f32 (``collective.merge_softmax``); the rank keeps its heads of
    the output.  The row-split ``wo``'s partial sums are summed over the
    line."""
    mp = collective.model_line()
    attn, split = _rank_heads(p["attn"], cfg)
    h = attn["wq"].shape[-2]
    cs = collective.model_of(kall)
    if cs is not None and cs.dim == 3:
        q, kn, vn = _qkv(attn, xn, cfg, cos, sin)
        if kn.shape[2] != kall.shape[3]:
            raise ValueError(f"the cache holds {kall.shape[3]} kv heads a "
                             f"rank, the weights {kn.shape[2]}")
        kall[i, :, slot] = kn[:, 0].to(kall.dtype)
        vall[i, :, slot] = vn[:, 0].to(vall.dtype)
        o = decode_attention(q, kall[i], vall[i], pos, window=window)
    else:
        whole = _whole_kv_weights(p["attn"], cfg)
        q, kn, vn = _qkv(p["attn"] if whole else attn, xn, cfg, cos, sin)
        if kn.shape[2] < cfg.n_kv_heads:
            kn, vn = (collective.model_gather(kn, 2),
                      collective.model_gather(vn, 2))
        if split:
            q = collective.model_gather(q, 2)
        lo = 0 if cs is None else cs.index * cs.size
        if lo <= slot < lo + kall.shape[2]:
            kall[i, :, slot - lo] = kn[:, 0].to(kall.dtype)
            vall[i, :, slot - lo] = vn[:, 0].to(vall.dtype)
        if cs is None:
            o = decode_attention(q, kall[i], vall[i], pos, window=window)
        else:
            m, l, part = decode_partial(q, kall[i], vall[i], pos, lo,
                                        cs.full, window)
            o = collective.merge_softmax(m, l, part).to(vall.dtype) \
                .reshape(q.shape)
        if split:
            o = o[:, :, mp.index * h:(mp.index + 1) * h]
    out = torch.einsum("bshk,hkd->bsd", o, attn["wo"])
    return collective.from_model(out) if split else out


def decode_step(params, token, cache, cfg: ModelConfig):
    """token: (B,) int, the token at position ``cache["pos"]``.  Returns
    (logits (B, 1, V) f32, cache).  The cache tensors are updated in
    place (one slot per layer, or the layer's conv and ssm state); the
    returned dict holds them and the advanced ``pos``.  Over ranks (as
    :func:`prefill`) the cache is the rank's chunk that prefill made,
    the layers' FSDP chunks are gathered one layer at a time, and the
    attention runs as :func:`_decode_attn_line` says."""
    _refuse_on_line(cfg, "a decode step")
    pos = int(cache["pos"])
    params = gather_outside(params, ("layers",))
    x = _embed(params, token, vocab=cfg.vocab)[:, None, :]  # (B, 1, D)
    cos, sin = rope_tables(torch.tensor([pos], device=x.device),
                           int(cfg.hd * cfg.partial_rotary), cfg.rope_theta)
    if "k" in cache:
        t = _cache_slots(cache["k"])
        window = cfg.sliding_window if cfg.family in ATTN_FAMILIES else None
        if window is None and pos >= t:
            raise ValueError(f"the cache of {t} slots is full")
        slot = pos % t if window is not None else pos

    if cfg.family in ATTN_FAMILIES:
        for i in range(cfg.n_layers):
            lp = collective.gathered(layer_params(params["layers"], i))
            xn = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
            x = x + _decode_attn(lp, xn, cache["k"], cache["v"], i, slot,
                                 pos, cfg, cos, sin, window)
            f, _ = ffn_block(lp, x, cfg)
            x = (x + f).to(x.dtype)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _mamba_decode_layer(params, x, cache, cfg, i)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, x, cache, cfg, cos, sin, pos)
    else:
        raise ValueError(cfg.family)
    logits = _logits(params, x, cfg)
    return logits, dict(cache, pos=pos + 1)


def _mamba_decode_layer(params, h, cache, cfg: ModelConfig, i: int):
    lp = collective.gathered(layer_params(params["layers"], i))
    y, nc = mamba_decode(lp["mixer"], rmsnorm(h, lp["norm"], cfg.norm_eps),
                         cfg, {"conv": cache["conv"][i],
                               "ssm": cache["ssm"][i]})
    cache["conv"][i], cache["ssm"][i] = nc["conv"], nc["ssm"]
    return (h + y).to(h.dtype)


def _hybrid_decode(params, x, cache, cfg: ModelConfig, cos, sin, pos: int):
    k = cfg.shared_every
    x0 = x
    shared = params["shared"]
    for j in range(cfg.n_layers // k):
        h = x
        for i in range(j * k, (j + 1) * k):
            h = _mamba_decode_layer(params, h, cache, cfg, i)
        inp2 = torch.cat([h, x0], dim=-1) @ params["shared_proj"][j]
        xn = rmsnorm(inp2, shared["attn_norm"], cfg.norm_eps)
        a = _decode_attn(shared, xn, cache["k"], cache["v"], j, pos, pos,
                         cfg, cos, sin, None)
        f, _ = ffn_block(shared, inp2 + a, cfg)
        x = (h + a + f).to(h.dtype)
    return x
