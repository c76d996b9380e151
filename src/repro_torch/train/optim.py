"""Optimizers: AdamW (f32 state), Adafactor (factored second moment) and
8-bit Adam (int8 block-quantized moments), and the learning-rate
schedule.

Port of ``repro/train/optim.py`` (``optim.py:1-180``).  States are nested
dicts of tensors that mirror the parameters, with the reference's keys
(``mu``/``nu``/``count``; ``v`` of ``{"vr", "vc"}`` or ``{"v"}`` leaves;
``q`` of ``{"mu_q", "mu_s", "nu_q", "nu_s"}`` leaves), so a checkpoint
of either package names the same files; ``torch.optim`` is not used.
An update runs under ``torch.no_grad()`` leaf by leaf and writes the
new moments into the state's own tensors, so a full-width state never
holds two f32 copies of the model; ``apply=True`` also adds each leaf's
update to its parameter in place, ``(p.float() + u).to(p.dtype)``, and
returns no update tree.

Adafactor also updates a chunk of a leaf (ZeRO-1, FSDP and tensor
parallelism over ranks, ``train/step.py``): with ``shards`` (each
leaf's ``sharding.collective.Shard``, or a tuple of its data and model
splits, on different dims; None for whole) a mean over a split dim is
the chunk's sum all-reduced over that split's group and divided by the
whole extent, a mean over any other dim stays local, and the update's
RMS is always the whole leaf's.  The factors a rank keeps are those
``abstract_state`` describes: a chunk where the factor keeps the split
dim, whole on that line (the same on its every rank) where it was
averaged away.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

Q_BLOCK = 256
F32 = torch.float32


# ------------------------------------------------------------------ trees
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts.  ``tree`` gives the
    structure; ``rest`` are indexed by the same keys, so where ``tree``
    has a leaf they may hold a subtree (an optimizer's per-parameter
    state dict), which ``fn`` receives whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts (in sorted-key order, JAX's order for
    dicts) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ----------------------------------------------------------------- schedule
def lr_schedule(base_lr: float, warmup: int = 100,
                total: int = 10_000) -> Callable:
    """step (int or tensor) -> f32 learning rate: linear warmup, then a
    cosine from 1 to 0.1 of ``base_lr``."""
    def fn(step):
        s = torch.as_tensor(step).to(F32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, 0.1 + 0.9 * cos)
    return fn


def _count(state) -> tuple[torch.Tensor, torch.Tensor]:
    count = state["count"] + 1
    return count, count.to(F32)


def _finish(u, p, apply: bool):
    """The leaf's update, or, with ``apply``, None after adding it to
    ``p`` in place."""
    if not apply:
        return u
    p.copy_((p.to(F32) + u).to(p.dtype))
    return None


# -------------------------------------------------------------------- AdamW
def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    some = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=some.device)}


@torch.no_grad()
def adamw_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, apply: bool = False):
    count, cf = _count(state)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf

    def upd(g, mu, nu, p):
        g = g.to(F32)
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        step = step + weight_decay * p.to(F32)
        return _finish(-lr * step, p, apply)

    updates = tree_map(upd, grads, state["mu"], state["nu"], params)
    return (None if apply else updates), {"mu": state["mu"],
                                          "nu": state["nu"], "count": count}


# ---------------------------------------------------------------- Adafactor
def adafactor_init(params):
    def one(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=F32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
    some = tree_leaves(params)[0]
    return {"v": tree_map(one, params),
            "count": torch.zeros((), dtype=torch.int32, device=some.device)}


def _splits(sh) -> tuple:
    """A leaf's splits as a tuple of ``Shard``s (from one, a tuple of
    them or None)."""
    if sh is None:
        return ()
    return tuple(x for x in (sh if isinstance(sh, tuple) else (sh,))
                 if x is not None)


def _mean(x, dim: int, sh, at: int, keepdim: bool = False):
    """``torch.mean`` of ``x`` over ``dim``, the leaf's dim ``at``; where
    a split of ``sh`` (:func:`_splits`) splits that dim, the chunk's sum
    all-reduced over the split's group over the whole extent."""
    split = next((x for x in _splits(sh) if x.dim == at), None)
    if split is None:
        return torch.mean(x, dim=dim, keepdim=keepdim)
    total = torch.sum(x, dim=dim, keepdim=keepdim)
    dist.all_reduce(total, group=split.group)
    return total / split.full


@torch.no_grad()
def adafactor_update(grads, state, params, lr, *, decay=0.8, eps=1e-30,
                     clip=1.0, weight_decay=0.0, apply: bool = False,
                     shards=None):
    count, cf = _count(state)
    beta = 1.0 - cf ** (-decay)

    def upd(g, v, p, sh=None):
        g = g.to(F32)
        g2 = g * g + eps
        n = g.dim()
        if n >= 2:
            vr, vc = v["vr"], v["vc"]
            vr.copy_(beta * vr + (1 - beta) * _mean(g2, -1, sh, n - 1))
            vc.copy_(beta * vc + (1 - beta) * _mean(g2, -2, sh, n - 2))
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :] /
                torch.clamp(_mean(vr, -1, sh, n - 2, keepdim=True)[..., None],
                            min=eps))
        else:
            v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
            denom = torch.sqrt(v["v"])
        u = g / torch.clamp(denom, min=eps)
        # update clipping by RMS (over the whole leaf)
        splits = _splits(sh)
        if not splits:
            ms = torch.mean(u * u)
        else:
            ms, n = torch.sum(u * u), u.numel()
            for split in splits:
                dist.all_reduce(ms, group=split.group)
                n *= split.count
            ms = ms / n
        rms = torch.sqrt(ms + eps)
        u = u / torch.clamp(rms / clip, min=1.0)
        u = u + weight_decay * p.to(F32)
        return _finish(-lr * u, p, apply)

    rest = () if shards is None else (shards,)
    updates = tree_map(upd, grads, state["v"], params, *rest)
    return (None if apply else updates), {"v": state["v"], "count": count}


# --------------------------------------------------------------- 8-bit Adam
def _q_shape(p):
    n = p.numel()
    return n, -(-n // Q_BLOCK)


def quantize_blockwise(x: torch.Tensor):
    """f32 -> (int8 codes (blocks, Q_BLOCK), f32 per-block scales).
    Symmetric linear, round half to even."""
    n = x.numel()
    blocks = -(-n // Q_BLOCK)
    flat = torch.nn.functional.pad(x.reshape(-1), (0, blocks * Q_BLOCK - n)) \
        .reshape(blocks, Q_BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = (q.to(F32) * scale[:, None]).reshape(-1)
    n = math.prod(shape)
    return flat[:n].reshape(shape)


def adam8bit_init(params):
    def one(p):
        _, blocks = _q_shape(p)
        z8 = lambda: torch.zeros((blocks, Q_BLOCK), dtype=torch.int8,
                                 device=p.device)
        zs = lambda: torch.zeros((blocks,), dtype=F32, device=p.device)
        return {"mu_q": z8(), "mu_s": zs(), "nu_q": z8(), "nu_s": zs()}
    some = tree_leaves(params)[0]
    return {"q": tree_map(one, params),
            "count": torch.zeros((), dtype=torch.int32, device=some.device)}


@torch.no_grad()
def adam8bit_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                    weight_decay=0.1, apply: bool = False):
    count, cf = _count(state)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf

    def upd(g, q, p):
        g = g.to(F32)
        mu = dequantize_blockwise(q["mu_q"], q["mu_s"], g.shape)
        nu = dequantize_blockwise(q["nu_q"], q["nu_s"], g.shape)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        step = (mu / bc1) / (torch.sqrt(torch.clamp(nu, min=0.0) / bc2) + eps)
        step = step + weight_decay * p.to(F32)
        for name, x in (("mu", mu), ("nu", nu)):
            codes, scale = quantize_blockwise(x)
            q[f"{name}_q"].copy_(codes)
            q[f"{name}_s"].copy_(scale)
        return _finish(-lr * step, p, apply)

    updates = tree_map(upd, grads, state["q"], params)
    return (None if apply else updates), {"q": state["q"], "count": count}


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
    "adamw8bit": (adam8bit_init, adam8bit_update),
}
