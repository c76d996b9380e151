"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Port of ``repro/models/moe.py`` (``moe.py:19-136``): flatten the
tokens, take each token's top-k experts, sort the assignments by expert
(stable), give each its position within its expert's segment, drop those
beyond capacity, gather the kept tokens into (E, cap, D) buffers, run
the experts' SwiGLU as batched products and scatter-add the gated
outputs back.  Router math in f32 with the load-balance and z losses.
The expert products are plain ``torch.einsum`` (batched matmuls), as the
reference computes them outside any Pallas kernel.

A dropped assignment is written to slot ``a`` (the number of
assignments), as the reference writes it: past the (E * cap + 1)-slot
table that write is discarded (JAX drops out-of-bounds scatter
updates); inside it, it lands on a real slot, and of several writes to
one slot the last in sorted order stays, as the reference's sequential
scatter leaves it on the CPU.  So when E * cap > a and an assignment is
dropped from an expert at or after slot ``a``'s, the token in slot
``a`` loses that expert (ROADMAP Queue C); the port keeps that result.

Under the training step's data parallelism over processes
(``sharding.collective``) a rank holds a contiguous block of the
microbatch's tokens.  The router's ``me``, ``ce`` and z-loss are means
over the microbatch's tokens on every rank (one sum over the group a
layer), and the dispatch groups partition the global token order as the
reference's do, so each rank routes its G / W of them; a group count
that is not a multiple of W after the reference's halving is refused.

Under tensor parallelism (a ``model`` axis over ranks) the experts
split over the line where their count divides it, else each expert's
``expert_mlp`` dim does (:func:`moe_ffn`); the aux terms and the
dispatch tables come from the whole logits on every rank of the line.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..sharding import collective
from ..sharding.logical import maybe_constrain
from .params import ParamSpec

F32 = torch.float32


def moe_specs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    sp = {
        "router": ParamSpec((d, m.n_experts), ("embed_noshard", "experts"),
                            dtype="float32"),
        "we1": ParamSpec((m.n_experts, d, m.d_expert),
                         ("experts", "embed", "expert_mlp")),
        "we3": ParamSpec((m.n_experts, d, m.d_expert),
                         ("experts", "embed", "expert_mlp")),
        "we2": ParamSpec((m.n_experts, m.d_expert, d),
                         ("experts", "expert_mlp", "embed")),
    }
    if m.n_shared_experts:
        f = m.d_expert * m.n_shared_experts
        sp.update({
            "ws1": ParamSpec((d, f), ("embed", "mlp")),
            "ws3": ParamSpec((d, f), ("embed", "mlp")),
            "ws2": ParamSpec((f, d), ("mlp", "embed")),
        })
    return sp


def _scatter_last(slot, vals, n: int, fill):
    """``full((n,), fill).at[slot].set(vals)`` with the reference's
    semantics on the CPU: indices >= n are dropped, and of several
    writes to one index the last (in ``slot``'s order) stays."""
    order = torch.arange(slot.shape[0], device=slot.device)
    inb = slot < n
    last = torch.full((n,), -1, dtype=torch.int64, device=slot.device)
    last.scatter_reduce_(0, slot[inb], order[inb], reduce="amax")
    return torch.where(last >= 0, vals[last.clamp(min=0)],
                       torch.full((), fill, dtype=vals.dtype,
                                  device=vals.device))


def _dispatch_one_group(xf, logits, m: MoEConfig, cap: int, gate=None,
                        experts=None):
    """Route one token group: (T_g, D) -> gathered (E, cap, D) buffers,
    tok_of_slot (E * cap,) int32 (-1 where empty), gate_of_slot f32 and
    the occupied mask.  Under tensor parallelism ``gate`` takes the
    softmax gates (``collective.to_model``: each rank's combine reads
    them through its part of the experts' outputs) and ``experts`` =
    (first, count) keeps those experts' slots: the tables are computed
    whole from the whole logits, alike on every rank of the line."""
    t, d = xf.shape
    gate_vals, expert_idx = torch.topk(logits, m.top_k, dim=-1)  # (T, k)
    gates = torch.softmax(gate_vals, dim=-1)
    if gate is not None:
        gates = gate(gates)
    a = t * m.top_k
    flat_e = expert_idx.reshape(a)
    flat_t = torch.arange(t, dtype=torch.int32,
                          device=xf.device).repeat_interleave(m.top_k)
    flat_g = gates.reshape(a)
    se, order = torch.sort(flat_e, stable=True)
    st_, sg = flat_t[order], flat_g[order]
    seg_start = torch.searchsorted(
        se, torch.arange(m.n_experts, dtype=se.dtype, device=se.device))
    pos = torch.arange(a, device=xf.device) - seg_start[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, a)
    n = m.n_experts * cap + 1
    tok_of_slot = _scatter_last(slot, torch.where(keep, st_, -1), n, -1)[:-1]
    gate_of_slot = _scatter_last(slot, torch.where(keep, sg, 0.0), n,
                                 0.0)[:-1]
    first, count = experts or (0, m.n_experts)
    mine = slice(first * cap, (first + count) * cap)
    tok_of_slot, gate_of_slot = tok_of_slot[mine], gate_of_slot[mine]
    occupied = tok_of_slot >= 0
    xin = torch.where(occupied[:, None], xf[tok_of_slot.clamp(min=0).long()],
                      torch.zeros((), dtype=xf.dtype, device=xf.device))
    return (xin.reshape(count, cap, d), tok_of_slot, gate_of_slot,
            occupied)


def _combine_one_group(eo, tok_of_slot, gate_of_slot, occupied, t: int,
                       d: int):
    contrib = eo.reshape(-1, d).to(F32) * gate_of_slot[:, None]
    idx = torch.where(occupied, tok_of_slot, t).long()
    return torch.zeros(t + 1, d, dtype=F32, device=eo.device).index_add_(
        0, idx, contrib)[:-1]


def _model_splits(p: dict, m: MoEConfig) -> tuple:
    """(experts split, expert_mlp split, shared experts split): which of
    the weights hold the rank's chunk (fewer than the whole extent)
    under an active model line; all False without one."""
    if collective.model_line() is None:
        return False, False, False
    shared = bool(m.n_shared_experts) and \
        p["ws1"].shape[-1] < m.d_expert * m.n_shared_experts
    return (p["we1"].shape[0] < m.n_experts,
            p["we1"].shape[-1] < m.d_expert, shared)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (y, aux) with aux = {load_balance, router_z}.
    Tokens are split into ``cfg.moe_dispatch_groups`` groups (halved
    until they divide B * S) and routed group-locally.

    Under tensor parallelism (an active model line) the weights are the
    rank's chunks, as the guard split them: by ``experts`` (``we*``'s
    leading dim and the router's columns) where the expert count divides
    the line, else by ``expert_mlp`` (``we1`` / ``we3`` by column,
    ``we2`` by row, the router whole); the shared experts by ``mlp``.
    The router's column chunks are gathered into the whole logits
    (``collective.gather_from_model``: its backward keeps the rank's
    slice), from which every rank computes the aux terms and the
    dispatch tables alike, so the aux terms' gradient is counted once;
    the gates pass ``collective.to_model``, since each rank's combine
    reads them through its part of the experts' outputs.  A rank runs
    its experts' slots (experts split) or its slice of every expert
    (expert_mlp split) on the tokens through ``to_model``, and the
    partial sums, the shared experts' with them, leave through one
    ``collective.from_model``."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    e_split, f_split, s_split = _model_splits(p, m)
    routed_part = e_split or f_split
    xe = collective.to_model(xf) if routed_part or s_split else xf
    if e_split:
        logits = collective.gather_from_model(
            xe.to(F32) @ p["router"].to(F32))
    else:
        logits = xf.to(F32) @ p["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)                         # (T, E)

    # ---- aux losses (f32, global) -------------------------------------
    _, expert_idx_all = torch.topk(logits, m.top_k, dim=-1)
    top1 = F.one_hot(expert_idx_all[:, 0], m.n_experts).to(F32)
    dp = collective.active()
    w = 1 if dp is None else dp.size
    e = m.n_experts
    sums = collective.global_sum(torch.cat([
        probs.sum(dim=0), top1.sum(dim=0),
        torch.sum(torch.logsumexp(logits, dim=-1) ** 2)[None]]))
    me, ce, router_z = (sums[:e] / (t * w), sums[e:2 * e] / (t * w),
                        sums[2 * e] / (t * w))
    load_balance = m.n_experts * torch.sum(me * ce)

    # ---- grouped dispatch ---------------------------------------------
    groups = max(1, getattr(cfg, "moe_dispatch_groups", 1) or 1)
    while (t * w) % groups:
        groups //= 2
    if groups % w:
        raise ValueError(f"{groups} MoE dispatch groups (after halving "
                         f"over {t * w} tokens) do not split over {w} "
                         "data-parallel ranks: set moe_dispatch_groups to "
                         "a multiple of the ranks")
    groups //= w
    tg = t // groups
    a_g = tg * m.top_k
    cap = int(max(min(tg, 16), round(a_g / m.n_experts * m.capacity_factor)))
    # the reference's activation constraints (identities in one process)
    dp = ("pod", "data")
    xg = maybe_constrain((xe if routed_part else xf).reshape(groups, tg, d),
                         (dp, None, None))
    lg = maybe_constrain(logits.reshape(groups, tg, m.n_experts),
                         (dp, None, None))
    kw = {}
    if routed_part:
        n_e = p["we1"].shape[0]
        kw = {"gate": collective.to_model,
              "experts": (collective.model_line().index * n_e, n_e)
              if e_split else None}
    routed = [_dispatch_one_group(x_, l_, m, cap, **kw)
              for x_, l_ in zip(xg, lg)]
    xin = maybe_constrain(torch.stack([r[0] for r in routed]),
                          (dp, "model", None, None))      # (G, E, cap, D)
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, p["we1"])) * \
        torch.einsum("gecd,edf->gecf", xin, p["we3"])
    eo = maybe_constrain(torch.einsum("gecf,efd->gecd", h, p["we2"]),
                         (dp, "model", None, None))
    yf = torch.cat([_combine_one_group(e, *r[1:], tg, d)
                    for e, r in zip(eo, routed)])

    if m.n_shared_experts:
        xs = xe if s_split else xf
        hs = F.silu(xs @ p["ws1"]) * (xs @ p["ws3"])
        ys = (hs @ p["ws2"]).to(F32)
        if s_split == routed_part:
            yf = collective.from_model(yf + ys) if s_split else yf + ys
        elif s_split:
            yf = yf + collective.from_model(ys)
        else:
            yf = collective.from_model(yf) + ys
    elif routed_part:
        yf = collective.from_model(yf)

    y = yf.to(x.dtype).reshape(b, s, d)
    return y, {"load_balance": load_balance, "router_z": router_z}


__all__ = ["moe_specs", "moe_ffn"]
