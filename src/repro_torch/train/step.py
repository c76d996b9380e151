"""The training step: loss -> grad -> clip -> (compress) -> optimizer
update.

Port of ``repro/train/step.py`` (``init_state`` ``:21``,
``abstract_state`` ``:31``, ``global_norm`` ``:96``, ``build_train_step``
``:102-185``).  The state is a dict of
``params``, ``opt`` (the optimizer's state, ``train.optim``), ``step``
(an int32 0-d tensor on the parameters' device) and ``rng``: a (2,)
int64 CPU tensor of (seed, counter) from which each step seeds its own
``torch.Generator`` (the int8 compression's uniforms), then advances
the counter, so a restart from a checkpoint replays exactly, as the
reference's split key does.  Microbatch gradients accumulate in f32.

The step updates the state's tensors in place (parameters, moments)
and returns the state: at full width a second copy of either would not
fit beside the first.  ``dp_axes`` (the mesh axes of data parallelism:
each microbatch is constrained to them) and ``grad_shardings`` (a
sharding description per gradient accumulator, ZeRO-1's) are applied
through ``sharding.logical.constrain``, which places nothing in one
process: over a mesh with one card on its data axes they leave every
value as the step without them gives it.  A data axis over several
distinct cards (GSPMD in the reference) is not ported: the step raises
``NotImplementedError`` for it.  ``abstract_state`` (the dry-run's
input) describes the state on the ``meta`` device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig
from ..models import zoo
from ..models.params import ParamSpec, abstract, abstract_params, map_specs
from ..sharding.logical import constrain, guarded_sharding
from .compress import int8_compress_decompress
from .optim import (OPTIMIZERS, Q_BLOCK, lr_schedule, tree_leaves,
                    tree_map)

F32 = torch.float32


def init_state(cfg: ModelConfig, run: RunConfig, params):
    opt_init, _ = OPTIMIZERS[run.optimizer]
    some = tree_leaves(params)[0]
    return {
        "params": params,
        "opt": opt_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=some.device),
        "rng": torch.zeros(2, dtype=torch.int64),   # seed 0, counter 0
    }


def abstract_state(cfg: ModelConfig, run: RunConfig, specs, mesh=None,
                   rules=None):
    """The state as ``meta`` tensors with sharding descriptions — the
    dry-run's input; nothing is allocated.

    Optimizer moments take their parameter's sharding (same shape);
    Adafactor's row / column factors shard by the parameter's remaining
    logical axes; under ZeRO-1 the optimizer state shards over the data
    axis through the embed dimension, while weights stay TP-only."""
    def sds(shape, dtype, axes):
        sh = None if mesh is None else guarded_sharding(tuple(shape), axes,
                                                        rules, mesh)
        return abstract(shape, dtype, sh)

    params = abstract_params(specs, cfg.dtype, mesh, rules)
    if run.zero1 and rules is not None:
        rules = dict(rules)
        if rules.get("embed") is None:
            rules["embed"] = "data"

    if run.optimizer == "adamw":
        def mom(s):
            return sds(s.shape, F32, s.axes)
        opt = {"mu": map_specs(mom, specs), "nu": map_specs(mom, specs),
               "count": sds((), torch.int32, ())}
    elif run.optimizer == "adafactor":
        def fac(s: ParamSpec):
            if len(s.shape) >= 2:
                return {"vr": sds(s.shape[:-1], F32, s.axes[:-1]),
                        "vc": sds(s.shape[:-2] + s.shape[-1:], F32,
                                  s.axes[:-2] + s.axes[-1:])}
            return {"v": sds(s.shape, F32, s.axes)}
        opt = {"v": map_specs(fac, specs), "count": sds((), torch.int32, ())}
    elif run.optimizer == "adamw8bit":
        def q(s: ParamSpec):
            n = int(np.prod(s.shape)) if s.shape else 1
            blocks = -(-n // Q_BLOCK)
            return {"mu_q": sds((blocks, Q_BLOCK), torch.int8, (None, None)),
                    "mu_s": sds((blocks,), F32, (None,)),
                    "nu_q": sds((blocks, Q_BLOCK), torch.int8, (None, None)),
                    "nu_s": sds((blocks,), F32, (None,))}
        opt = {"q": map_specs(q, specs), "count": sds((), torch.int32, ())}
    else:
        raise ValueError(run.optimizer)
    # rng: the port's (seed, counter), int64 (the reference's is a
    # (2,) uint32 key)
    return {"params": params, "opt": opt,
            "step": sds((), torch.int32, ()),
            "rng": sds((2,), torch.int64, (None,))}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(leaf.to(F32) ** 2)
    return torch.sqrt(total)


def step_generator(rng: torch.Tensor, device) -> torch.Generator:
    """The step's generator on ``device``, seeded from (seed, counter)."""
    seed, counter = (int(x) for x in rng)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + counter)
    return gen


def _split(batch: dict, mb: int, i: int, dp_axes=None, mesh=None) -> dict:
    """Microbatch ``i`` of ``mb``: rows i*B/mb .. (i+1)*B/mb - 1; with
    ``dp_axes``, the split constrained to them on its batch axis."""
    out = {}
    for k, x in batch.items():
        y = x.reshape((mb, x.shape[0] // mb) + x.shape[1:])
        if dp_axes:
            y = constrain(y, (None, "batch") + (None,) * (y.dim() - 2),
                          {"batch": tuple(dp_axes)}, mesh)
        out[k] = y[i]
    return out


def _constrain_to(x: torch.Tensor, sharding) -> torch.Tensor:
    """``x`` under a sharding description, through ``constrain`` (the
    spec's entries as their own logical axes)."""
    if sharding is None:
        return x
    spec = sharding.spec
    return constrain(x, spec, {e: e for e in spec if e is not None},
                     sharding.mesh)


def _data_mesh(dp_axes, grad_shardings, mesh):
    """The mesh the data-parallel constraints name (``mesh``, else the
    gradient shardings'), checked to hold one card on each data axis."""
    if mesh is None and grad_shardings is not None:
        mesh = next((s.mesh for s in tree_leaves(grad_shardings)
                     if s is not None), None)
    if dp_axes and mesh is None:
        raise ValueError("dp_axes name mesh axes: pass the mesh")
    if mesh is not None and getattr(mesh, "devices", None) is not None:
        for ax in set(dp_axes or ()) | {"pod", "data"}:
            if ax in mesh.axis_names and mesh.distinct_devices(ax) > 1:
                raise NotImplementedError(
                    f"training over a data axis {ax!r} of several distinct "
                    "devices in one process (GSPMD in the reference) is not "
                    "ported")
    return mesh


def build_train_step(cfg: ModelConfig, run: RunConfig,
                     total_steps: int = 10_000,
                     dp_axes: tuple | None = None,
                     grad_shardings=None, mesh=None) -> Callable:
    """``(state, batch) -> (state, metrics)``; ``metrics`` holds the
    0-d tensors ``loss``, ``grad_norm``, ``lr`` and the loss's own
    (``nll``, and ``load_balance`` / ``router_z`` for the LM families).

    ``dp_axes``: mesh axis names carrying data parallelism, each
    microbatch constrained to them (the reference's re-constraint at
    the microbatch reshape).  ``grad_shardings``: a tree of sharding
    descriptions for the f32 gradient accumulators (ZeRO-1).  ``mesh``
    (a ``sharding.logical.LogicalMesh``) is the mesh ``dp_axes`` name,
    the reference's ambient ``with mesh:``; without it, the gradient
    shardings' mesh."""
    mesh = _data_mesh(dp_axes, grad_shardings, mesh)
    loss_fn = zoo.loss_fn(cfg)
    _, opt_update = OPTIMIZERS[run.optimizer]
    sched = lr_schedule(run.learning_rate, total=total_steps)

    def grads_of(params, batch):
        """(loss, metrics, grads in the leaves' sorted-key order)."""
        leaves = tree_leaves(params)
        shards = [None] * len(leaves) if grad_shardings is None \
            else tree_leaves(grad_shardings)
        for p in leaves:
            p.requires_grad_(True)
        if run.microbatches <= 1:
            loss, metrics = loss_fn(params, batch)
            return (loss.detach(), {k: v.detach() for k, v in
                                    metrics.items()},
                    torch.autograd.grad(loss, leaves))
        # gradient accumulation: activation memory / microbatches; the
        # f32 accumulator is params-shaped
        mb = run.microbatches
        g_acc = [_constrain_to(torch.zeros(p.shape, dtype=F32,
                                           device=p.device), s)
                 for p, s in zip(leaves, shards)]
        l_acc, m_acc = torch.zeros((), dtype=F32, device=leaves[0].device), {}
        for i in range(mb):
            loss, metrics = loss_fn(params, _split(batch, mb, i, dp_axes,
                                                   mesh))
            for a, g, s in zip(g_acc, torch.autograd.grad(loss, leaves),
                               shards):
                _constrain_to(a.add_(g.to(F32)), s)
            l_acc = l_acc + loss.detach()
            for k, v in metrics.items():
                m_acc[k] = m_acc.get(k, 0.0) + v.detach()
        inv = 1.0 / mb
        for a in g_acc:
            a.mul_(inv)
        return l_acc * inv, {k: v * inv for k, v in m_acc.items()}, g_acc

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = grads_of(params, batch)
        with torch.no_grad():
            gnorm = global_norm(grads)
            scale = torch.clamp(run.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = [g.mul_(scale) if g.dtype == F32 else g.to(F32) * scale
                     for g in grads]
            it = iter(grads)
            grads = tree_map(lambda _: next(it), _sorted(params))
            if run.grad_compression == "int8":
                int8_compress_decompress(
                    grads, step_generator(state["rng"], gnorm.device))
            lr = sched(state["step"])
            kw = {}
            if run.optimizer in ("adamw", "adamw8bit"):
                kw["weight_decay"] = run.weight_decay
            _, opt = opt_update(grads, state["opt"], params, lr, apply=True,
                                **kw)
        rng = state["rng"].clone()
        rng[1] += 1
        new_state = {"params": params, "opt": opt,
                     "step": state["step"] + 1, "rng": rng}
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr, **metrics}
        return new_state, out

    return train_step


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order (the order of
    ``tree_leaves``)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree
