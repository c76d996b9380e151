"""The training step: loss -> grad -> clip -> (compress) -> optimizer
update.

Port of ``repro/train/step.py`` (``init_state`` ``:21``, ``global_norm``
``:96``, ``build_train_step`` ``:102-185``).  The state is a dict of
``params``, ``opt`` (the optimizer's state, ``train.optim``), ``step``
(an int32 0-d tensor on the parameters' device) and ``rng``: a (2,)
int64 CPU tensor of (seed, counter) from which each step seeds its own
``torch.Generator`` (the int8 compression's uniforms), then advances
the counter, so a restart from a checkpoint replays exactly, as the
reference's split key does.  Microbatch gradients accumulate in f32.

The step updates the state's tensors in place (parameters, moments)
and returns the state: at full width a second copy of either would not
fit beside the first.  ``dp_axes`` and ``grad_shardings`` (the
reference's data-parallel constraints) are accepted only as None: the
LM-side sharding is not ported, and the step runs on one device.
``abstract_state`` (the dry-run's input) is not ported either.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ModelConfig, RunConfig
from ..models import zoo
from .compress import int8_compress_decompress
from .optim import OPTIMIZERS, lr_schedule, tree_leaves, tree_map

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


def _split(batch: dict, mb: int, i: int) -> dict:
    """Microbatch ``i`` of ``mb``: rows i*B/mb .. (i+1)*B/mb - 1."""
    return {k: x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
            for k, x in batch.items()}


def build_train_step(cfg: ModelConfig, run: RunConfig,
                     total_steps: int = 10_000,
                     dp_axes: tuple | None = None,
                     grad_shardings=None) -> Callable:
    """``(state, batch) -> (state, metrics)``; ``metrics`` holds the
    0-d tensors ``loss``, ``grad_norm``, ``lr`` and the loss's own
    (``nll``, and ``load_balance`` / ``router_z`` for the LM families)."""
    if dp_axes is not None or grad_shardings is not None:
        raise NotImplementedError(
            "dp_axes / grad_shardings: the LM-side sharding is not ported; "
            "the step runs on one device")
    loss_fn = zoo.loss_fn(cfg)
    _, opt_update = OPTIMIZERS[run.optimizer]
    sched = lr_schedule(run.learning_rate, total=total_steps)

    def grads_of(params, batch):
        """(loss, metrics, grads in the leaves' sorted-key order)."""
        leaves = tree_leaves(params)
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
        g_acc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                 for p in leaves]
        l_acc, m_acc = torch.zeros((), dtype=F32, device=leaves[0].device), {}
        for i in range(mb):
            loss, metrics = loss_fn(params, _split(batch, mb, i))
            for a, g in zip(g_acc, torch.autograd.grad(loss, leaves)):
                a.add_(g.to(F32))
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
