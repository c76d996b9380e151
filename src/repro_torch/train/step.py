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
fit beside the first.  ``abstract_state`` (the dry-run's input)
describes the state on the ``meta`` device.

Data parallelism.  Over a mesh of one process, ``dp_axes`` and
``grad_shardings`` are descriptions that place nothing: they leave
every value as the step without them gives it, and a data (or model)
axis over several distinct cards in one process is refused.  Over a
mesh whose positions are the processes of a ``torch.distributed``
group (``LogicalMesh(group=...)``, one card a rank; ``launch.ranks``)
the step is the reference's GSPMD step on the global batch:

* each rank passes its ``DataShard`` block of the global batch (B / W
  rows; ``data.pipeline.shard_rows``); microbatch i is global rows
  i*B/mb .. (i+1)*B/mb - 1 split over the ranks in order, so with
  several microbatches the ranks all-gather the batch's inputs and each
  takes its rows (``data.pipeline.microbatch_rows``);
* the loss's global terms (the NLL's count, the MoE router's means)
  are summed over the ranks inside the loss
  (``sharding.collective.data_parallel``);
* plain DP: each rank accumulates its rows' gradients in f32 and the
  accumulators are summed by one f32 all-reduce a step (a flat buffer
  they are views of); then the norm, clip, int8, schedule and update
  run replicated on equal gradients and equal uniforms;
* ZeRO-1 (``grad_shardings`` naming a data axis on a leaf's dim, or
  ``run.zero1`` with no ``grad_shardings``: the dry-run's
  ``embed -> data``): that leaf's f32 accumulator is the rank's chunk
  of the dim, each microbatch's gradient reduce-scattered into it;
  leaves the divisibility guard leaves whole are accumulated whole and
  all-reduced once.  AdamW's moments and Adafactor's factors are held
  per chunk (a factor whose mean ran over the sharded dim is whole,
  ``optim.adafactor_update``), the update runs on the chunk and the
  parameter is all-gathered (bf16 bits equal to a replicated
  update's); 8-bit Adam's state is whole (its blocks are replicated in
  ``abstract_state``), so its update runs on the all-gathered
  gradient;
* FSDP (``run.fsdp``: ``default_rules(fsdp=True)`` maps ``embed`` to
  ``data``): the layout is ZeRO-1's, and the parameters are held as
  the same chunks too (``init_state`` / :func:`shard_params`, tagged
  with their ``Shard``).  The model gathers each layer's chunks where
  the layer runs (``collective.gathered``, inside the remat'd layer
  function) and the leaves outside the stacks once a microbatch; each
  gather's backward pass reduce-scatters the weight's gradient in f32
  straight into the rank's accumulator chunk.  An FSDP leaf updates
  its chunk in place and is not gathered afterwards (8-bit Adam
  gathers the parameter and the gradient, updates the whole leaf as
  every rank does alike, and keeps its chunk).

Tensor parallelism (a ``model`` axis of several ranks; every family):
the ranks of a model line take the same rows, and each holds its chunk
of every parameter whose ``default_rules`` axis (heads, kv heads, mlp,
vocab, experts or, where the expert count does not divide the line,
expert_mlp, and ssm_inner) the divisibility guard leaves on ``model``
(``init_state`` / :func:`shard_params` cut them from the whole tree,
tagged with their model ``Shard``).  The model runs on the chunks,
joined by ``collective.to_model`` / ``from_model`` (Megatron's column
and row splits, the vocabulary-split embedding, head and NLL, the MoE
router's logits gathered whole: ``models.moe.moe_ffn``; the mamba
mixer's joined ``in_proj`` output and conv, its heads and its gated
norm summed over the line: ``models.mamba2.mamba_forward``); a kv
head replicated by the guard carries its gradient summed over the line
out of the model, so every gradient leaves the loss whole for its
chunk.  Plain DP, ZeRO-1 and FSDP then run as above on the model
chunks, over the data line: a data split is a split of the model chunk.
The grad norm counts each model chunk once and each replicated leaf
once; the int8 uniforms are drawn whole and cut, and the scale's max
runs over both lines; Adafactor's means and RMS over a model-split dim
are the line's; 8-bit Adam updates the whole leaf, gathered over both
lines, and keeps its chunk.

The bytes a rank holds (parameters, optimizer state, accumulators) are
the shard bytes ``abstract_state`` and the gradient shardings describe.
An SSM head count that does not divide the model axis (ROADMAP Queue A
item 11), and a data or model axis over several distinct cards in one
process, raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, RunConfig
from ..models import zoo
from ..models.mamba2 import model_heads
from ..models.params import ParamSpec, abstract, abstract_params, map_specs
from ..data.pipeline import DataShard, microbatch_rows
from ..sharding import collective
from ..sharding.collective import DP_AXES, MODEL_AXIS
from ..sharding.logical import default_rules, guarded_sharding
from .compress import compress_leaf
from .optim import OPTIMIZERS, Q_BLOCK, lr_schedule, tree_leaves, tree_map

F32 = torch.float32


def init_state(cfg: ModelConfig, run: RunConfig, params, mesh=None,
               grad_shardings=None, dp_axes=None):
    """The step's state.  Over a mesh of processes under ZeRO-1 or FSDP
    (the layout ``build_train_step`` reads from the same arguments)
    AdamW's moments and Adafactor's factors are the rank's chunks, each
    marked with its ``Shard``; under FSDP the parameters are too, and
    under tensor parallelism the parameters and the state are the
    rank's model chunks (:func:`shard_params` of ``params``, the whole
    tree or its chunks)."""
    opt_init, _ = OPTIMIZERS[run.optimizer]
    layout = _layout(cfg, run, mesh, dp_axes, grad_shardings)
    mlay = _model_layout(cfg, run, mesh, dp_axes)
    if mlay is not None or (layout is not None and run.fsdp):
        params = shard_params(cfg, run, params, mesh, dp_axes)
    some = tree_leaves(params)[0]
    opt = opt_init(params) if layout is None and mlay is None else \
        _sharded_opt_init(run, params, layout, mlay)
    return {
        "params": params,
        "opt": opt,
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


def zero1_grad_shardings(cfg: ModelConfig, run: RunConfig, mesh,
                         rules=None):
    """The f32 accumulators' shardings under ZeRO-1 as the reference's
    dry-run builds them (``dryrun.py:107-116``): each parameter's
    logical axes under ``rules`` (default the run's) with ``embed`` on
    ``data``, guarded for divisibility."""
    rules = dict(rules if rules is not None else
                 default_rules(fsdp=run.fsdp,
                               seq_shard=run.seq_shard_activations))
    if rules.get("embed") is None:
        rules["embed"] = "data"
    return map_specs(lambda s: guarded_sharding(s.shape, s.axes, rules,
                                                mesh), zoo.model_specs(cfg))


def _model_layout(cfg, run, mesh, dp_axes=None):
    """Per parameter leaf (sorted-key order) its model ``Shard`` under
    tensor parallelism over a mesh of processes (the ``model`` entry of
    its guarded sharding under ``default_rules(fsdp=run.fsdp)``), or
    None where the guard leaves it whole on the line; None for the whole
    tree with no model axis of several ranks, or none split.  Every
    family runs there; an ssm or hybrid config whose SSM head count does
    not divide the line raises ``NotImplementedError``
    (``mamba2.model_heads``: ROADMAP Queue A item 11)."""
    if mesh is None or getattr(mesh, "group", None) is None \
            or mesh.shape.get(MODEL_AXIS, 1) == 1:
        return None
    if cfg.ssm is not None:
        model_heads(cfg, mesh.shape[MODEL_AXIS])
    rules = default_rules(fsdp=run.fsdp, seq_shard=run.seq_shard_activations)
    dp = tuple(a for a in (dp_axes or DP_AXES) if a in mesh.axis_names)
    mlay = [collective.model_split(
        guarded_sharding(s.shape, s.axes, rules, mesh).spec, s.shape, mesh,
        dp) for s in tree_leaves(zoo.model_specs(cfg))]
    return mlay if any(mlay) else None


def _local_shape(shape: tuple, split) -> tuple:
    """A leaf's shape as the rank holds it before any data split: its
    model chunk's, or the whole shape."""
    return tuple(shape) if split is None else split.shape(shape)


def _layout(cfg, run, mesh, dp_axes, grad_shardings):
    """Per parameter leaf (sorted-key order) its ``Shard`` under ZeRO-1
    or FSDP over a mesh of processes, or None where it stays whole; None
    for the whole tree where no leaf is sharded (plain DP, or one
    process).  FSDP's is each parameter's guarded sharding under
    ``default_rules(fsdp=True)``, which is ZeRO-1's
    (:func:`zero1_grad_shardings`); its accumulators shard as its
    parameters, so it takes no gradient shardings.  Under tensor
    parallelism a data split is one of the rank's model chunk, and the
    gradient shardings' model entries must be the model layout's."""
    if mesh is None or mesh.group is None:
        return None
    if run.fsdp:
        if grad_shardings is not None:
            raise ValueError("FSDP's accumulators shard as its parameters "
                             "(embed -> data): pass no grad_shardings")
        return _layout(cfg, dataclasses.replace(run, fsdp=False, zero1=True),
                       mesh, dp_axes, None)
    if grad_shardings is None:
        if not run.zero1:
            return None
        grad_shardings = zero1_grad_shardings(cfg, run, mesh)
    dp = tuple(a for a in (dp_axes or DP_AXES) if a in mesh.axis_names)
    shapes = [s.shape for s in tree_leaves(zoo.model_specs(cfg))]
    shardings = tree_leaves(grad_shardings)
    if len(shardings) != len(shapes):
        raise ValueError(f"{len(shardings)} gradient shardings for "
                         f"{len(shapes)} parameters")
    mlay = _model_layout(cfg, run, mesh, dp_axes) or [None] * len(shapes)
    layout = []
    for shape, sh, m in zip(shapes, shardings, mlay):
        if sh is None:
            layout.append(None)
            continue
        mine = collective.model_split(sh.spec, shape, mesh, dp)
        if getattr(mine, "dim", None) != getattr(m, "dim", None):
            raise ValueError(f"the gradient sharding {sh.spec} of {shape} "
                             "splits the model axis unlike the parameter")
        layout.append(collective.shard_for(sh.spec, _local_shape(shape, m),
                                           mesh, dp))
    if not any(layout):
        return None
    return layout


def shard_params(cfg: ModelConfig, run: RunConfig, params, mesh,
                 dp_axes=None):
    """``params`` as this rank holds them: under tensor parallelism
    every leaf the model layout splits cut to the rank's model chunk,
    then under FSDP every leaf that the layout shards over the data axes
    cut to its data chunk of that (each a copy, tagged with its
    ``Shard``s), the others as they are.  ``params`` is the whole tree
    (``init_params``, ``convert.params_from_reference``); a leaf may
    also be a zero-argument callable that returns the whole leaf: the
    callables are called in the tree's order and each whole leaf is
    dropped once cut, so a full-width draw holds one whole leaf beside
    the chunks.  A leaf that is already a tagged chunk stays.  Without
    FSDP or tensor parallelism over ranks nothing is cut."""
    paths = _paths(zoo.model_specs(cfg))
    layout = _layout(cfg, run, mesh, dp_axes, None) if run.fsdp else None
    mlay = _model_layout(cfg, run, mesh, dp_axes)
    by_path = dict(zip(paths, zip(mlay or [None] * len(paths),
                                  layout or [None] * len(paths))))

    def chunk(x, split, tag):
        return tag(split.of(x.detach()).clone(
            memory_format=torch.contiguous_format), split)

    def cut(tree, path):
        if isinstance(tree, dict):
            return {k: cut(v, path + (k,)) for k, v in tree.items()}
        leaf = tree() if callable(tree) else tree
        m, sh = by_path.get(path, (None, None))
        if m is not None and collective.model_of(leaf) is None:
            leaf = chunk(leaf, m, collective.tag_model)
        if sh is not None and collective.shard_of(leaf) is None:
            leaf = collective.tag_model(chunk(leaf, sh, collective.tag), m)
        return leaf
    return cut(params, ())


def _over_layout(fn, params, layout):
    """``fn(leaf, its Shard or None)`` over the leaves in sorted-key
    order (the layout's)."""
    it = iter(layout)
    return tree_map(lambda p: fn(p, next(it)), _sorted(params))


def _factor_splits(split, n: int) -> tuple:
    """A leaf of ``n`` dims split by ``split`` (or None): the splits of
    Adafactor's (vr, vc).  vr averages dim n-1 away, vc dim n-2; past
    the split dim a factor's dims shift down by one."""
    k = None if split is None else split.dim
    vr = None if k is None or k == n - 1 else split
    vc = None if k is None or k == n - 2 else \
        (split if k < n - 2 else dataclasses.replace(split, dim=n - 2))
    return vr, vc


def _sharded_opt_init(run: RunConfig, params, layout, mlay=None):
    """The optimizer's initial state under ZeRO-1, FSDP or tensor
    parallelism (``params`` whole or the rank's chunks): AdamW's moments
    and Adafactor's factors as ``abstract_state`` shards them (each
    chunk marked with its data and model splits), 8-bit Adam's blocks of
    the whole leaf."""
    dev = tree_leaves(params)[0].device
    n_leaves = len(tree_leaves(params))
    splits = list(zip(layout or [None] * n_leaves, mlay or [None] * n_leaves))

    def zeros(shape, sh=None, m=None, dtype=F32):
        return collective.tag_model(collective.tag(
            torch.zeros(shape, dtype=dtype, device=dev), sh), m)

    def chunk(p, sh):
        return tuple(p.shape) if sh is None else sh.shape(p.shape)

    def moment(p, sm):
        return zeros(chunk(p, sm[0]), *sm)

    def factors(p, sm):
        cs = chunk(p, sm[0])
        n = len(cs)
        if n < 2:
            return {"v": zeros(cs, *sm)}
        (dr, dc), (mr, mc) = (_factor_splits(x, n) for x in sm)
        return {"vr": zeros(cs[:-1], dr, mr),
                "vc": zeros(cs[:-2] + cs[-1:], dc, mc)}

    def blocks(p, sm):
        whole = list(p.shape)
        for x in sm:
            if x is not None:
                whole[x.dim] = x.full
        nb = -(-int(np.prod(whole)) // Q_BLOCK)
        return {"mu_q": zeros((nb, Q_BLOCK), dtype=torch.int8),
                "mu_s": zeros((nb,)),
                "nu_q": zeros((nb, Q_BLOCK), dtype=torch.int8),
                "nu_s": zeros((nb,))}

    count = torch.zeros((), dtype=torch.int32, device=dev)
    if run.optimizer == "adamw":
        return {"mu": _over_layout(moment, params, splits),
                "nu": _over_layout(moment, params, splits), "count": count}
    if run.optimizer == "adafactor":
        return {"v": _over_layout(factors, params, splits), "count": count}
    if run.optimizer == "adamw8bit":
        return {"q": _over_layout(blocks, params, splits), "count": count}
    raise ValueError(run.optimizer)


def global_norm(tree, layout=None, ranks=None, mlay=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32.  Under ZeRO-1
    or FSDP (``layout``: each leaf's ``Shard`` or None, over the step's
    ``ranks``) or tensor parallelism (``mlay``: each leaf's model split
    or None) the leaves are this rank's: a chunk's squares count on one
    rank of its replicas, a whole leaf's on the data line's first rank
    (and a leaf whole on the model line on its first rank), and the sum
    is all-reduced over the data line (and the model line)."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=F32, device=leaves[0].device)
    spread = layout is not None or mlay is not None
    for i, leaf in enumerate(leaves):
        if spread and not _owns(None if layout is None else layout[i],
                                None if mlay is None else mlay[i], ranks):
            continue
        total = total + torch.sum(leaf.to(F32) ** 2)
    if spread:
        mp = ranks[0].model
        dist.all_reduce(total, group=ranks[0].group if mp is None
                        else mp.span)
    return torch.sqrt(total)


def _owns(sh, m, ranks) -> bool:
    """Whether this rank counts a leaf (its data ``Shard``, or None for a
    whole one; its model split, or None for one whole on the model line)
    in a sum over the data and model lines."""
    mp = ranks[0].model
    if m is None and mp is not None and mp.index != 0:
        return False
    if sh is None:
        return ranks[1] == 0
    return sh.rest is None or dist.get_rank(sh.rest) == 0


def step_generator(rng: torch.Tensor, device) -> torch.Generator:
    """The step's generator on ``device``, seeded from (seed, counter)."""
    seed, counter = (int(x) for x in rng)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + counter)
    return gen


def _data_mesh(dp_axes, grad_shardings, mesh, run: RunConfig):
    """The mesh the data-parallel constraints name (``mesh``, else the
    gradient shardings'), checked for what is ported: over processes,
    data parallelism on the pod / data axes (plain, ZeRO-1, FSDP) and
    tensor parallelism on the model axis (the families,
    :func:`_model_layout`); in one process, one card on each axis."""
    if mesh is None and grad_shardings is not None:
        mesh = next((s.mesh for s in tree_leaves(grad_shardings)
                     if s is not None), None)
    if dp_axes and mesh is None:
        raise ValueError("dp_axes name mesh axes: pass the mesh")
    if mesh is None:
        return mesh
    dp = set(dp_axes or ()) | set(DP_AXES)
    model = [a for a in mesh.axis_names if a not in dp]
    if getattr(mesh, "group", None) is not None:
        for ax in model:
            if ax != MODEL_AXIS and mesh.shape[ax] > 1:
                raise NotImplementedError(
                    f"training over an axis {ax!r} of several ranks is not "
                    "ported: the data axes and the model axis span ranks")
        ranked = {a for a in DP_AXES
                  if a in mesh.axis_names and mesh.shape[a] > 1}
        if dp_axes is not None and not ranked <= set(dp_axes):
            raise ValueError(f"dp_axes {dp_axes} leave out the mesh's "
                             f"ranked axes {sorted(ranked)}")
    elif getattr(mesh, "devices", None) is not None:
        what = "FSDP" if run.fsdp else "training"
        for ax in dp:
            if ax in mesh.axis_names and mesh.distinct_devices(ax) > 1:
                raise NotImplementedError(
                    f"{what} over a data axis {ax!r} of several distinct "
                    "devices in one process (GSPMD in the reference) is not "
                    "ported: run one process a card (launch.ranks)")
        for ax in model:
            if mesh.distinct_devices(ax) > 1:
                raise NotImplementedError(
                    f"training over a model axis {ax!r} of several distinct "
                    "devices (tensor parallelism) is not ported (ROADMAP "
                    "Queue A item 8)")
    return mesh


class _GradAcc:
    """The step's f32 gradient accumulators: whole leaves as views of one
    flat buffer (over ranks all-reduced once a step), ZeRO-1's and
    FSDP's chunks as tensors of their own (reduce-scattered into each
    microbatch: ZeRO-1's by :meth:`add`, FSDP's by the gathers' backward
    pass, which finds them through :meth:`chunk_for`).  With no
    ``group`` (one process) no collective runs."""

    def __init__(self, leaves, layout, group, fsdp: bool = False):
        layout = layout or [None] * len(leaves)
        self.layout, self.group, self.leaves = layout, group, leaves
        whole = [p for p, sh in zip(leaves, layout) if sh is None]
        self.flat = torch.zeros(sum(p.numel() for p in whole), dtype=F32,
                                device=leaves[0].device)
        self.acc, o = [], 0
        for p, sh in zip(leaves, layout):
            if sh is None:
                self.acc.append(self.flat[o:o + p.numel()].view(p.shape))
                o += p.numel()
            else:
                self.acc.append(collective.tag(torch.zeros(
                    sh.shape(p.shape), dtype=F32, device=p.device), sh))
        self.fsdp = {id(p): a for p, a, sh in zip(leaves, self.acc, layout)
                     if fsdp and sh is not None}

    def chunk_for(self, x):
        """The accumulator chunk of the FSDP chunk ``x`` (a parameter, or
        layer i of one: ``collective.layer``), or None."""
        base, i = getattr(x, "_stack", (x, None))
        a = self.fsdp.get(id(base))
        return a if a is None or i is None else a[i]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.acc)

    def add(self, grads) -> None:
        for p, a, g, sh in zip(self.leaves, self.acc, grads, self.layout):
            if id(p) in self.fsdp:
                if g is not None:
                    raise RuntimeError(
                        f"an FSDP chunk of shape {tuple(p.shape)} was used "
                        "without its gather (collective.gathered)")
                continue              # its gathers' backward added it
            if sh is None:
                a.add_(g.to(F32))
                continue
            part = collective.reduce_scatter(g, sh)
            if sh.rest is not None:
                dist.all_reduce(part, group=sh.rest)
            a.add_(part)

    def finish(self, mb: int) -> list:
        """The summed gradients: the whole leaves all-reduced over the
        group, the sums over ``mb`` microbatches averaged, or with one
        microbatch rounded to each parameter's dtype as the one-device
        step's gradient is."""
        if self.group is not None and self.flat.numel():
            dist.all_reduce(self.flat, group=self.group)
        for a, p in zip(self.acc, self.leaves):
            if mb > 1:
                a.mul_(1.0 / mb)
            elif p.dtype != F32:
                a.copy_(a.to(p.dtype))
        return self.acc


def build_train_step(cfg: ModelConfig, run: RunConfig,
                     total_steps: int = 10_000,
                     dp_axes: tuple | None = None,
                     grad_shardings=None, mesh=None) -> Callable:
    """``(state, batch) -> (state, metrics)``; ``metrics`` holds the
    0-d tensors ``loss``, ``grad_norm``, ``lr`` and the loss's own
    (``nll``, and ``load_balance`` / ``router_z`` for the LM families).

    ``dp_axes``: mesh axis names carrying data parallelism (the
    microbatch's rows split over them).  ``grad_shardings``: a tree of
    sharding descriptions for the f32 gradient accumulators (ZeRO-1).
    ``mesh`` (a ``sharding.logical.LogicalMesh``) is the mesh
    ``dp_axes`` name, the reference's ambient ``with mesh:``; without
    it, the gradient shardings' mesh.  Over a mesh of processes the
    step is data-parallel (the module docstring).  The returned
    function's ``held`` dict records ``grad_acc_bytes`` and
    ``param_bytes``, the f32 accumulators' and the parameters' bytes on
    this rank, once a step has made them.  Under FSDP or tensor
    parallelism the state's parameters must be the rank's chunks
    (``init_state``), else the step raises: no rank keeps whole weights
    where they were asked to be split."""
    mesh = _data_mesh(dp_axes, grad_shardings, mesh, run)
    loss_fn = zoo.loss_fn(cfg)
    _, opt_update = OPTIMIZERS[run.optimizer]
    sched = lr_schedule(run.learning_rate, total=total_steps)
    ranks = None
    mlay = _model_layout(cfg, run, mesh, dp_axes)
    if mesh is not None and mesh.group is not None:
        dp = tuple(a for a in mesh.axis_names if a in (dp_axes or DP_AXES))
        group, size, index = mesh.line(dp)
        model = None
        if mlay is not None:
            model = collective.ModelLine(*mesh.line((MODEL_AXIS,)),
                                         span=mesh.line(dp + (MODEL_AXIS,))[0])
        ranks = (collective.DataParallel(group, size, model=model), index)
    layout = _layout(cfg, run, mesh, dp_axes, grad_shardings)
    fsdp = layout is not None and run.fsdp
    specs = tree_leaves(zoo.model_specs(cfg))
    shapes = [_local_shape(s.shape, m)
              for s, m in zip(specs, mlay or [None] * len(specs))]
    held: dict = {}

    def grads_of(params, batch):
        """(loss, metrics, gradients in the leaves' sorted-key order) of
        the batch, or over ranks of the global batch whose ``DataShard``
        block ``batch`` is: f32 sums over the microbatches, except that
        one microbatch in one process returns the loss's own gradients
        (no accumulator: the one-process step's memory)."""
        leaves = tree_leaves(params)
        if fsdp or mlay is not None:
            _check_chunks(leaves, layout if fsdp else None, shapes, mlay)
        held["param_bytes"] = sum(p.numel() * p.element_size()
                                  for p in leaves)
        for p in leaves:
            p.requires_grad_(True)
        mb = max(1, run.microbatches)
        if ranks is None and mb == 1:
            loss, metrics = loss_fn(params, batch)
            return (loss.detach(), {k: v.detach() for k, v in
                                    metrics.items()},
                    torch.autograd.grad(loss, leaves))
        dp, index = ranks or (None, 0)
        rows = next(iter(batch.values())).shape[0]
        if mb == 1:
            whole, spans = batch, [(0, rows)]
        else:
            w = 1 if dp is None else dp.size
            spans = microbatch_rows(rows * w, mb, DataShard(index, w))
            whole = batch if dp is None else {
                k: collective.gather_rows(v, dp.group, dp.size)
                for k, v in batch.items()}
        acc = _GradAcc(leaves, layout, None if dp is None else dp.group,
                       fsdp)
        held["grad_acc_bytes"] = acc.nbytes
        l_acc = torch.zeros((), dtype=F32, device=leaves[0].device)
        m_acc = {}
        if fsdp:
            dp = dataclasses.replace(dp, grads=acc.chunk_for)
        with collective.data_parallel(dp):
            for lo, hi in spans:
                loss, metrics = loss_fn(params, {k: v[lo:hi] for k, v in
                                                 whole.items()})
                acc.add(torch.autograd.grad(loss, leaves,
                                            allow_unused=fsdp))
                l_acc = l_acc + loss.detach()
                for k, v in metrics.items():
                    m_acc[k] = m_acc.get(k, 0.0) + v.detach()
        inv = 1.0 / mb
        return l_acc * inv, {k: v * inv for k, v in m_acc.items()}, \
            acc.finish(mb)

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = grads_of(params, batch)
        with torch.no_grad():
            gnorm = global_norm(grads, layout, ranks, mlay)
            scale = torch.clamp(run.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = [g.mul_(scale) if g.dtype == F32 else g.to(F32) * scale
                     for g in grads]
            lay = layout or [None] * len(grads)
            mls = mlay or [None] * len(grads)
            if run.grad_compression == "int8":
                _int8(grads, lay, mls, step_generator(state["rng"],
                                                      gnorm.device))
            lr = sched(state["step"])
            kw = {}
            if run.optimizer in ("adamw", "adamw8bit"):
                kw["weight_decay"] = run.weight_decay
            # leaf by leaf: a ZeRO-1 chunk updates its slice of the
            # parameter, which is then all-gathered; an FSDP chunk is
            # the parameter; 8-bit Adam's whole state updates the
            # gathered leaf from the gathered gradient
            opt = state["opt"]
            parts = [k for k in opt if k != "count"]
            count = opt["count"]
            for path, g, sh, m in zip(_paths(params), grads, lay, mls):
                p = _at(params, path)
                one = {k: {"x": _at(opt[k], path)} for k in parts}
                one["count"] = opt["count"]
                if run.optimizer == "adafactor":
                    kw["shards"] = {"x": (sh, m)}
                eight = run.optimizer == "adamw8bit" and (
                    sh is not None or m is not None)
                if eight:
                    # the whole leaf: the gradient gathered over the data
                    # line, then the model line (as collective.whole)
                    if sh is not None:
                        g = collective.all_gather(g, sh)
                    if m is not None:
                        g = collective.all_gather(g, m)
                    target = collective.whole(p) if fsdp or m else p
                else:
                    target = p if sh is None or fsdp else sh.of(p)
                _, new = opt_update({"x": g}, one, {"x": target}, lr,
                                    apply=True, **kw)
                count = new["count"]
                if target is p:
                    continue                    # updated in place
                # ZeRO-1's chunk gathered into the parameter, or 8-bit
                # Adam's whole leaf cut to the rank's chunk
                p.copy_(collective.cut(target, m, sh if fsdp else None)
                        if eight else collective.all_gather(target, sh))
            opt = dict(opt, count=count)
        rng = state["rng"].clone()
        rng[1] += 1
        new_state = {"params": params, "opt": opt,
                     "step": state["step"] + 1, "rng": rng}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                           **metrics}

    train_step.held = held
    return train_step


def _check_chunks(leaves, layout, shapes, mlay=None) -> None:
    """Under FSDP (``layout``) or tensor parallelism (``mlay``) every
    split parameter must be this rank's tagged chunk (``shapes``: each
    leaf's model chunk's shape): a whole leaf would run (and be
    updated) unsplit."""
    n = len(leaves)
    for i, (p, sh, m, shape) in enumerate(zip(
            leaves, layout or [None] * n, mlay or [None] * n, shapes)):
        if sh is None and m is None:
            continue
        want = tuple(shape) if sh is None else sh.shape(shape)
        marked = (sh is None or collective.shard_of(p) is not None) and \
            (m is None or collective.model_of(p) is not None)
        if tuple(p.shape) != want or not marked:
            what = "FSDP" if sh is not None else "tensor parallelism"
            raise ValueError(
                f"{what}: parameter {i} is {tuple(p.shape)}"
                f"{'' if marked else ' untagged'}, not this rank's chunk "
                f"{want}: pass init_state's (or shard_params') chunks")


def _int8(grads, layout, mlay, generator) -> None:
    """int8 compression of the gradients in place: each leaf's uniforms
    drawn whole in sorted-key order (as ``int8_compress_decompress``
    draws them; a ZeRO-1 chunk, or a model chunk, keeps its slice of
    them and takes its scale from the whole leaf's max |g|)."""
    for g, sh, m in zip(grads, layout, mlay):
        shape = list(g.shape)
        for x in (sh, m):
            if x is not None:
                shape[x.dim] = x.full
        u = torch.rand(shape, generator=generator, dtype=F32,
                       device=g.device)
        if sh is None and m is None:
            g.copy_(compress_leaf(g, u))
            continue
        amax = torch.amax(torch.abs(g))
        for x in (sh, m):
            if x is not None:
                dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=x.group)
        g.copy_(compress_leaf(g, collective.cut(u, m, sh), amax))


def _paths(tree, prefix=()) -> list:
    """The key paths of ``tree``'s leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                        prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order (the order of
    ``tree_leaves``)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree
