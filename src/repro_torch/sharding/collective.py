"""Data parallelism over processes: the reductions the training step and
the loss make across ranks, and the shard of a tensor a rank holds.

The reference's GSPMD step computes its loss over the whole microbatch
while each device holds a slice of its rows; three quantities there are
global, not per device: the masked mean NLL's denominator, the MoE
load-balance term (a product of two global means) and the router
z-loss.  The port's step runs each microbatch's rows split over the
processes of a ``torch.distributed`` group (one card each) and enters
:func:`data_parallel` around the loss; the loss code asks
:func:`active` and, where it is set, sums its partial statistics over
the group with :func:`global_sum`.

A :class:`Shard` describes the slice of one tensor a rank holds under
ZeRO-1 or FSDP: ``count`` equal chunks of dim ``dim``, this rank's chunk
``index``, over the process group ``group`` (the line of ranks that
share the tensor); ``rest`` is the group over which the shards are
replicated (the "pod" axis when the tensor shards over "data" only), or
None.

Under FSDP a parameter is held as its chunk, tagged with its ``Shard``
(:func:`tag`), and the model gathers it where it is used
(:func:`gathered`, the reference's GSPMD-inserted all-gather); a stacked
leaf's layer ``i`` is :func:`layer` of it, a chunk tagged alike.  The
gather's backward pass reduce-scatters the whole weight's gradient in
f32 into the step's accumulator chunk (:class:`_Gather`).

Tensor parallelism over processes (the ``model`` axis over ranks):
the ranks of a :class:`ModelLine` share a microbatch's rows and each
holds its chunk of every weight that ``default_rules`` puts on
``model`` (heads, kv heads, mlp, vocab, experts or expert_mlp), split by
:func:`model_split` and tagged with that ``Shard`` (:func:`tag_model`);
the model code runs on those chunks as they are.  Two operators join
the ranks' parts, Megatron's ``f`` and ``g``: :func:`to_model`
(identity forward; the gradient all-reduced over the line, where each
rank's part of it came through its own chunk) ahead of a column split,
and :func:`from_model` (the partial sums all-reduced forward; the
gradient as it is, every rank's downstream being the same) after a row
split, and the vocabulary split's sums.  :func:`model_max` is that
split's max; :func:`gather_from_model` joins a column split whose
whole output every rank needs (the MoE router's logits).  Serving
(prefill and decode over the line, forward only) adds two:
:func:`model_gather`, a decode step's new keys and values and its q
heads joined whole, and :func:`merge_softmax`, the merge of each rank's
partial softmax statistics over its slots of the KV cache.  Where each
rank reads its own part of a joined or summed tensor, the gradient
must be summed over the line on the way back: :func:`gather_to_model`
(an all-gather whose backward reduce-scatters, Megatron's
sequence-parallel gather: the mamba mixer's ``in_proj`` output and
conv weights) and :func:`sum_to_model` (a sum whose backward sums: the
gated norm's sum of squares over the rank's heads).  The active
line is :class:`DataParallel`'s ``model`` (:func:`model_line`).  A
chunk under FSDP or ZeRO-1 over TP is the data split of the model
chunk: :func:`whole` gathers both, :func:`cut` cuts both.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

F32 = torch.float32


@dataclass(frozen=True)
class ModelLine:
    """The ranks that split the weights over the ``model`` axis: their
    ``group``, its ``size``, this rank's ``index`` on it, and ``span``,
    the group of this rank's data and model lines together (a sum of
    every rank's part of a norm)."""

    group: object
    size: int
    index: int
    span: object = None


@dataclass(frozen=True)
class DataParallel:
    """The group a microbatch's rows are split over, and its size; under
    FSDP ``grads(x)`` gives the f32 accumulator chunk into which the
    gradient of the chunk ``x`` (a parameter, or a layer of one) is
    reduce-scattered, or None; under tensor parallelism ``model`` is
    the rank's :class:`ModelLine`."""

    group: object
    size: int
    grads: Optional[Callable] = None
    model: Optional[ModelLine] = None


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_dp",
                                                         default=None)


@contextlib.contextmanager
def data_parallel(dp: Optional[DataParallel]):
    """Make ``dp`` the active data-parallel group inside the block (None:
    none, the one-process loss)."""
    token = _ACTIVE.set(dp)
    try:
        yield dp
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[DataParallel]:
    """The active data-parallel group, or None."""
    return _ACTIVE.get()


class _GlobalSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the group's ranks.  Backward: the
    incoming gradient as it is, not summed over the ranks.

    Every rank's loss holds the whole global term (the NLL over the
    microbatch, the load balance of the global means), and the step
    sums the ranks' parameter gradients afterwards.  The gradient a rank
    owes is the term's derivative through its own rows only, which is
    ``grad_out`` itself.  ``torch.distributed.nn.functional.all_reduce``
    would all-reduce ``grad_out`` in its backward pass as well: each
    rank would then carry W times its share, and the step's sum would
    count the term W times."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active group's ranks (see :class:`_GlobalSum`
    for its gradient); ``x`` itself with no active group."""
    dp = active()
    if dp is None:
        return x
    return _GlobalSum.apply(x, dp.group)


# ------------------------------------------------------------ model line
def model_line() -> Optional[ModelLine]:
    """The active model line (tensor parallelism), or None."""
    dp = active()
    return None if dp is None else dp.model


def _f32_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in f32 (or ``x``'s wider dtype), back
    in ``x``'s dtype (a bf16 tensor's parts are rounded once, after the
    sum)."""
    y = x.detach().to(torch.promote_types(x.dtype, F32), copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Forward: ``x`` as it is (every rank of the line holds it whole).
    Backward: the gradient summed over the line: each rank's is the part
    that came through its own chunks of the weights that follow."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _f32_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the ranks' partial sums summed over the line (in f32).
    Backward: the gradient as it is: what follows runs alike on every
    rank of the line, so each holds the whole gradient already."""

    @staticmethod
    def forward(ctx, x, group):
        return _f32_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``f`` over the active model line (:class:`_CopyToModel`):
    ahead of a column split, or on a weight every rank uses a part of;
    ``x`` itself with no line."""
    mp = model_line()
    return x if mp is None else _CopyToModel.apply(x, mp.group)


def from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``g`` over the active model line
    (:class:`_ReduceFromModel`): after a row split, and the vocabulary
    split's sums; ``x`` itself with no line."""
    mp = model_line()
    return x if mp is None else _ReduceFromModel.apply(x, mp.group)


class _GatherFromModel(torch.autograd.Function):
    """Forward: the line's chunks of ``x`` concatenated along ``dim`` in
    rank order (every rank holds the whole).  Backward: this rank's
    slice of the gradient: what follows runs alike on every rank of the
    line, so each holds the whole gradient already."""

    @staticmethod
    def forward(ctx, x, dim, mp):
        ctx.sh = Shard(dim, x.shape[dim] * mp.size, mp.index, mp.size,
                       mp.group)
        return all_gather(x.detach(), ctx.sh)

    @staticmethod
    def backward(ctx, grad):
        return ctx.sh.of(grad), None, None


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The whole tensor of the line's chunks of ``x`` along ``dim``
    (:class:`_GatherFromModel`: the MoE router's expert columns); ``x``
    itself with no line."""
    mp = model_line()
    return x if mp is None else _GatherFromModel.apply(x, dim % x.dim(), mp)


class _GatherToModel(torch.autograd.Function):
    """Forward: the line's chunks of ``x`` concatenated along ``dim`` in
    rank order.  Backward: the incoming gradient summed over the line in
    f32, of which this rank keeps its slice: each rank reads its own
    part of the whole, so each holds a part of the whole gradient."""

    @staticmethod
    def forward(ctx, x, dim, mp):
        ctx.sh = Shard(dim, x.shape[dim] * mp.size, mp.index, mp.size,
                       mp.group)
        return all_gather(x.detach(), ctx.sh)

    @staticmethod
    def backward(ctx, grad):
        wide = torch.promote_types(grad.dtype, F32)
        return reduce_scatter(grad, ctx.sh, wide).to(grad.dtype), None, None


def gather_to_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The whole tensor of the line's chunks of ``x`` along ``dim``, its
    gradient reduce-scattered (:class:`_GatherToModel`); ``x`` itself
    with no line."""
    mp = model_line()
    return x if mp is None else _GatherToModel.apply(x, dim % x.dim(), mp)


class _SumToModel(torch.autograd.Function):
    """Forward: ``x`` summed over the line (in f32).  Backward: the
    gradient summed over the line too: each rank's downstream differs
    (its own columns normalised by the same total), so the total's
    gradient is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _f32_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _f32_sum(grad, ctx.group), None


def sum_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active model line, its gradient summed too
    (:class:`_SumToModel`); ``x`` itself with no line."""
    mp = model_line()
    return x if mp is None else _SumToModel.apply(x, mp.group)


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the active model line, outside
    autograd (a logsumexp's shift, whose gradient cancels)."""
    mp = model_line()
    y = x.detach().clone()
    if mp is not None:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mp.group)
    return y


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The line's chunks of ``x`` concatenated along ``dim`` in rank
    order, outside autograd (serving: a decode step's new keys and
    values of the rank's kv heads, its q heads); ``x`` itself with no
    line."""
    mp = model_line()
    if mp is None:
        return x
    dim %= x.dim()
    return all_gather(x.detach(), Shard(dim, x.shape[dim] * mp.size,
                                        mp.index, mp.size, mp.group))


def merge_softmax(m: torch.Tensor, l: torch.Tensor,
                  o: torch.Tensor) -> torch.Tensor:
    """The softmax-weighted sum over the line's slots from each rank's
    partial statistics over its own: ``m`` (...,) its largest score,
    ``l`` (...,) its sum of ``exp(s - m)``, ``o`` (..., hd) its sum of
    ``exp(s - m) v``, all f32 (a rank with no valid slot holds l = 0 and
    o = 0, so its ``m`` counts for nothing).  One all-reduce max of
    ``m``, then one f32 sum of ``l e^(m_r - M)`` and ``o e^(m_r - M)``;
    returns the sum of o over the sum of l, f32, outside autograd.  With
    no line, ``o / l``."""
    mp = model_line()
    if mp is None:
        return o / l[..., None]
    top = m.detach().clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mp.group)
    a = torch.exp(m - top)
    both = torch.cat([(l * a)[..., None], o * a[..., None]], dim=-1)
    dist.all_reduce(both, group=mp.group)
    return both[..., 1:] / both[..., :1]


# ------------------------------------------------------------------ shards
@dataclass(frozen=True, eq=False)
class Shard:
    """Chunk ``index`` of ``count`` along dim ``dim`` (extent ``full``)
    over ``group``; the chunks are replicated over ``rest`` (a group, or
    None)."""

    dim: int
    full: int
    index: int
    count: int
    group: object
    rest: object = None

    @property
    def size(self) -> int:
        return self.full // self.count

    def shape(self, shape: tuple) -> tuple:
        """The shard's shape for a tensor of ``shape``."""
        shape = list(shape)
        shape[self.dim] = self.size
        return tuple(shape)

    def of(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the whole ``x`` (a view)."""
        return x.narrow(self.dim, self.index * self.size, self.size)


DP_AXES = ("pod", "data")
MODEL_AXIS = "model"


def _ranked(spec: tuple, shape: tuple, mesh, dp_axes: tuple):
    """(dim, ranked axes of its entry) for each dim of ``spec``; an entry
    that names an axis of extent > 1 that is neither a data axis nor
    the model axis, or names both, raises ``NotImplementedError``."""
    out = []
    for dim, e in enumerate(spec):
        names = () if e is None else ((e,) if isinstance(e, str)
                                      else tuple(e))
        big = tuple(n for n in names if mesh.shape[n] > 1)
        data = tuple(n for n in big if n in dp_axes)
        if big and data != big and big != (MODEL_AXIS,):
            raise NotImplementedError(
                f"dim {dim} of {shape} split over {names}: only the data "
                f"axes {dp_axes} and the model axis span ranks, one kind "
                "a dim")
        out.append((dim, big))
    return out


def model_split(spec: tuple, shape: tuple, mesh,
                dp_axes: tuple = DP_AXES) -> Optional[Shard]:
    """This rank's ``Shard`` of the whole tensor (``shape``) over the
    model line: the dim whose ``spec`` entry names the model axis of
    extent > 1 (tensor parallelism); None where none does.  A dim that
    does not divide raises ``ValueError``."""
    for dim, big in _ranked(spec, shape, mesh, dp_axes):
        if big != (MODEL_AXIS,):
            continue
        group, count, index = mesh.line((MODEL_AXIS,))
        if shape[dim] % count:
            raise ValueError(f"dim {dim} of {shape} does not divide over "
                             f"{MODEL_AXIS!r}")
        return Shard(dim, shape[dim], index, count, group)
    return None


def shard_for(spec: tuple, shape: tuple, mesh,
              dp_axes: tuple = DP_AXES) -> Optional[Shard]:
    """This rank's data ``Shard`` of a tensor of ``shape`` under ``spec``
    (one entry per dim) over a mesh of processes: the first dim whose
    entry names ``dp_axes`` of extent > 1 splits over their line
    (row-major), replicated over the other data axes; None where no dim
    does.  Under tensor parallelism ``shape`` is the model chunk's
    (:func:`model_split` of the same spec gives the model split, on
    another dim).  An entry that names any other axis of extent > 1, or
    a data axis and the model axis together, raises
    ``NotImplementedError``; a dim that does not divide raises
    ``ValueError``."""
    for dim, big in _ranked(spec, shape, mesh, dp_axes):
        axes = tuple(n for n in big if n in dp_axes)
        if not axes:
            continue
        group, count, index = mesh.line(axes)
        if shape[dim] % count:
            raise ValueError(f"dim {dim} of {shape} does not divide over "
                             f"{axes}")
        rest = tuple(a for a in dp_axes if a in mesh.axis_names
                     and a not in axes and mesh.shape[a] > 1)
        return Shard(dim, shape[dim], index, count, group,
                     mesh.line(rest)[0] if rest else None)
    return None


def barrier(group) -> None:
    """Wait for every rank of ``group`` (nothing with no group)."""
    if group is not None:
        dist.barrier(group=group)


def tag(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """``x`` marked as ``shard``'s chunk (read by the checkpoint and the
    elastic reshard); returns ``x``."""
    if shard is not None:
        x._shard = shard
    return x


def shard_of(x: torch.Tensor) -> Optional[Shard]:
    return getattr(x, "_shard", None)


def tag_model(x: torch.Tensor, split: Optional[Shard]) -> torch.Tensor:
    """``x`` marked as the model chunk ``split`` of its whole tensor (a
    data chunk of that chunk keeps both marks); returns ``x``."""
    if split is not None:
        x._model = split
    return x


def model_of(x: torch.Tensor) -> Optional[Shard]:
    return getattr(x, "_model", None)


def whole(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a marked chunk: its data split all-gathered,
    then its model split (every rank of both lines calls this together);
    an unmarked tensor as it is."""
    sh, m = shard_of(x), model_of(x)
    if sh is not None:
        x = all_gather(x.detach(), sh)
    if m is not None:
        x = all_gather(x.detach(), m)
    return x


def cut(x: torch.Tensor, split: Optional[Shard],
        sh: Optional[Shard]) -> torch.Tensor:
    """This rank's chunk (a view) of the whole ``x``: the model
    ``split``'s chunk, then the data split ``sh``'s of it."""
    if split is not None:
        x = split.of(x)
    return x if sh is None else sh.of(x)


def _chunks_first(x: torch.Tensor, sh: Shard, dtype) -> torch.Tensor:
    """``x`` (the whole tensor) as ``count`` contiguous chunks along a
    new leading dim, in ``dtype``: one copy (dim ``sh.dim``'s chunks are
    strided where it is not the leading dim)."""
    y = x.unflatten(sh.dim, (sh.count, sh.size)).movedim(sh.dim, 0)
    return torch.empty(y.shape, dtype=dtype, device=x.device).copy_(y)


def reduce_scatter(x: torch.Tensor, sh: Shard,
                   dtype: torch.dtype = F32) -> torch.Tensor:
    """The sum over ``sh.group`` of the whole tensor ``x``, in ``dtype``
    (f32), of which this rank keeps its chunk (a new contiguous tensor).
    The chunks go in as one tensor whose dim 0 is the chunks' dim 0s end
    to end (gloo checks the shapes, not only the sizes)."""
    out = torch.empty(sh.shape(x.shape), dtype=dtype, device=x.device)
    dist.reduce_scatter_tensor(out, _chunks_first(x, sh, dtype).flatten(0, 1),
                               group=sh.group)
    return out


def all_gather(x: torch.Tensor, sh: Shard) -> torch.Tensor:
    """The whole tensor from every rank's chunk ``x`` (new memory)."""
    out = torch.empty((sh.count,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out.flatten(0, 1), x.contiguous(),
                                group=sh.group)
    return out.movedim(0, sh.dim).flatten(sh.dim, sh.dim + 1)


class _Gather(torch.autograd.Function):
    """Forward: the whole weight from every rank's chunk (:func:`all_gather`
    over ``sh.group``).  Backward: the whole weight's gradient cast to f32
    and reduce-scattered over ``sh.group`` (:func:`reduce_scatter`), then
    all-reduced over ``sh.rest`` where the chunk is replicated there.

    Autograd casts a backward's output to its input's dtype, so the f32
    sum returned as a bf16 chunk's gradient would be rounded before it
    reached the f32 accumulator (ZeRO-1 adds the unrounded sum).  So the
    backward adds the f32 sum into the accumulator chunk ``acc`` that the
    training step gave (``DataParallel.grads``) and returns no gradient
    for the chunk.  A chunk gathered outside a step has no accumulator:
    its forward runs, its backward raises (before any collective, so no
    rank waits on another).

    The Function carries its groups (in ``sh``) and its accumulator
    (captured in the forward): on a card the backward pass runs on the
    autograd engine's thread, where :func:`active`'s context is not
    set.  Every rank builds the same graph, so the gathers (the forward
    pass and the remat recompute) and the reduce-scatters (the backward
    pass) run in the same order on every rank."""

    @staticmethod
    def forward(ctx, chunk, sh, acc):
        ctx.sh, ctx.acc = sh, acc
        return all_gather(chunk.detach(), sh)

    @staticmethod
    def backward(ctx, grad):
        if ctx.acc is None:
            raise RuntimeError(
                "an FSDP chunk gathered outside a training step has no "
                "f32 accumulator for its gradient (build_train_step)")
        part = reduce_scatter(grad, ctx.sh)
        if ctx.sh.rest is not None:
            dist.all_reduce(part, group=ctx.sh.rest)
        ctx.acc.add_(part)
        return None, None, None


def gather(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a tagged chunk ``x`` (an FSDP parameter, or a
    layer of one), differentiable (:class:`_Gather`); ``x`` itself where
    it is not tagged."""
    sh = shard_of(x)
    if sh is None:
        return x
    dp = active()
    acc = None if dp is None or dp.grads is None else dp.grads(x)
    return _Gather.apply(x, sh, acc)


def gathered(tree):
    """``tree`` (nested dicts) with every tagged chunk gathered
    (:func:`gather`)."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    return gather(tree)


def layer(x: torch.Tensor, i: int) -> torch.Tensor:
    """``x[i]``, layer ``i`` of a stacked leaf (a view); of a tagged
    chunk, tagged with the layer's ``Shard`` (one dim fewer) and with
    ``(x, i)``, by which the step finds the layer's accumulator."""
    y = x[i]
    sh = shard_of(x)
    if sh is not None:                  # the stacked dim is never sharded
        tag(y, dataclasses.replace(sh, dim=sh.dim - 1))
        y._stack = (x, i)
    return y


def gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ranks' row blocks of ``x`` concatenated in rank order."""
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


__all__ = ["ModelLine", "DataParallel", "data_parallel", "active",
           "global_sum", "model_line", "to_model", "from_model",
           "gather_from_model", "gather_to_model", "sum_to_model",
           "model_max", "model_gather", "merge_softmax", "Shard",
           "DP_AXES", "MODEL_AXIS",
           "model_split", "shard_for", "barrier", "tag", "shard_of",
           "tag_model", "model_of", "whole", "cut", "reduce_scatter",
           "all_gather", "gather", "gathered", "layer", "gather_rows"]
