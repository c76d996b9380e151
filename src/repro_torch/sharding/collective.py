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
class DataParallel:
    """The group a microbatch's rows are split over, and its size; under
    FSDP ``grads(x)`` gives the f32 accumulator chunk into which the
    gradient of the chunk ``x`` (a parameter, or a layer of one) is
    reduce-scattered, or None."""

    group: object
    size: int
    grads: Optional[Callable] = None


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


def shard_for(spec: tuple, shape: tuple, mesh,
              dp_axes: tuple = DP_AXES) -> Optional[Shard]:
    """This rank's ``Shard`` of a tensor of ``shape`` under ``spec`` (one
    entry per dim) over a mesh of processes: the first dim whose entry
    names ``dp_axes`` of extent > 1 splits over their line (row-major),
    replicated over the other data axes; None where no dim does.  An
    entry that also names another axis of extent > 1 raises
    ``NotImplementedError`` (only the data axes span ranks); a dim that
    does not divide raises ``ValueError``."""
    for dim, e in enumerate(spec):
        names = () if e is None else ((e,) if isinstance(e, str)
                                      else tuple(e))
        big = [n for n in names if mesh.shape[n] > 1]
        axes = tuple(n for n in big if n in dp_axes)
        if len(axes) != len(big):
            raise NotImplementedError(
                f"dim {dim} of {shape} split over {names}: only the data "
                f"axes {dp_axes} span ranks")
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


def _chunks_first(x: torch.Tensor, sh: Shard, dtype) -> torch.Tensor:
    """``x`` (the whole tensor) as ``count`` contiguous chunks along a
    new leading dim, in ``dtype``: one copy (dim ``sh.dim``'s chunks are
    strided where it is not the leading dim)."""
    y = x.unflatten(sh.dim, (sh.count, sh.size)).movedim(sh.dim, 0)
    return torch.empty(y.shape, dtype=dtype, device=x.device).copy_(y)


def reduce_scatter(x: torch.Tensor, sh: Shard) -> torch.Tensor:
    """The sum over ``sh.group`` of the whole tensor ``x``, in f32, of
    which this rank keeps its chunk (a new contiguous tensor).  The
    chunks go in as one tensor whose dim 0 is the chunks' dim 0s end to
    end (gloo checks the shapes, not only the sizes)."""
    out = torch.empty(sh.shape(x.shape), dtype=F32, device=x.device)
    dist.reduce_scatter_tensor(out, _chunks_first(x, sh, F32).flatten(0, 1),
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


__all__ = ["DataParallel", "data_parallel", "active", "global_sum", "Shard",
           "DP_AXES", "shard_for", "barrier", "tag", "shard_of",
           "reduce_scatter", "all_gather", "gather", "gathered", "layer",
           "gather_rows"]
