"""Elastic scaling: rebuild the mesh from the devices that are alive and
reshard state onto it.

Port of ``repro/runtime/elastic.py``.  ``plan_mesh`` picks the largest
usable (data, model) grid for the surviving device count (the model
degree is pinned by the config's divisibility constraints; the data
axis absorbs the loss); ``reshard_state`` moves every leaf through the
host onto the new mesh with its sharding description (the checkpoint
restore, ``ckpt/checkpoint.py``, is mesh-agnostic already).  One
process holds a leaf whole: the description says how the mesh would
split it, and the leaf lands on the mesh's first device.

Over processes (a mesh with a ``group``, ``launch.ranks``) a leaf is
this rank's chunk of the dim its description puts on the ``model``
axis (tensor parallelism), then of the dim it puts on the mesh's pod /
data axes, marked with its ``sharding.collective.Shard``s as the
state's chunks are (an FSDP state's parameters: their axes under
``default_rules(fsdp=True)``).  A state moves from W ranks to W' in two halves:
the W ranks gather their chunks (:func:`gather_state`, every rank
together), and the W' ranks (or one process) cut theirs from the whole
state (:func:`reshard_state`); between processes that are not the same
ones, the checkpoint carries the whole state.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..sharding import collective
from ..sharding.logical import LogicalMesh, sharding_for
from ..train.optim import tree_map


def plan_mesh(n_devices: int, model_parallel: int,
              axis_names=("data", "model")) -> tuple:
    """Largest (data, model) grid with the pinned model degree."""
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    data = n_devices // mp
    return (data, mp), axis_names


def make_mesh_from(devices: Sequence, model_parallel: int) -> LogicalMesh:
    shape, names = plan_mesh(len(devices), model_parallel)
    return LogicalMesh(names, shape, tuple(devices[:shape[0] * shape[1]]))


def gather_state(state):
    """``state`` with every ZeRO-1, FSDP or model chunk all-gathered into
    its whole tensor (every rank of its lines calls this together);
    other leaves as they are."""
    return tree_map(collective.whole, state)


def reshard_state(state, specs_axes, mesh: LogicalMesh, rules: dict):
    """Every leaf of ``state`` (nested dicts of tensors) through the host
    onto ``mesh``'s first device (the CPU for a mesh without devices),
    with ``sharding`` set to its description under ``rules``;
    ``specs_axes`` holds each leaf's logical axes at the same keys.
    Over processes: onto this rank's device, cut to its chunk; a state
    of chunks is gathered first (:func:`gather_state`)."""
    if mesh.group is not None:
        dev = mesh.device
    else:
        dev = torch.device("cpu") if not mesh.devices else mesh.devices[0]
    state = gather_state(state)

    def one(leaf, axes):
        sh = sharding_for(axes, rules, mesh)
        sh.shard_shape(tuple(leaf.shape))       # a spec that fits
        out = leaf.detach().to("cpu", copy=True).to(dev)
        if mesh.group is not None:
            m = collective.model_split(sh.spec, tuple(out.shape), mesh)
            if m is not None:
                out = collective.tag_model(m.of(out).contiguous(), m)
            part = collective.shard_for(sh.spec, tuple(out.shape), mesh)
            if part is not None:
                out = collective.tag_model(collective.tag(
                    part.of(out).contiguous(), part), m)
        out.sharding = sh
        return out

    return tree_map(one, state, specs_axes)


__all__ = ["plan_mesh", "make_mesh_from", "gather_state", "reshard_state"]
