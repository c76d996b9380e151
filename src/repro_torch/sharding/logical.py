"""Logical-axis sharding rules, the cluster-sharded serving mesh and
the LM-side sharding descriptions.

Port of ``repro/sharding/logical.py``.  Every tensor is annotated with
*logical* axis names and a rule table maps them to mesh axes; a spec is
a plain tuple with one entry per tensor axis (``None``, one mesh axis
name, or a tuple of names), the reference's ``PartitionSpec`` parts.

The serving mesh is 1-D, ``("data",)``, one entry per shard: the
snapshot's ``clusters`` axis splits across it (the reference's
DESIGN.md §4).  A :class:`Mesh` may name one device several times; that
runs several shards on one card (or on the CPU), as the reference's
tests run fake XLA host devices.

The LM side (the dry-run, the training step, elastic restore) uses an
N-D :class:`LogicalMesh`: axis names and extents, devices optional (the
256- and 512-chip production meshes have none).  A "sharding" there is
a description, :class:`NamedSharding` (a mesh and a spec, with
``shard_shape``), not a placement: the port runs in one process, and
:func:`constrain` / :func:`maybe_constrain` return their tensor as it is
(with one device on every axis, the reference's constraint is the
identity too; over several devices it changes the layout, never the
values).  Training over a data axis of several distinct cards in one
process (GSPMD in the reference) is not ported (ROADMAP).

A :class:`LogicalMesh` with a ``group`` spans the processes of an
initialized ``torch.distributed`` group instead, one card each: its
positions are the group's ranks in row-major order (so a rank's
coordinate on ``("pod", "data")`` is pod-major), and ``device`` is this
process's card.  Placement is by process, not by layout: the training
step (``train/step.py``) reads the mesh to split the batch over the
ranks and to reduce or shard the gradients, while :func:`constrain`
stays the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..kernels.dispatch import resolve_device

# logical axis vocabulary (the reference's):
#   batch      — global batch                 → ("pod", "data")
#   seq        — sequence (activations)       → None (or "model" under SP)
#   embed      — d_model                      → None (or "data" under FSDP)
#   heads      — attention q heads            → "model"
#   kv_heads   — attention kv heads           → "model" if divisible
#   qkv        — per-head feature             → None
#   mlp        — FFN hidden                   → "model"
#   vocab      — vocabulary                   → "model"
#   experts    — MoE experts                  → "model"
#   layers     — stacked scan dim             → None
#   kv_seq     — KV-cache sequence            → "model"
#   ssm_state  — SSD state dim                → None
#   ssm_inner  — SSD inner (expand*d)         → "model"
#   clusters   — LIMS snapshot cluster axis   → "data" (cluster-granular
#                serving shards; pivot tables stay valid under partition)


def default_rules(fsdp: bool = False, seq_shard: bool = False,
                  kv_heads_shardable: bool = True) -> dict:
    return {
        "batch": ("pod", "data"),
        "seq": "model" if seq_shard else None,
        "embed": "data" if fsdp else None,
        "embed_noshard": None,
        "heads": "model",
        "kv_heads": "model" if kv_heads_shardable else None,
        "qkv": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        # TP-within-expert when the expert count does not divide the
        # model axis; spec_for's double-use guard keeps the two rules
        # mutually exclusive per tensor
        "expert_mlp": "model",
        "layers": None,
        "kv_seq": "model",
        "ssm_state": None,
        "ssm_inner": "model",
        "conv": None,
        "clusters": "data",
    }


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices[i]`` holds shard i.

    Devices are ``torch.device``s (strings are accepted); a bare
    ``cuda`` means the current card.  A device may repeat.  Naming a
    CUDA device where there is no card raises ``RuntimeError``."""

    devices: tuple
    axis_names: tuple = ("data",)

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"the serving mesh is 1-D, got axes "
                             f"{self.axis_names}")
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        devs = []
        for d in self.devices:
            d = resolve_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        object.__setattr__(self, "devices", tuple(devs))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        """{axis name: extent}."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def serving_mesh(n_shards: Optional[int] = None) -> Mesh:
    """1-D ``("data",)`` mesh over every visible CUDA device, or the
    first ``n_shards`` of them (at least one).  Raises ``RuntimeError``
    where there is no card: it never falls back to the CPU; a mesh of
    CPU devices is built explicitly."""
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_dev == 0:
        raise RuntimeError(
            "no CUDA device is available for the serving mesh; pass "
            "Mesh(devices=...) to shard over explicit devices")
    n = n_dev if n_shards is None else max(1, min(n_shards, n_dev))
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def spec_for(axes: tuple, rules: dict, mesh: Mesh,
             shape: Optional[tuple] = None) -> tuple:
    """Logical axes → a spec tuple, dropping mesh axes that don't exist
    (e.g. "pod" on the single-pod mesh), avoiding double use, and —
    when ``shape`` is given — dropping assignments whose dim isn't
    divisible by the mesh extent (replicated instead of an error)."""
    used: set = set()
    parts = []
    for i, ax in enumerate(axes):
        r = rules.get(ax, None) if ax is not None else None
        if r is None:
            parts.append(None)
            continue
        names = (r,) if isinstance(r, str) else tuple(r)
        names = tuple(n for n in names
                      if n in mesh.axis_names and n not in used)
        if shape is not None and names:
            extent = 1
            for n in names:
                extent *= mesh.shape[n]
            if extent == 0 or shape[i] % extent != 0:
                names = ()
        used.update(names)
        parts.append(names if len(names) > 1
                     else (names[0] if names else None))
    return tuple(parts)


def shardable(dim: int, mesh: Mesh, axis: str = "model") -> bool:
    if mesh is None or axis not in mesh.axis_names:
        return False
    return dim % mesh.shape[axis] == 0


# ---------------------------------------------------------------- LM side
@dataclass(frozen=True)
class LogicalMesh:
    """An N-D mesh: ``axis_names`` with extents ``axis_sizes``, and
    optionally its ``devices`` (``torch.device``s, row-major, one per
    position; a device may repeat, as in :class:`Mesh`)."""

    axis_names: tuple
    axis_sizes: tuple
    devices: Optional[tuple] = None
    # over processes: the torch.distributed group whose ranks are the
    # mesh's positions, and this process's device
    group: Optional[object] = None
    device: Optional[torch.device] = None

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(self.axis_sizes)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"axes {names} and extents {sizes} do not "
                             "match")
        if any(int(n) < 0 for n in sizes):
            raise ValueError(f"negative extent in {sizes}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", tuple(int(n) for n in sizes))
        if self.devices is not None:
            devs = tuple(torch.device(d) for d in self.devices)
            if len(devs) != self.size:
                raise ValueError(f"{len(devs)} devices for a mesh of "
                                 f"{self.size}")
            object.__setattr__(self, "devices", devs)
        if self.group is not None:
            import torch.distributed as dist
            if self.devices is not None:
                raise ValueError("a mesh over processes names one device, "
                                 "this process's: pass device=, not "
                                 "devices=")
            world = dist.get_world_size(self.group)
            if world != self.size:
                raise ValueError(f"a mesh of {self.size} over a group of "
                                 f"{world} processes")
            object.__setattr__(self, "device", torch.device(
                self.device if self.device is not None else "cpu"))
        object.__setattr__(self, "_lines", {})

    @property
    def shape(self) -> dict:
        """{axis name: extent}."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def empty(self) -> bool:
        return self.size == 0

    def distinct_devices(self, axis: str) -> int:
        """How many distinct devices one line along ``axis`` holds (the
        first line; 1 for a mesh without devices, which places nothing;
        the axis's extent over processes, one card a rank)."""
        if self.group is not None:
            return self.shape[axis]
        if self.devices is None:
            return 1
        i = self.axis_names.index(axis)
        stride = 1
        for s in self.axis_sizes[i + 1:]:
            stride *= s
        return len({self.devices[k * stride]
                    for k in range(self.axis_sizes[i])})

    @property
    def rank(self) -> int:
        """This process's rank in the mesh's group (0 in one process)."""
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    def coords(self, rank: Optional[int] = None) -> dict:
        """{axis: coordinate} of ``rank`` (default this process's),
        row-major."""
        r = self.rank if rank is None else rank
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def line(self, axes) -> tuple:
        """(group, size, index) of this rank's line along ``axes`` (the
        ranks that differ from it only there; ``index`` row-major over
        ``axes``).  Over processes the sub-groups are made on the first
        call for ``axes``, which every rank of the group must make
        together (``torch.distributed.new_group``); a line that spans
        the whole mesh is its group.  ``(None, 1, 0)`` in one process."""
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        if self.group is None:
            return None, 1, 0
        size = 1
        for a in axes:
            size *= self.shape[a]
        c = self.coords()
        index = 0
        for a in axes:
            index = index * self.shape[a] + c[a]
        if size == self.size:
            return self.group, size, index
        if axes not in self._lines:
            import itertools
            import torch.distributed as dist
            others = [a for a in self.axis_names if a not in axes]
            mine = None
            for fixed in itertools.product(*(range(self.shape[a])
                                             for a in others)):
                ranks = []
                for inner in itertools.product(*(range(self.shape[a])
                                                 for a in axes)):
                    pos = dict(zip(others, fixed)) | dict(zip(axes, inner))
                    r = 0
                    for a in self.axis_names:
                        r = r * self.shape[a] + pos[a]
                    ranks.append(dist.get_global_rank(self.group, r)
                                 if self.group is not dist.group.WORLD
                                 else r)
                g = dist.new_group(ranks)
                if all(pos_c == c[a] for a, pos_c in zip(others, fixed)):
                    mine = g
            self._lines[axes] = mine
        return self._lines[axes], size, index


@dataclass(frozen=True)
class NamedSharding:
    """A sharding description: ``spec`` (one entry per tensor axis) over
    ``mesh``'s axes, the reference's ``NamedSharding``."""

    mesh: object
    spec: tuple

    def shard_shape(self, shape: tuple) -> tuple:
        """The per-device shape: each dim divided by the extents of the
        mesh axes its entry names; ``ValueError`` where one does not
        divide it (as the reference's)."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {shape}")
        out = []
        for i, n in enumerate(shape):
            e = self.spec[i] if i < len(self.spec) else None
            names = () if e is None else ((e,) if isinstance(e, str)
                                          else tuple(e))
            extent = 1
            for a in names:
                extent *= self.mesh.shape[a]
            if extent and n % extent:
                raise ValueError(f"dim {i} of {shape} does not divide by "
                                 f"{extent} ({names})")
            out.append(n // extent if extent else n)
        return tuple(out)


def guarded_sharding(shape: tuple, axes: tuple, rules: dict,
                     mesh) -> NamedSharding:
    return NamedSharding(mesh, spec_for(axes, rules, mesh, shape))


def sharding_for(axes: tuple, rules: dict, mesh) -> NamedSharding:
    return NamedSharding(mesh, spec_for(axes, rules, mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(axes_tree, rules: dict, mesh):
    """Map a nested dict of logical-axes tuples to NamedShardings."""
    if _is_axes(axes_tree):
        return sharding_for(axes_tree, rules, mesh)
    return {k: tree_shardings(v, rules, mesh) for k, v in axes_tree.items()}


def constrain(x: torch.Tensor, axes: tuple, rules: Optional[dict], mesh):
    """Activation sharding constraint by logical axes: ``x`` itself (the
    values a constraint never changes; one process places nothing).  The
    spec is resolved, so an axis that does not divide raises as the
    reference's does.  No-op without a mesh."""
    if rules is None or mesh is None or mesh.empty:
        return x
    sharding_for(axes, rules, mesh).shard_shape(tuple(x.shape))
    return x


# Active-mesh context: model code (the MoE dispatch) adds activation
# constraints only when the launcher declares the mesh axes it runs
# under (the dry-run); elsewhere they are no-ops.
_ACTIVE_AXES: tuple = ()


def set_active_mesh_axes(names) -> None:
    global _ACTIVE_AXES
    _ACTIVE_AXES = tuple(names or ())


def maybe_constrain(x: torch.Tensor, spec_elems: tuple) -> torch.Tensor:
    """``spec_elems`` filtered to the declared mesh axes, as the
    reference's; ``x`` itself (see :func:`constrain`)."""
    if not _ACTIVE_AXES:
        return x
    if len(spec_elems) > x.dim():
        raise ValueError(f"spec {spec_elems} has more entries than "
                         f"x's {x.dim()} dims")
    return x


__all__ = ["Mesh", "LogicalMesh", "NamedSharding", "default_rules",
           "serving_mesh", "spec_for", "shardable", "guarded_sharding",
           "sharding_for", "tree_shardings", "constrain",
           "set_active_mesh_axes", "maybe_constrain"]
