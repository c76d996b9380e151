"""Logical-axis sharding rules and the cluster-sharded serving mesh.

Port of ``repro/sharding/logical.py``, the part the index's sharded
serving uses.  Every tensor is annotated with *logical* axis names and a
rule table maps them to mesh axes; a spec is a plain tuple with one
entry per tensor axis (``None``, one mesh axis name, or a tuple of
names), the reference's ``PartitionSpec`` parts.

The serving mesh is 1-D, ``("data",)``, one entry per shard: the
snapshot's ``clusters`` axis splits across it (the reference's
DESIGN.md §4).  A :class:`Mesh` may name one device several times; that
runs several shards on one card (or on the CPU), as the reference's
tests run fake XLA host devices.

The LM-side helpers (``constrain``, ``maybe_constrain``,
``guarded_sharding``, ``sharding_for``, ``tree_shardings``,
``set_active_mesh_axes``) wait for the LM's training and MoE paths
(ROADMAP A14).
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


__all__ = ["Mesh", "default_rules", "serving_mesh", "spec_for", "shardable"]
