"""Parameter specification and materialisation.

Port of ``repro/models/params.py``: parameters are plain nested dicts of
tensors, described first as ``ParamSpec`` trees.  ``init_params`` draws
with the reference's rules (``fan_in``, ``normal`` at 0.02 x scale,
``zeros``, ``ones``) from an explicit ``torch.Generator``; its values
are not JAX's threefry draws, so parity tests carry the reference's own
parameters across (``repro_torch.convert.params_from_reference``).
``abstract_params`` describes the parameters without allocating: a
tensor on the ``meta`` device per leaf, with its sharding description
(``sharding/logical.py``) as its ``sharding`` attribute where a mesh is
given, the reference's ``ShapeDtypeStruct`` leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..sharding.logical import guarded_sharding


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                       # logical axis names, len == len(shape)
    init: str = "fan_in"              # fan_in | normal | zeros | ones
    scale: float = 1.0
    dtype: Optional[str] = None       # override model compute dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` and so on."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def map_specs(fn, specs):
    """Apply ``fn`` to every ``ParamSpec`` leaf of a nested dict."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def _leaves(specs) -> list:
    if isinstance(specs, ParamSpec):
        return [specs]
    return [s for v in specs.values() for s in _leaves(v)]


def _draw_dims(s: ParamSpec) -> int:
    """How many leading dims of a leaf ``init_params`` draws one index
    at a time: its leading "layers" and "experts" axes, leaving at
    least a 2-D matrix a draw."""
    lead = 0
    while lead < len(s.axes) - 2 and s.axes[lead] in ("layers", "experts"):
        lead += 1
    return lead


def init_params(specs, generator: torch.Generator, dtype: str,
                device=None):
    """Materialise parameters on ``device`` (default ``cuda``; raises
    without a card).  The leaves are drawn in the specs' dict order from
    ``generator``, which must live on that device.  A stacked leaf is
    drawn one layer (and, for an expert stack, one expert) at a time, so
    the f32 draw never needs more than one matrix's memory beside the
    result: a layer of kimi-k2's ``we1`` is 384 (7168, 2048) matrices,
    22.5 GB in f32, where one matrix is 58.7 MB."""
    dev = resolve_device(device)

    def one(s: ParamSpec):
        dt = torch_dtype(s.dtype or dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        if s.init == "normal":
            std = 0.02 * s.scale
        else:  # fan_in
            fan = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
            std = s.scale / np.sqrt(max(fan, 1))
        out = torch.empty(s.shape, dtype=dt, device=dev)
        lead = _draw_dims(s)
        for part in out.reshape((-1,) + s.shape[lead:]) if lead else (out,):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=dev) * std)
        return out

    return map_specs(one, specs)


def abstract(shape: tuple, dtype: torch.dtype, sharding=None):
    """A ``meta`` tensor standing for an array of ``shape`` and
    ``dtype``, with ``sharding`` (a description, or None) attached."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.sharding = sharding
    return t


def abstract_params(specs, dtype: str, mesh=None, rules=None):
    """ParamSpec tree -> the same tree of ``meta`` tensors (nothing is
    allocated), each with its guarded sharding over ``mesh``."""
    def one(s: ParamSpec):
        sh = None if mesh is None else guarded_sharding(s.shape, s.axes,
                                                        rules, mesh)
        return abstract(s.shape, torch_dtype(s.dtype or dtype), sh)

    return map_specs(one, specs)


def axes_tree(specs):
    return map_specs(lambda s: s.axes, specs)


def count_params(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for s in _leaves(specs)))


def tree_bytes(specs, dtype: str) -> int:
    return int(sum(int(np.prod(s.shape)) *
                   torch_dtype(s.dtype or dtype).itemsize
                   for s in _leaves(specs)))


__all__ = ["ParamSpec", "init_params", "count_params", "tree_bytes",
           "map_specs", "torch_dtype", "abstract", "abstract_params",
           "axes_tree"]
