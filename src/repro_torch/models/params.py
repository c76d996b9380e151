"""Parameter specification and materialisation.

Port of ``repro/models/params.py``: parameters are plain nested dicts of
tensors, described first as ``ParamSpec`` trees.  ``init_params`` draws
with the reference's rules (``fan_in``, ``normal`` at 0.02 x scale,
``zeros``, ``ones``) from an explicit ``torch.Generator``; its values
are not JAX's threefry draws, so parity tests carry the reference's own
parameters across (``repro_torch.convert.params_from_reference``).
``abstract_params`` and ``axes_tree`` wait for sharding (ROADMAP A9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.dispatch import resolve_device


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


def init_params(specs, generator: torch.Generator, dtype: str,
                device=None):
    """Materialise parameters on ``device`` (default ``cuda``; raises
    without a card).  The leaves are drawn in the specs' dict order from
    ``generator``, which must live on that device.  A stacked leaf is
    drawn one leading slice at a time, so the f32 draw never needs more
    than one layer's memory beside the result."""
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
        for part in (out if len(s.shape) >= 3 else (out,)):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=dev) * std)
        return out

    return map_specs(one, specs)


def count_params(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for s in _leaves(specs)))


def tree_bytes(specs, dtype: str) -> int:
    return int(sum(int(np.prod(s.shape)) *
                   torch_dtype(s.dtype or dtype).itemsize
                   for s in _leaves(specs)))


__all__ = ["ParamSpec", "init_params", "count_params", "tree_bytes",
           "map_specs", "torch_dtype"]
