"""Device and policy decisions for the kernel pipeline.

Port of ``repro/kernels/dispatch.py``.  The reference chooses among
three lanes by backend and ``REPRO_INTERPRET``; the port has no lane
knob: the device a tensor lies on decides.  A CUDA tensor goes to the
hand-written kernel (which raises if it cannot build or launch); a CPU
tensor goes to the kernel's plain PyTorch version.
"""
from __future__ import annotations

import torch

from .. import env


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises ``RuntimeError`` when that is a CUDA device
    and no card is present: the entry points never fall back to the
    CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def fused_plan_enabled(device: torch.device) -> bool:
    """Whether the planner takes the fused pdist_rankeval launch: on
    CUDA, as the reference does on its compiled lanes; on the CPU the
    staged chain is the validated version, as under the reference's
    interpret lane (``dispatch.py:62``)."""
    return torch.device(device).type == "cuda"


def compact_enabled() -> bool:
    """Whether the resident executor gathers certified candidate rows
    into a dense bucket before the filter kernel (``REPRO_COMPACT``)."""
    return env.get("REPRO_COMPACT") == "on"


def rows_dtype() -> str | None:
    """The reduced-precision filter plane's point type for snapshot
    rows (``REPRO_ROWS_DTYPE``): ``"bf16"`` or ``"f16"``, or None when
    the plane is off (the default: f32 everywhere)."""
    v = env.get("REPRO_ROWS_DTYPE")
    return None if v in ("off", "f32") else v


__all__ = ["resolve_device", "fused_plan_enabled", "compact_enabled",
           "rows_dtype"]
