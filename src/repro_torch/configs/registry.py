"""Architecture registry: ``get_arch(name)`` resolution.

Port of ``repro/configs/registry.py``: the ten configurations of the
reference (dense, moe, ssm, hybrid, vlm, encdec) and ``cells()``, the
(arch, shape) grid with ``long_500k`` skipped for full attention.
"""
from .base import SHAPES, ModelConfig, ShapeCell, long_context_ok
from .chatglm3_6b import CONFIG as chatglm3_6b
from .deepseek_7b import CONFIG as deepseek_7b
from .internlm2_20b import CONFIG as internlm2_20b
from .kimi_k2_1t import CONFIG as kimi_k2_1t
from .llama3_8b import CONFIG as llama3_8b
from .llava_next_34b import CONFIG as llava_next_34b
from .mamba2_780m import CONFIG as mamba2_780m
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .seamless_m4t_large import CONFIG as seamless_m4t_large
from .zamba2_2p7b import CONFIG as zamba2_2p7b

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    deepseek_7b, chatglm3_6b, internlm2_20b, llama3_8b, zamba2_2p7b,
    kimi_k2_1t, mixtral_8x7b, mamba2_780m, llava_next_34b,
    seamless_m4t_large,
]}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) cells; skips long_500k for pure full attention."""
    out = []
    for name, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            skip = sname == "long_500k" and not long_context_ok(cfg)
            if skip and not include_skipped:
                continue
            out.append((name, sname, skip))
    return out


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeCell", "get_arch",
           "cells", "long_context_ok"]
