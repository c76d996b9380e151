"""Architecture registry: ``get_arch(name)`` resolution.

Port of ``repro/configs/registry.py`` for the dense family: the four
``dense`` configurations of the reference.  The reference's six other
architectures (moe, ssm, hybrid, vlm, encdec) are not ported yet
(ROADMAP A14), and asking for one raises ``KeyError`` saying so.
"""
from .base import SHAPES, ModelConfig, ShapeCell
from .chatglm3_6b import CONFIG as chatglm3_6b
from .deepseek_7b import CONFIG as deepseek_7b
from .internlm2_20b import CONFIG as internlm2_20b
from .llama3_8b import CONFIG as llama3_8b

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    deepseek_7b, chatglm3_6b, internlm2_20b, llama3_8b,
]}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is unknown or not ported yet (only "
                       f"the dense family is, ROADMAP A14); ported: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeCell", "get_arch"]
