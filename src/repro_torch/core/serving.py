"""Compatibility shim: ``ServingEngine`` lives in ``repro_torch.serving``.

Port of ``repro/core/serving.py``: the historical import path
``repro_torch.core.serving.ServingEngine`` names the same class object.
"""
from ..serving.engine import ServingEngine

__all__ = ["ServingEngine"]
