"""Checkpoints (port of ``repro/ckpt``)."""
