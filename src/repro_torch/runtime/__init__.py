"""The fault-tolerant training loop and elastic resharding (port of
``repro/runtime``)."""
