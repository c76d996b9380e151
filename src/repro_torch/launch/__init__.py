"""Launch (port of ``repro/launch``): the production and host meshes and
the dry-run over every (arch × shape) cell."""
