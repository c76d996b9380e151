"""Model configurations of the port (``repro/configs``): the schema and
the ten architectures."""
