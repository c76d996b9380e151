"""LM substrate of the port (``repro/models``), dense family: parameters,
layers, the transformer and the zoo interface."""
