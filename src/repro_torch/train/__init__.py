"""Training on one device (port of ``repro/train``): optimizers,
int8 gradient compression and the train step."""
