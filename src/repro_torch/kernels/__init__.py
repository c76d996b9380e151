"""Kernel layer of the port: hand-written CUDA kernels for Hopper
(``csrc/``), each beside its plain PyTorch version, and the wrappers in
:mod:`.ops` that the query path, the builder and the LM call.  Port of
``repro/kernels``."""
