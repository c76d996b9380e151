"""Kernel layer of the port: four hand-written CUDA kernels for Hopper
(``csrc/``), each beside its plain PyTorch version, and the wrappers in
:mod:`.ops` that the query path calls.  Port of ``repro/kernels``."""
