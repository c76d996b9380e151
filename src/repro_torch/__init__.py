"""PyTorch/CUDA port of the LIMS learned metric index (``repro``).

The resident exact query path runs on one NVIDIA H100 through four
hand-written CUDA kernels (``repro_torch.kernels``); every module names
the module of the JAX package ``repro`` that it must match.  Nothing
here imports ``jax`` or ``repro``.
"""
