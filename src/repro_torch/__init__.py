"""PyTorch/CUDA port of the LIMS learned metric index (``repro``).

The resident exact query path, the device index builder and the dense
LM's serving path (prefill and greedy decode) run on one NVIDIA H100
through hand-written CUDA kernels (``repro_torch.kernels``); every
module names the module of the JAX package ``repro`` that it must
match.  Nothing here imports ``jax`` or ``repro``.
"""
