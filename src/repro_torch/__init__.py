"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout and parameter trees, imports only torch, numpy and the stdlib, and
runs the sparsify + error-feedback pass through hand-written CUDA kernels
(``kernels/``).
"""
