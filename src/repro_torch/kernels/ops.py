"""Dispatch for the sparsify kernels, by the device of the tensor.

A CUDA tensor goes to the hand-written kernel (``sparsify_ef.py``), which
launches or raises; a CPU tensor goes to the kernel's plain version
(``ref.py``).  There is no fallback between the two.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels import sparsify_ef as K


def _device(x) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no sparsify path for device {x.device}")
    return x.device.type


def sparsify_ef(x, thresholds):
    """x (N, s), thresholds (N,) f32 -> (upload, error, count (N,) f32)."""
    if _device(x) == "cuda":
        return K.sparsify_ef_cuda(x, thresholds)
    return ref.sparsify_ef_plain(x, thresholds)


def sparsify_quantize_ef(x, thresholds, steps, levels, seeds, base: int = 0):
    """Fused sparsify + stochastic quantise + EF over (N, s) rows."""
    if _device(x) == "cuda":
        return K.sparsify_quantize_ef_cuda(x, thresholds, steps, levels, seeds,
                                           base)
    return ref.sparsify_quantize_ef_plain(x, thresholds, steps, levels, seeds,
                                          base)
