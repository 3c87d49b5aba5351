"""Dispatch for the kernels, by the device of the tensor.

A CUDA tensor goes to the hand-written kernel (``sparsify_ef.py``,
``decode_attn.py``, ``ssd_scan.py``), which launches or raises; a CPU
tensor goes to the kernel's plain version (``ref.py``).  There is no
fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels import ref
from repro_torch.kernels import sparsify_ef as K
from repro_torch.kernels import ssd_scan as SSD


def _device(x) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel path for device {x.device}")
    return x.device.type


def refuse_grad(name: str, *tensors) -> None:
    """Raise if any of ``tensors`` requires a gradient (also inside
    ``torch.func.grad``): the kernel would return a result with none."""
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the {name} kernel has no backward (the reference has no "
            "backward kernel for it either): differentiate its plain "
            "formula instead")


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


def sparsify_quantize_ef_segmented(x, thresholds, steps, levels, seeds,
                                   offsets):
    """The same with one threshold, step and levels per (row, leaf): x
    (N, s); thresholds, steps, levels (N, L); offsets the L + 1 leaf
    boundaries -> (upload, error, count (N, L) f32)."""
    if _device(x) == "cuda":
        return K.sparsify_quantize_ef_segmented_cuda(
            x, thresholds, steps, levels, seeds, offsets)
    return ref.sparsify_quantize_ef_segmented_plain(
        x, thresholds, steps, levels, seeds, offsets)


def sparsify_quantize_ef_blocks(x, thresholds, steps, levels, seeds,
                                offsets, counters):
    """The segmented op on a rank's blocks: ``counters`` each leaf's (g0,
    R, G, owned) counter map -> (upload, error, count (N, L) int64, 0
    where a leaf is not owned)."""
    if _device(x) == "cuda":
        return K.sparsify_quantize_ef_blocks_cuda(
            x, thresholds, steps, levels, seeds, offsets, counters)
    return ref.sparsify_quantize_ef_blocks_plain(
        x, thresholds, steps, levels, seeds, offsets, counters)


def decode_attn(q, k, v, length: int):
    """One query token per sequence against a KV cache: q (B, H, D), k, v
    (B, S, KV, D), ``length`` valid positions -> (B, H, D) in q's dtype."""
    if _device(q) == "cuda":
        return DA.decode_attn_cuda(q, k, v, length)
    return ref.decode_attn_plain(q, k, v, length)


def decode_attn_partials(q, k, v, length: int):
    """``decode_attn``'s partials, all f32: (m (B, H), l (B, H), acc (B,
    H, D)); merged by ``sharding/collectives.py::merge_partials``."""
    if _device(q) == "cuda":
        return DA.decode_attn_partials_cuda(q, k, v, length)
    return ref.decode_attn_partials_plain(q, k, v, length)


def ssd_scan(x, a, b, c, chunk: int):
    """Chunked SSD scan -> (y (B,S,H,P), final state (B,H,P,N)), f32.

    The inputs are taken as f32, as the reference kernel reads them (b and
    c come in the activation dtype).  The kernel has no backward: CUDA
    inputs that require a gradient raise (training differentiates
    ``models/mamba2.py::ssd_chunked``)."""
    x, a, b, c = (t.to(torch.float32) for t in (x, a, b, c))
    if _device(x) == "cuda":
        refuse_grad("ssd_scan", x, a, b, c)
        return SSD.ssd_scan_cuda(x, a, b, c, chunk)
    return ref.ssd_scan_plain(x, a, b, c, chunk)
