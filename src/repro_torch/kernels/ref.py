"""Plain PyTorch versions of the CUDA kernels.

The sparsify pair are twins of ``kernels/ref.py::sparsify_ef_ref`` and
``::sparsify_quantize_ef_ref`` of the reference, for x (rows, n) with one
parameter per row, so one call covers the whole federation as the CUDA
kernels do.  ``decode_attn_plain`` is the twin of ``decode_attn_ref``, and
``ssd_scan_plain`` is the port's ``models/mamba2.py::ssd_chunked`` (the
reference's "ref" route for ``ssd_scan``).  The CPU path runs them
(``ops.py``), and ``chip_smoke.py`` holds the kernels to them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compression.quant import dither_u01


def sparsify_ef_plain(x: torch.Tensor, thresholds: torch.Tensor):
    """x (rows, n), thresholds (rows,) f32 -> (upload, error, count (rows,) f32).

    upload = x where |x| >= t else 0, error = x where |x| < t else 0.
    """
    mask = x.to(torch.float32).abs() >= thresholds[:, None]
    zero = x.new_zeros(())
    count = mask.sum(dim=1, dtype=torch.int32).to(torch.float32)
    return torch.where(mask, x, zero), torch.where(mask, zero, x), count


def sparsify_quantize_ef_plain(x: torch.Tensor, thresholds, steps, levels,
                               seeds, base: int = 0):
    """Fused sparsify + stochastic quantise + error feedback, per row.

    x (rows, n) f32 or bf16; thresholds, steps, levels (rows,) f32; seeds
    (rows,) int32; base: dither counter offset of column 0.  upload =
    clip(floor(x/step + u), -levels, levels) * step where |x| >= t else 0,
    in x's dtype; error = x - upload (from the rounded upload); count (rows,)
    f32.  The dither u = dither_u01(seed, base + column).
    """
    xf = x.to(torch.float32)
    mask = xf.abs() >= thresholds[:, None]
    idx = base + torch.arange(x.shape[1], device=x.device, dtype=torch.int64)
    u = dither_u01(seeds[:, None], idx[None, :])
    step = steps[:, None]
    lv = levels[:, None]
    q = torch.minimum(torch.maximum(torch.floor(xf / step + u), -lv), lv) * step
    upload = torch.where(mask, q, q.new_zeros(())).to(x.dtype)
    error = (xf - upload.to(torch.float32)).to(x.dtype)
    count = mask.sum(dim=1, dtype=torch.int32).to(torch.float32)
    return upload, error, count


def decode_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      length: int) -> torch.Tensor:
    """Single-token GQA decode attention.

    q: (B, H, D); k, v: (B, S, KV, D); length: number of valid entries.
    Returns (B, H, D) in q's dtype; scores and softmax in f32.
    """
    b, s, kv, d = k.shape
    h = q.shape[1]
    qf = q.to(torch.float32).reshape(b, kv, h // kv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32)) / math.sqrt(d)
    valid = torch.arange(s, device=q.device) < length
    scores = torch.where(valid, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


def ssd_scan_plain(x, a, b, c, chunk: int):
    """Chunked Mamba2 SSD scan: (y (B,S,H,P), final state (B,H,P,N)), f32."""
    from repro_torch.models.mamba2 import ssd_chunked  # mamba2 imports ops

    return ssd_chunked(x, a, b, c, chunk)
