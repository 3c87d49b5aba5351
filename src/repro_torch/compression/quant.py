"""Stochastic uniform quantisation primitives (QSGD-style dithered rounding).

Values are scaled by one per-message step ``delta = amax / levels`` and
stochastically rounded to ``q = clip(floor(v / delta + u), -levels,
levels)`` with dither ``u ~ U[0, 1)``; ``levels = 2^(b-1) - 1`` so a signed
value fits in ``b`` bits, and the fp32 scale is counted once per message
(``SCALE_BITS``).

The dither is counter-based: ``dither_u01(seed, index)`` hashes the (seed,
global element index) pair with lowbias32, so the plain version here and
the CUDA kernel draw the same dither for the same element.  The hash is
uint32 arithmetic; PyTorch's CPU build has no ``>>`` for ``torch.uint32``,
so it runs in int64 masked to 32 bits, with each multiply split so that
no product leaves the int64 range.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# one fp32 scale per compressed message, counted against the bit budget
SCALE_BITS = 32
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u32(x):
    if isinstance(x, int):
        return x & _M32
    return torch.as_tensor(x).to(torch.int64) & _M32


def lowbias32(seed, idx) -> torch.Tensor:
    """The lowbias32 hash of ``idx ^ seed``, as int64 in [0, 2^32).

    ``seed`` and ``idx`` are integer tensors or Python ints (at least one
    a tensor; broadcastable); both are taken mod 2^32, as the reference's
    int32 -> uint32 casts do.
    """
    h = _u32(idx) ^ _u32(seed)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def dither_u01(seed, idx) -> torch.Tensor:
    """U[0,1) dither for global element indices ``idx`` under ``seed``
    (integer tensors, broadcastable): ``lowbias32(seed, idx) / 2^32``."""
    return lowbias32(seed, idx).to(torch.float32) * (1.0 / 4294967296.0)


def quant_levels(b) -> torch.Tensor:
    """Signed integer grid half-width for a ``b``-bit value, floored at 1."""
    b = torch.as_tensor(b, dtype=torch.float32)
    return torch.clamp(torch.pow(2.0, b - 1.0) - 1.0, min=1.0)


def quant_step(amax, levels) -> torch.Tensor:
    """Quantisation step ``delta`` mapping [-amax, amax] onto the grid."""
    return torch.clamp(amax, min=1e-12) / levels


def stochastic_round(x, step, levels, seed, base: int = 0) -> torch.Tensor:
    """Dequantised stochastic quantisation of ``x`` (any shape).

    ``q * step`` with ``q = clip(floor(x/step + u), -levels, levels)`` and
    ``u = dither_u01(seed, base + flat_index)``.
    """
    xf = x.to(torch.float32)
    idx = base + torch.arange(xf.numel(), device=xf.device).reshape(xf.shape)
    u = dither_u01(torch.as_tensor(seed, device=xf.device), idx)
    step = torch.as_tensor(step, dtype=torch.float32, device=xf.device)
    levels = torch.as_tensor(levels, dtype=torch.float32, device=xf.device)
    q = torch.minimum(torch.maximum(torch.floor(xf / step + u), -levels), levels)
    return q * step


def draw_seeds(gen: torch.Generator, n: int, device=None) -> torch.Tensor:
    """(n,) int32 dither seeds in [0, 2^31 - 1) from ``gen`` (one per device)."""
    seeds = torch.randint(0, 2**31 - 1, (n,), generator=gen, dtype=torch.int32)
    return seeds.to(device) if device is not None else seeds


def tree_amax(flat: torch.Tensor, group=None) -> torch.Tensor:
    """Max |value| over the last axis of a flat (..., s) message (exact).

    The larger of |max| and |min|, each taken in the message's dtype (a
    cast to f32 is exact and keeps order), so no (..., s) temporary is
    made.  ``group``: a process group over which the message's columns are
    partitioned; the rank maxima are MAX-reduced over it (exact under any
    split), so every rank derives the same step."""
    amax = torch.maximum(flat.amax(dim=-1).to(torch.float32).abs(),
                         flat.amin(dim=-1).to(torch.float32).abs())
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax
