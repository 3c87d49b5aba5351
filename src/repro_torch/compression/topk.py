"""Top-k codecs: Proposition 1 spending, plus the fixed-(k, b) baseline.

``TopKCompressor`` buys ``k = floor(budget / (u + log2 s))`` coordinates
at ``u``-bit values (raw floats at u=32, stochastically quantised below).
``FixedKbCompressor`` targets a fixed keep-fraction and bit-width but clips
k to what the contact window can carry.  Both delegate thresholding, bit
accounting and the budget gate to ``base.Compressor.spend``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compression import quant as Q
from repro_torch.compression.base import Compressor
from repro_torch.utils.device import constant
from repro_torch.utils.fmath import div


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Sparsify-only spend: ``k = floor(budget / (u + log2 s))``."""

    u: int = 32  # value bit-width on the wire

    @property
    def quantize(self) -> bool:
        return self.u < 32

    def compress(self, x, budget_bits, error, seeds, layout, placement=None):
        xt = x + error
        overhead = Q.SCALE_BITS if self.quantize else 0
        k_target = torch.floor(torch.clamp(
            div(budget_bits - overhead, self.u + self.index_bits),
            0.0, float(self.s)))
        return self.spend(xt, layout, k_target, self.u, budget_bits, seeds,
                          quantize=self.quantize, placement=placement)


@dataclasses.dataclass(frozen=True)
class FixedKbCompressor(Compressor):
    """Fixed (keep-fraction, bit-width) targets, clipped to the budget."""

    k_frac: float = 0.01
    b: int = 8

    @property
    def quantize(self) -> bool:
        return self.b < 32

    def compress(self, x, budget_bits, error, seeds, layout, placement=None):
        xt = x + error
        overhead = Q.SCALE_BITS if self.quantize else 0
        k_cap = torch.floor(torch.clamp(
            div(budget_bits - overhead, self.b + self.index_bits),
            0.0, float(self.s)))
        k_fixed = torch.floor(constant(self.k_frac * self.s,
                                       device=k_cap.device))
        k_target = torch.minimum(k_fixed, k_cap)
        return self.spend(xt, layout, k_target, self.b, budget_bits, seeds,
                          quantize=self.quantize, placement=placement)
