"""QSGD-style quantise-everything codec: bit-width from the budget.

No sparsification and so no per-coordinate index overhead: all ``s``
coordinates ship at ``b = floor((budget - 32) / s)`` bits each (the 32
pays the fp32 scale), stochastically rounded onto the ``2^(b-1)-1``-level
grid (``compression.quant``).  When the contact window cannot afford
``b_min`` bits per coordinate the device sends nothing: dense
quantisation degrades ungracefully under short contacts, the regime where
the joint (k, b) codec wins.  ``b`` is a per-device tensor, so one call
serves every contact duration of the federation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compression import quant as Q
from repro_torch.compression.base import Compressor, placed_amax
from repro_torch.utils.fmath import div


@dataclasses.dataclass(frozen=True)
class QSGDCompressor(Compressor):
    b_min: int = 2
    b_max: int = 16
    quantize = True

    def model_collectives(self, clients: int, leaves: int) -> list:
        """The amax's MAX alone: the threshold is 0 and k is s."""
        return [("all-reduce", clients * 4)]

    def compress(self, x, budget_bits, error, seeds, layout, placement=None):
        self.check_placement(placement)
        xt = x + error
        b = torch.floor(div(budget_bits - Q.SCALE_BITS, float(self.s)))
        b = torch.clamp(b, 0.0, float(self.b_max))
        send = (b >= self.b_min).to(torch.float32)
        b = b * send
        levels = Q.quant_levels(b)
        amax = (Q.tree_amax(xt, group=self.group) if placement is None
                else placed_amax(xt, placement))
        step = Q.quant_step(amax, levels)
        # threshold 0 keeps every coordinate (the kernels' mask is >=);
        # send = 0 withholds the round; k is s whatever the count
        payload, error, _ = self.masked_payload(
            xt, torch.zeros_like(step), quantize=True, step=step,
            levels=levels, seeds=seeds, placement=placement)
        payload.mul_(send[:, None].to(payload.dtype))
        torch.where(send[:, None] > 0, error, xt, out=error)
        if not self.error_feedback:
            error = torch.zeros_like(error)
        # bits <= budget by construction: b = floor((budget - 32) / s)
        bits = send * (float(self.s) * b + Q.SCALE_BITS)
        stats = {"k": send * float(self.s), "bits": bits, "b": b,
                 "step": step}
        return payload, error, stats
