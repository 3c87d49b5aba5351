"""Joint sparsify-then-quantize codec: the (k, b) split in closed form.

The budget ``B = tau * A(p)`` buys ``k`` coordinates at ``b``-bit values
for ``k (b + lambda) + 32`` bits (lambda = ceil(log2 s), 32 for the fp32
scale).  Top-k keeps at least a ``kappa(b) = min(1, (B - 32) / (s (b +
lambda)))`` fraction of the signal energy and b-bit stochastic rounding
leaves a noise fraction ``eps(b) = 4^{-(b-1)} / 3`` of it, so the width is

    b* = argmax_b  kappa(b) * (1 - eps(b))

over a static integer grid, and ``k* = floor((B - 32) / (b* + lambda))``.
The derivation is in the reference's ``compression/joint.py``.
``per_layer=True`` solves one (k_l, b_l) pair per leaf instead
(``perlayer.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compression import quant as Q
from repro_torch.compression.base import Compressor
from repro_torch.compression.perlayer import compress_per_layer
from repro_torch.utils.device import constant
from repro_torch.utils.fmath import div


def solve_kb(budget_bits, s: int, index_bits: int, b_grid):
    """Closed-form (k, b) split per device: budget_bits (N,) -> (k, b) (N,)."""
    bg = constant(b_grid, device=budget_bits.device)
    avail = torch.clamp(budget_bits - Q.SCALE_BITS, min=0.0)
    kappa = torch.clamp(avail[..., None] / (float(s) * (bg + index_bits)),
                        0.0, 1.0)
    eps = div(torch.pow(4.0, -(bg - 1.0)), 3.0)
    b = bg[torch.argmax(kappa * (1.0 - eps), dim=-1)]
    k = torch.floor(torch.clamp(avail / (b + index_bits), 0.0, float(s)))
    return k, b


@dataclasses.dataclass(frozen=True)
class JointCompressor(Compressor):
    """MADS-joint: per-round (k*, b*) from the contact budget; with
    ``per_layer=True``, per-leaf (k_l, b_l) pairs by greedy water-filling
    against the same budget (``perlayer.solve_kb_per_leaf``)."""

    b_grid: tuple = tuple(range(2, 17))
    per_layer: bool = False
    quantize = True

    def model_collectives(self, clients: int, leaves: int) -> list:
        """Per-layer (``compress_per_layer``): the (N, L) energies'
        all-reduce, one gather of every leaf's sample part (exact: its
        magnitudes), the (N, L) amax's MAX and the counts' all-reduce."""
        if not self.per_layer:
            return super().model_collectives(clients, leaves)
        nl = clients * leaves
        gathered = clients * 4 * (self.s if self.method == "exact"
                                  else self.sample)
        return [("all-reduce", nl * 4), ("all-gather", gathered),
                ("all-reduce", nl * 4), ("all-reduce", nl * 8)]

    def compress(self, x, budget_bits, error, seeds, layout, placement=None):
        xt = x + error
        if self.per_layer:
            if self.group is not None:
                raise NotImplementedError(
                    "per_layer budgets over a partitioned row (group=) are "
                    "not supported, as in the reference")
            return compress_per_layer(self, xt, layout, budget_bits, seeds,
                                      placement)
        k_target, b = solve_kb(budget_bits, self.s, self.index_bits,
                               self.b_grid)
        return self.spend(xt, layout, k_target, b, budget_bits, seeds,
                          quantize=True, placement=placement)
