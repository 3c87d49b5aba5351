"""Division that rounds like the reference's.

PyTorch computes ``number / tensor`` as ``reciprocal(tensor) * number``,
and on CUDA ``tensor / number`` as ``tensor * (1 / number)``; both can
differ in the last bit from the correctly rounded quotient that the
reference (and the CPU) computes, and a last bit decides a floor (k, a
sample index).  ``div`` turns the number into a 0-dim tensor on the other
operand's device, so the division is a true elementwise one everywhere.
"""
from __future__ import annotations

import torch


def div(a, b) -> torch.Tensor:
    """``a / b`` for tensors and Python numbers, correctly rounded."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)
