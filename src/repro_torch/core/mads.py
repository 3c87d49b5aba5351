"""MADS — mobility-aware dynamic sparsification (paper §V, Algorithm 2).

Per contact, each device solves P3 in closed form:

* Proposition 1: the contact-time constraint is tight,
      k* = tau * A(p*) / (u + log2 s).
* Proposition 2: KKT water-filling power
      p* = clip( 3 V zeta theta B ||x||^2 / (q s (u + log2 s))  -  B N0/|h|^2,
                 0, P ),
      P = min(p_max, (B N0/|h|^2) (2^{s (u+log2 s)/(tau B)} - 1)),
  where the upper branch of P caps k at s.
* Virtual energy queue (eq. 8): q <- max(q + E - E_con/R, 0), E = p * tau.

All functions are elementwise over per-device (N,) tensors, in the
reference's order of operations (f32, constants folded as Python floats).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.fmath import div


def log2s(s: int, u: int) -> float:
    return float(u + math.ceil(math.log2(max(s, 2))))


def rate_bps(p, h2, bandwidth, n0):
    return bandwidth * torch.log2(1.0 + div(p * h2, bandwidth * n0))


def power_cap(tau, h2, s: int, u: int, bandwidth, n0, p_max):
    """P_n^(r) in Proposition 2: cap from (14b) k<=s, and p_max."""
    exponent = div(float(s) * log2s(s, u),
                   torch.clamp(tau, min=1e-9) * bandwidth)
    exponent = torch.clamp(exponent, max=60.0)  # avoid inf for tiny tau
    p_k_cap = div(bandwidth * n0, torch.clamp(h2, min=1e-30)) * (
        torch.pow(2.0, exponent) - 1.0)
    return torch.clamp(p_k_cap, max=p_max)


def mads_power(v_weight, zeta, theta, x_norm2, q, tau, h2, s: int, u: int,
               bandwidth, n0, p_max):
    """Proposition 2 closed form."""
    cap = power_cap(tau, h2, s, u, bandwidth, n0, p_max)
    num = 3.0 * v_weight * zeta * theta * bandwidth * x_norm2
    den = torch.clamp(q, min=1e-12) * float(s) * log2s(s, u)
    p = div(num, den) - div(bandwidth * n0, torch.clamp(h2, min=1e-30))
    return torch.minimum(torch.clamp(p, min=0.0), cap)


def mads_k(p, tau, h2, s: int, u: int, bandwidth, n0):
    """Proposition 1: k* = tau A / (u + log2 s), clipped to [0, s]."""
    a = rate_bps(p, h2, bandwidth, n0)
    return torch.clamp(div(tau * a, log2s(s, u)), 0.0, float(s))


@dataclasses.dataclass(frozen=True)
class MadsController:
    """Per-round (k, p) selection + queue bookkeeping (Algorithm 2)."""

    s: int  # model size
    u: int = 32
    bandwidth: float = 1e6
    noise_w_hz: float = 10 ** (-174.0 / 10.0) / 1000.0
    p_max: float = 0.2
    v_weight: float = 1e-4
    energy_unconstrained: bool = False  # the "Optimal" benchmark

    def select(self, zeta, theta, x_norm2, q, tau, h2):
        """All inputs per-device (N,) tensors. Returns (k, p, energy)."""
        if self.energy_unconstrained:
            p = power_cap(tau, h2, self.s, self.u, self.bandwidth,
                          self.noise_w_hz, self.p_max)
        else:
            p = mads_power(
                self.v_weight, zeta, theta.to(torch.float32), x_norm2, q, tau,
                h2, self.s, self.u, self.bandwidth, self.noise_w_hz, self.p_max,
            )
        k = mads_k(p, tau, h2, self.s, self.u, self.bandwidth, self.noise_w_hz)
        k = k * zeta
        p = p * zeta
        energy = p * tau  # E = p * bits/A = p * tau under Proposition 1
        return k, p, energy

    def queue_update(self, q, energy, energy_budget, rounds: int):
        """Virtual queue evolution, eq. (8)."""
        return torch.clamp(q + energy - div(energy_budget, float(rounds)),
                           min=0.0)
