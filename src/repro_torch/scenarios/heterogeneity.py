"""Per-client system heterogeneity: availability, compute latency, dropout.

The FLGo-style ``system_simulator`` layer (and the edge-vehicular AFL
setting of arxiv 2208.01901) composed with the mobility contact windows:
a contact only becomes an upload opportunity when the client is
*available* (a two-state Markov chain), the window that remains after
local compute is positive (effective window = contact ∩ available, minus
compute time), and the upload is not lost to a random dropout.  The
layer is a pure schedule rewrite — (zeta, tau) in, gated (zeta', tau')
out plus per-round aux masks (``unavail`` / ``dropout``, the keys of
``HET_COUNTER_KEYS``) — so the AFL round consumes heterogeneous
scenarios untouched.

Availability chain: per round, an available client stays available with
probability ``rho + (1 - rho) * pi`` and an unavailable one recovers
with ``(1 - rho) * pi`` — stationary distribution P(available) = ``pi``
(= ``availability``) for any persistence ``rho`` (= ``avail_persist``).
Compute latency is Exp(mean ``compute_mean``) per (round, client);
dropout is i.i.d. Bernoulli(``dropout``) over otherwise-successful
uploads.

Both backends share one gating rule (``gate_windows``: plain arithmetic
on numpy arrays or tensors).  The numpy ``apply`` is the oracle and
equals the reference's arrays; ``torch_apply`` is the device-resident
twin (statistical parity with the oracle; exact on shared draws).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.scenarios.torch_kinematics import HETEROGENEITY, stream_generator

__all__ = [
    "HET_COUNTER_KEYS",
    "HeterogeneityModel",
    "gate_windows",
    "reference_apply",
    "torch_apply",
    "torch_draws",
]

#: aux-mask keys the reference's telemetry DeviceTable accumulates
HET_COUNTER_KEYS = ("unavail", "dropout")

# the availability chain's streams (stationary start, transitions), the
# latency's and the dropout coin's
_AVAIL0, _AVAIL, _LATENCY, _DROP = range(4)


def _cast(x, dtype):
    return x.to(dtype) if isinstance(x, torch.Tensor) else x.astype(dtype)


def gate_windows(zeta, tau, avail, latency, drop):
    """The single gating rule both backends apply to fixed draws.

    zeta/tau: (R, N) contact schedule; avail: (R, N) availability states;
    latency: (R, N) compute-latency draws (s); drop: (R, N) dropout coin
    flips.  Returns (zeta', tau', aux) where aux maps ``unavail`` /
    ``dropout`` to 0/1 masks of contacts lost to that cause (counted
    first-cause-wins: an unavailable client's window never reaches the
    dropout coin).  Elementwise on numpy arrays or tensors alike (all of
    one kind), so shared draws give equal results on either.
    """
    ok = zeta > 0
    tau_eff = tau - latency
    fits = tau_eff > 0
    lost_unavail = ok & ~avail
    lost_drop = ok & avail & fits & drop
    good = ok & avail & fits & ~drop
    zeta_out = _cast(good, zeta.dtype)
    tau_out = _cast(tau_eff * good, tau.dtype)
    aux = {
        "unavail": _cast(lost_unavail, tau.dtype),
        "dropout": _cast(lost_drop, tau.dtype),
    }
    return zeta_out, tau_out, aux


@dataclasses.dataclass(frozen=True)
class HeterogeneityModel:
    """Frozen spec of the per-client heterogeneity process."""

    num_devices: int
    availability: float = 1.0  # stationary P(available); 1 disables
    avail_persist: float = 0.0  # state persistence rho in [0, 1)
    compute_mean: float = 0.0  # s, Exp mean compute latency; 0 disables
    dropout: float = 0.0  # P(upload lost despite a fitting window)
    seed: int = 0

    @classmethod
    def from_config(cls, fl, seed: Optional[int] = None):
        return cls(
            num_devices=fl.num_devices,
            availability=fl.het_availability,
            avail_persist=fl.het_avail_persist,
            compute_mean=fl.het_compute_mean,
            dropout=fl.het_dropout,
            seed=(fl.seed if seed is None else seed),
        )

    def enabled(self) -> bool:
        return (self.availability < 1.0 or self.compute_mean > 0.0
                or self.dropout > 0.0)

    # transition probabilities of the availability chain
    @property
    def p_stay_on(self) -> float:
        return self.avail_persist + (1 - self.avail_persist) * self.availability

    @property
    def p_recover(self) -> float:
        return (1 - self.avail_persist) * self.availability

    # -- numpy oracle --------------------------------------------------------

    def sample_states(self, rounds: int, rng=None) -> np.ndarray:
        """(rounds, N) bool availability states (stationary start)."""
        rng = np.random.default_rng(self.seed) if rng is None else rng
        n = self.num_devices
        if self.availability >= 1.0:
            return np.ones((rounds, n), bool)
        avail = np.empty((rounds, n), bool)
        cur = rng.random(n) < self.availability  # stationary init
        for r in range(rounds):  # O(rounds) recurrence on (N,) vectors
            p = np.where(cur, self.p_stay_on, self.p_recover)
            cur = rng.random(n) < p
            avail[r] = cur
        return avail

    def draws(self, rounds: int, rng=None):
        """(avail, latency, drop) fixed draws for ``gate_windows``."""
        rng = np.random.default_rng(self.seed) if rng is None else rng
        n = self.num_devices
        avail = self.sample_states(rounds, rng)
        latency = (rng.exponential(self.compute_mean, (rounds, n))
                   if self.compute_mean > 0 else np.zeros((rounds, n)))
        drop = (rng.random((rounds, n)) < self.dropout
                if self.dropout > 0 else np.zeros((rounds, n), bool))
        return avail, latency.astype(np.float32), drop

    def apply(self, zeta, tau, rng=None):
        """Gate a numpy (zeta, tau) schedule; returns (zeta', tau', aux)."""
        avail, latency, drop = self.draws(len(zeta), rng)
        return gate_windows(np.asarray(zeta), np.asarray(tau, np.float32),
                            avail, latency, drop)


# ---------------------------------------------------------------------------
# torch twin (draws and gating on the schedule's device)
# ---------------------------------------------------------------------------


def torch_draws(model: HeterogeneityModel, rounds: int, device, seed=None):
    """(avail, latency, drop) tensors on ``device``: the draws of
    ``HeterogeneityModel.draws`` from ``seed``'s streams (the model's seed
    by default), one generator per stream."""
    seed = model.seed if seed is None else seed
    shape = (rounds, model.num_devices)
    g = [stream_generator(device, seed, HETEROGENEITY, s) for s in range(4)]
    if model.availability >= 1.0:
        avail = torch.ones(shape, dtype=torch.bool, device=device)
    else:
        cur = torch.rand(shape[1:], generator=g[_AVAIL0],
                         device=device) < model.availability
        u = torch.rand(shape, generator=g[_AVAIL], device=device)
        avail = torch.empty(shape, dtype=torch.bool, device=device)
        for r in range(rounds):  # O(rounds) recurrence on (N,) tensors
            cur = u[r] < torch.where(cur, model.p_stay_on, model.p_recover)
            avail[r] = cur
    if model.compute_mean > 0:
        latency = model.compute_mean * torch.empty(
            shape, device=device).exponential_(generator=g[_LATENCY])
    else:
        latency = torch.zeros(shape, device=device)
    if model.dropout > 0:
        drop = torch.rand(shape, generator=g[_DROP],
                          device=device) < model.dropout
    else:
        drop = torch.zeros(shape, dtype=torch.bool, device=device)
    return avail, latency, drop


def torch_apply(model: HeterogeneityModel, zeta: torch.Tensor,
                tau: torch.Tensor, seed=None):
    """Gate a device-resident (zeta, tau) schedule without leaving its
    device; returns (zeta', tau', aux) tensors."""
    avail, latency, drop = torch_draws(model, zeta.shape[0], zeta.device, seed)
    return gate_windows(zeta, tau.to(torch.float32), avail, latency, drop)


# ---------------------------------------------------------------------------
# Pure-Python reference simulator (tests only)
# ---------------------------------------------------------------------------


def reference_apply(zeta, tau, avail, latency, drop):
    """Per-(round, device) Python-loop restatement of ``gate_windows`` —
    the independent reference the heterogeneity tests compare the
    vectorized gating against (contact ∩ available, minus compute time,
    then the dropout coin)."""
    zeta = np.asarray(zeta)
    tau = np.asarray(tau, np.float32)
    rounds, n = zeta.shape
    z_out = np.zeros_like(zeta)
    t_out = np.zeros_like(tau)
    aux = {k: np.zeros((rounds, n), np.float32) for k in HET_COUNTER_KEYS}
    for r in range(rounds):
        for i in range(n):
            if not zeta[r, i]:
                continue
            if not avail[r, i]:
                aux["unavail"][r, i] = 1.0
                continue
            window = tau[r, i] - latency[r, i]
            if window <= 0:
                continue  # compute ate the whole contact window
            if drop[r, i]:
                aux["dropout"][r, i] = 1.0
                continue
            z_out[r, i] = 1
            t_out[r, i] = window
    return z_out, t_out, aux
