"""TR 38.901 UMi-Street-Canyon wireless channel (paper §VI, Table I).

PL_LOS  = 32.4 + 21.0 log10(d) + 20 log10(f_GHz)   [dB]
PL_NLOS = 32.4 + 31.9 log10(d) + 20 log10(f_GHz)   [dB]
Shadowing: lognormal, sigma = 4 dB (LOS) / 8.2 dB (NLOS).
LOS probability (UMi): P = 1 for d <= 18 m, else 18/d + exp(-d/36)(1-18/d).

Channel gain |h|^2 = 10^(-PL_total/10); rate = B log2(1 + p|h|^2/(B N0));
energy for a payload = p * bits / rate.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def shannon_rate(p, h2, bandwidth: float, noise_dbm_hz: float = -174.0):
    """bits/s for transmit power p (W) and channel gain |h|^2."""
    n0 = 10 ** (noise_dbm_hz / 10.0) / 1000.0  # W/Hz
    return bandwidth * np.log2(1.0 + p * h2 / (bandwidth * n0))


def energy_joules(p, bits, rate):
    rate = np.maximum(rate, 1e-9)
    return p * bits / rate


@dataclasses.dataclass
class WirelessChannel:
    bandwidth: float = 1e6
    carrier_ghz: float = 3.5
    noise_dbm_hz: float = -174.0
    shadow_los_db: float = 4.0
    shadow_nlos_db: float = 8.2
    min_dist: float = 10.0
    max_dist: float = 100.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def noise_w_hz(self) -> float:
        return 10 ** (self.noise_dbm_hz / 10.0) / 1000.0

    def los_prob(self, d):
        d = np.asarray(d, np.float64)
        p = 18.0 / np.maximum(d, 1e-9) + np.exp(-d / 36.0) * (1 - 18.0 / np.maximum(d, 1e-9))
        return np.where(d <= 18.0, 1.0, np.minimum(p, 1.0))

    def pathloss_db(self, d, los):
        d = np.maximum(np.asarray(d, np.float64), 1.0)
        pl_los = 32.4 + 21.0 * np.log10(d) + 20.0 * np.log10(self.carrier_ghz)
        pl_nlos = 32.4 + 31.9 * np.log10(d) + 20.0 * np.log10(self.carrier_ghz)
        return np.where(los, pl_los, pl_nlos)

    def sample_gain(self, size) -> np.ndarray:
        """Sample |h|^2 for devices uniformly placed within comm range."""
        d = self._rng.uniform(self.min_dist, self.max_dist, size)
        los = self._rng.random(size) < self.los_prob(d)
        pl = self.pathloss_db(d, los)
        sigma = np.where(los, self.shadow_los_db, self.shadow_nlos_db)
        shadow = self._rng.normal(0.0, sigma)
        return 10 ** (-(pl + shadow) / 10.0)

    def rate(self, p, h2):
        return shannon_rate(p, h2, self.bandwidth, self.noise_dbm_hz)

    def mean_rate(self, p: float, samples: int = 4096) -> float:
        """Monte-Carlo average rate at power p (used as A_n in Lemmas 2-3)."""
        h2 = self.sample_gain(samples)
        return float(np.mean(self.rate(p, h2)))
