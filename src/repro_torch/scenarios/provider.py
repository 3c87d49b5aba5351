"""ScenarioProvider — streaming (zeta, tau, h2) round inputs for AFL.

The port of ``repro/scenarios/provider.py`` for the paper's exponential
renewal abstraction (``from_config`` with ``mobility_model="exponential"``)
and precomputed schedules (``from_arrays``).  numpy throughout, so the
schedules equal the reference's for the same seeds.  The trace mobility
models, the device-resident backend and the heterogeneity layer raise
``NotImplementedError`` until their slice lands (ROADMAP.md, queue 1).

    provider = ScenarioProvider.from_config(fl, rounds)
    for zeta_r, tau_r, h2_r in provider: ...   # or provider.round(r)
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.channel.wireless import WirelessChannel
from repro_torch.mobility.contact import ContactProcess

Schedule = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: the trace scenario "
        "models and heterogeneity)")


class ScenarioProvider:
    """Streams per-round (zeta, tau, h2); precomputes the schedule lazily."""

    def __init__(self, rounds: int, num_devices: int,
                 build: Optional[Callable[[], Schedule]] = None,
                 schedule: Optional[Schedule] = None):
        self.rounds = rounds
        self.num_devices = num_devices
        self._build = build
        self._schedule = schedule

    @classmethod
    def from_config(cls, fl, rounds: Optional[int] = None,
                    seed: Optional[int] = None) -> "ScenarioProvider":
        """The paper's exponential renewal abstraction with i.i.d. gains."""
        rounds = fl.rounds if rounds is None else rounds
        seed = fl.seed if seed is None else seed
        if fl.mobility_model != "exponential":
            raise _not_ported(f"mobility model {fl.mobility_model!r}")
        if fl.scenario_backend != "numpy":
            raise _not_ported(f"scenario backend {fl.scenario_backend!r}")
        if (fl.het_availability < 1.0 or fl.het_compute_mean > 0.0
                or fl.het_dropout > 0.0):
            raise _not_ported("the heterogeneity layer")
        chan = WirelessChannel(
            bandwidth=fl.bandwidth, carrier_ghz=fl.carrier_ghz,
            noise_dbm_hz=fl.noise_dbm_hz, seed=seed + 1,
        )

        def build() -> Schedule:
            if fl.speed > 0:
                proc = ContactProcess.from_speed(
                    fl.num_devices, fl.speed, fl.contact_const,
                    fl.intercontact_const, fl.round_duration, seed,
                )
            else:
                proc = ContactProcess(
                    fl.num_devices, fl.mean_contact, fl.mean_intercontact,
                    fl.round_duration, seed,
                )
            zeta, tau = proc.sample_rounds(rounds)
            h2 = chan.sample_gain((rounds, fl.num_devices))
            return zeta, tau, h2.astype(np.float32)

        return cls(rounds, fl.num_devices, build=build)

    @classmethod
    def from_arrays(cls, zeta: np.ndarray, tau: np.ndarray,
                    h2: Optional[np.ndarray] = None,
                    channel: Optional[WirelessChannel] = None,
                    seed: int = 0) -> "ScenarioProvider":
        """Wrap a precomputed (zeta, tau) schedule; without h2, gains are
        sampled i.i.d. from ``channel`` (or a default ``WirelessChannel``)."""
        zeta = np.asarray(zeta)
        rounds, n = zeta.shape
        if h2 is None:
            channel = channel or WirelessChannel(seed=seed)
            h2 = channel.sample_gain((rounds, n))
        return cls(rounds, n, schedule=(
            zeta, np.asarray(tau, np.float32), np.asarray(h2, np.float32)
        ))

    def schedule(self) -> Schedule:
        """The full (zeta, tau, h2) arrays, each (rounds, num_devices)."""
        if self._schedule is None:
            self._schedule = self._build()
        return self._schedule

    def round(self, r: int) -> Schedule:
        """(zeta_r, tau_r, h2_r) for round r, each (num_devices,)."""
        zeta, tau, h2 = self.schedule()
        return zeta[r], tau[r], h2[r]

    def __iter__(self) -> Iterator[Schedule]:
        zeta, tau, h2 = self.schedule()
        for r in range(self.rounds):
            yield zeta[r], tau[r], h2[r]

    def __len__(self) -> int:
        return self.rounds
