"""Trace -> AFL round inputs: contact extraction and (zeta, tau) schedules.

Bridges the kinematics core to Algorithm 1: runs of in-range samples become
contact intervals, intervals become per-round (zeta, tau) via the same
first-writer-wins mapping the exponential model uses
(``repro_torch.mobility.contact.intervals_to_rounds``), and per-round channel
gains come from the actual device-MES distances
(``repro_torch.scenarios.channel.gains_along_trace``).  numpy, exactly
the reference's; ``torch_contacts.py`` is the device-resident twin.
"""
from __future__ import annotations

import numpy as np

from repro_torch.mobility.contact import intervals_to_rounds
from repro_torch.scenarios.channel import gains_along_trace
from repro_torch.scenarios.kinematics import Trace


def contact_intervals(in_range: np.ndarray, dt: float):
    """Extract contact intervals from a (steps, num_devices) bool trace.

    Returns flat arrays (dev, start, dur), ordered by device then time —
    the order ``intervals_to_rounds`` expects.  Contacts still open at the
    end of the trace are censored at the observation window.
    """
    steps, n = in_range.shape
    padded = np.zeros((n, steps + 2), bool)
    padded[:, 1:-1] = in_range.T
    d = np.diff(padded.astype(np.int8), axis=1)
    starts = np.argwhere(d == 1)  # row-major -> sorted by (device, time)
    ends = np.argwhere(d == -1)  # same count per device, aligned pairwise
    dev = starts[:, 0]
    start = starts[:, 1] * dt
    dur = (ends[:, 1] - starts[:, 1]) * dt
    return dev, start, dur


def rounds_from_trace(trace: Trace, comm_range: float, rounds: int,
                      round_duration: float, channel=None,
                      shadow_corr_dist: float = 25.0, rng=None):
    """(zeta, tau, h2) for ``rounds`` rounds of duration ``round_duration``.

    zeta/tau follow the exponential model's semantics (full contact duration
    at the contact-start round, remaining duration in continuation rounds).
    h2 is position-coupled when a ``WirelessChannel`` is passed: path loss +
    correlated shadowing at the device-MES distance sampled at each round
    start (None otherwise).
    """
    n = trace.num_devices
    dev, start, dur = contact_intervals(trace.in_range(comm_range), trace.dt)
    zeta, tau = intervals_to_rounds(dev, start, dur, n, rounds, round_duration)

    h2 = None
    if channel is not None:
        # per-round sample index (NOT a constant integer stride: that drifts
        # linearly whenever round_duration is not a multiple of dt)
        ridx = np.minimum(
            (np.arange(rounds) * (round_duration / trace.dt)).astype(np.int64),
            trace.steps - 1,
        )
        h2 = gains_along_trace(
            channel, trace.pos[ridx], trace.mes[ridx],
            shadow_corr_dist=shadow_corr_dist, rng=rng,
        )
    return zeta, tau, h2
