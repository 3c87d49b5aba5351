"""Position-coupled channel gains for scenario traces.

Replaces the seed's i.i.d. ``WirelessChannel.sample_gain`` shortcut: |h|^2
is derived from the *actual* device-MES distance each round through the
existing TR 38.901 path-loss model, with

* lognormal shadowing evolved as a Gudmundson spatially-correlated AR(1)
  process — the correlation between consecutive rounds is
  exp(-displacement / shadow_corr_dist), so slow devices see correlated
  good/bad channels across a contact while vehicular traces decorrelate;
* a persistent LOS/NLOS state redrawn (from the distance-dependent UMi LOS
  probability) only with probability 1 - exp(-displacement / corr_dist),
  i.e. the blockage environment changes when the device actually moves.

numpy, exactly the reference's; ``torch_kinematics.torch_gains_along_trace``
is the device-resident twin.
"""
from __future__ import annotations

import numpy as np

from repro_torch.channel.wireless import WirelessChannel


def gains_along_trace(channel: WirelessChannel, pos: np.ndarray,
                      mes: np.ndarray, shadow_corr_dist: float = 25.0,
                      rng=None, seed: int = 0) -> np.ndarray:
    """|h|^2 per (round, device) from per-round positions.

    pos: (rounds, num_devices, 2); mes: (rounds, 2).  Returns (rounds, N).
    """
    rng = np.random.default_rng(seed) if rng is None else rng
    d = np.linalg.norm(pos - mes[:, None, :], axis=-1)  # (R, n)
    r_total, n = d.shape
    p_los = channel.los_prob(d)

    disp = np.zeros((r_total, n))
    disp[1:] = np.linalg.norm(pos[1:] - pos[:-1], axis=-1)
    rho = np.exp(-disp / max(shadow_corr_dist, 1e-9))

    los = np.empty((r_total, n), bool)
    z = np.empty((r_total, n))  # unit-variance shadowing innovations state
    los[0] = rng.random(n) < p_los[0]
    z[0] = rng.normal(0.0, 1.0, n)
    for r in range(1, r_total):  # O(rounds) recurrence on (n,) vectors
        redraw = rng.random(n) >= rho[r]
        los[r] = np.where(redraw, rng.random(n) < p_los[r], los[r - 1])
        z[r] = rho[r] * z[r - 1] + np.sqrt(1.0 - rho[r] ** 2) * rng.normal(
            0.0, 1.0, n
        )

    sigma = np.where(los, channel.shadow_los_db, channel.shadow_nlos_db)
    pl = channel.pathloss_db(d, los)
    return 10.0 ** (-(pl + sigma * z) / 10.0)
