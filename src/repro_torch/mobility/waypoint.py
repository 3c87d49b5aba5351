"""Random-waypoint mobility simulator (paper §VI-A-3, Fig. 4).

MES + N devices move in a square area; a device is "in contact" while
within the transmission range of the MES.  Used to validate the inverse
relationship between speed and contact / inter-contact times
(c = C/v, lambda = L/v) that Corollary 1 builds on.  numpy, exactly the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RandomWaypoint:
    num_devices: int = 20
    area: float = 1000.0  # m (square side)
    comm_range: float = 100.0  # m
    mean_speed: float = 10.0  # m/s
    pause_max: float = 5.0  # s
    dt: float = 1.0  # s
    seed: int = 0

    def simulate(self, duration: float):
        """Returns in_range: (steps, num_devices) bool (device-MES contact)."""
        rng = np.random.default_rng(self.seed)
        steps = int(duration / self.dt)
        n = self.num_devices + 1  # entity 0 is the MES
        pos = rng.uniform(0, self.area, (n, 2))
        dest = rng.uniform(0, self.area, (n, 2))
        speed = rng.uniform(0.5 * self.mean_speed, 1.5 * self.mean_speed, n)
        pause = np.zeros(n)
        out = np.zeros((steps, self.num_devices), bool)
        for t in range(steps):
            vec = dest - pos
            dist = np.linalg.norm(vec, axis=1)
            arrived = dist < speed * self.dt
            moving = (pause <= 0) & ~arrived
            step_vec = np.zeros_like(pos)
            nz = dist > 1e-9
            step_vec[nz] = vec[nz] / dist[nz, None]
            pos[moving] += step_vec[moving] * (speed[moving] * self.dt)[:, None]
            # arrivals: pause then pick a new waypoint
            newly = arrived & (pause <= 0)
            pause[newly] = rng.uniform(0, self.pause_max, newly.sum())
            pos[newly] = dest[newly]
            repick = (pause > 0)
            pause[repick] -= self.dt
            done_pausing = repick & (pause <= 0)
            if done_pausing.any():
                dest[done_pausing] = rng.uniform(0, self.area, (done_pausing.sum(), 2))
                speed[done_pausing] = rng.uniform(
                    0.5 * self.mean_speed, 1.5 * self.mean_speed, done_pausing.sum()
                )
            d2mes = np.linalg.norm(pos[1:] - pos[0], axis=1)
            out[t] = d2mes < self.comm_range
        return out


def measure_contact_stats(in_range: np.ndarray, dt: float = 1.0,
                          drop_truncated: bool = True):
    """Mean contact & inter-contact durations from an in-range trace.

    The first and last segments of each device's trace are censored by the
    observation window (their true start/end falls outside it), so counting
    them biases both means low.  They are dropped by default; pass
    ``drop_truncated=False`` for the seed's biased estimator.
    """
    contacts, gaps = [], []
    for n in range(in_range.shape[1]):
        x = in_range[:, n].astype(np.int8)
        changes = np.flatnonzero(np.diff(x))
        bounds = np.concatenate([[0], changes + 1, [len(x)]])
        for i in range(len(bounds) - 1):
            if drop_truncated and (i == 0 or i == len(bounds) - 2):
                continue  # window-truncated: duration is a lower bound only
            seg = x[bounds[i]]
            length = (bounds[i + 1] - bounds[i]) * dt
            (contacts if seg else gaps).append(length)
    mc = float(np.mean(contacts)) if contacts else 0.0
    mg = float(np.mean(gaps)) if gaps else float("inf")
    return mc, mg
