"""Vectorized mobility kinematics — the scenario engine's motion core.

Four models behind one ``MobilityModel`` protocol, all NumPy-batched over
devices (no per-device Python loops; the only remaining loops are either
over *legs* via interpolation — O(devices) searchsorted calls — or a cheap
O(steps) AR(1) recurrence on (N, 2) vectors):

* ``RandomWaypointModel``  — leg-based vectorized port of
  ``repro_torch.mobility.waypoint.RandomWaypoint``: waypoint legs are sampled up
  front for every device, then positions at all query times come from a
  piecewise-linear interpolation (searchsorted over leg start times).
* ``GaussMarkovModel``     — AR(1) velocity process with reflecting walls.
  Parametrised by a velocity *decorrelation distance* so the trajectory
  statistics are an exact time-rescaling in mean speed (the paper's
  c = C/v, lambda = L/v inverse-speed law holds by construction).
* ``ManhattanGridModel``   — vehicular grid mobility: devices travel along
  streets of a ``block``-spaced lattice, turning at intersections via an
  i.i.d. turn sequence (straight / left / right), folded back into the
  area by reflection (lattice-preserving since block | area).
* ``HotspotClusterModel``  — devices anchored to hotspot centres, wandering
  around them by an Ornstein-Uhlenbeck excursion whose time constant is
  ``hotspot_radius / mean_speed`` (static scenario at mean_speed = 0).

Every model returns a ``Trace`` (positions for all steps + the MES
position), from which ``scenarios/contacts.py`` derives per-round
``(zeta, tau)`` and ``scenarios/channel.py`` derives position-coupled ``h2``.
numpy throughout, carried over from the reference: the same seeds give
equal arrays.  ``torch_kinematics.py`` is the device-resident twin.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np


@dataclasses.dataclass
class Trace:
    """Device + MES positions sampled on a uniform time grid."""

    pos: np.ndarray  # (steps, num_devices, 2) metres
    mes: np.ndarray  # (steps, 2) MES position
    dt: float  # seconds between samples

    @property
    def steps(self) -> int:
        return self.pos.shape[0]

    @property
    def num_devices(self) -> int:
        return self.pos.shape[1]

    def distances(self) -> np.ndarray:
        """(steps, num_devices) device-MES distance."""
        return np.linalg.norm(self.pos - self.mes[:, None, :], axis=-1)

    def in_range(self, comm_range: float) -> np.ndarray:
        """(steps, num_devices) bool contact indicator."""
        return self.distances() < comm_range


@runtime_checkable
class MobilityModel(Protocol):
    """Anything that can simulate device motion for a duration."""

    num_devices: int
    area: float
    mean_speed: float

    def trace(self, duration: float, dt: float = 1.0) -> Trace: ...


def _reflect(x: np.ndarray, hi: float) -> np.ndarray:
    """Fold unbounded coordinates into [0, hi] by reflection at the walls."""
    y = np.mod(x, 2.0 * hi)
    return np.where(y > hi, 2.0 * hi - y, y)


def _static_mes(steps: int, area: float) -> np.ndarray:
    return np.full((steps, 2), 0.5 * area)


def _interp_legs(tq, leg_start, travel, nodes):
    """Piecewise-linear positions for ALL entities' waypoint legs at once.

    leg_start (n, m): departure time of each leg; travel (n, m): moving time
    of each leg (arrival at leg_start + travel, then idle until the next
    leg); nodes (n, m+1, 2): leg endpoints.  Returns (len(tq), n, 2).

    Each leg becomes two breakpoints — (depart, node_k) and
    (depart + travel, node_{k+1}) — so np.interp renders both the motion
    and the pause (a flat segment) in one C-level pass per entity, with no
    steps x entities temporaries.
    """
    n, m = travel.shape
    tp = np.empty((n, 2 * m))
    tp[:, 0::2] = leg_start
    tp[:, 1::2] = leg_start + travel
    xs = np.empty((n, 2 * m, 2))
    xs[:, 0::2] = nodes[:, :-1]
    xs[:, 1::2] = nodes[:, 1:]
    pos = np.empty((len(tq), n, 2), np.float32)
    for i in range(n):  # C-speed interp per entity; no batched temporaries
        pos[:, i, 0] = np.interp(tq, tp[i], xs[i, :, 0])
        pos[:, i, 1] = np.interp(tq, tp[i], xs[i, :, 1])
    return pos


# ---------------------------------------------------------------------------
# Random waypoint (vectorized port of mobility/waypoint.py::RandomWaypoint)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RandomWaypointModel:
    num_devices: int = 20
    area: float = 1000.0  # m (square side)
    mean_speed: float = 10.0  # m/s; per-leg speeds ~ U(0.5v, 1.5v)
    pause_max: float = 5.0  # s pause at each waypoint
    mobile_mes: bool = False  # seed parity: entity 0 (the MES) also moves
    seed: int = 0

    def trace(self, duration: float, dt: float = 1.0) -> Trace:
        rng = np.random.default_rng(self.seed)
        steps = int(duration / dt)
        tq = np.arange(steps) * dt
        n_ent = self.num_devices + (1 if self.mobile_mes else 0)

        # generous leg budget: mean leg = mean travel + mean pause, with the
        # expected distance between two uniform points in a square = .5214 a
        est_leg = 0.5214 * self.area / self.mean_speed + 0.5 * self.pause_max
        m = int(duration / max(est_leg, 1e-9) * 1.8) + 8
        while True:
            nodes = rng.uniform(0, self.area, (n_ent, m + 1, 2))
            speeds = rng.uniform(
                0.5 * self.mean_speed, 1.5 * self.mean_speed, (n_ent, m)
            )
            pauses = rng.uniform(0, self.pause_max, (n_ent, m))
            travel = (
                np.linalg.norm(np.diff(nodes, axis=1), axis=-1)
                / np.maximum(speeds, 1e-9)
            )
            leg_start = np.zeros((n_ent, m + 1))
            leg_start[:, 1:] = np.cumsum(travel + pauses, axis=1)
            if leg_start[:, -1].min() >= duration:
                break
            m *= 2  # rare: a device drew unusually short legs

        pos = _interp_legs(tq, leg_start[:, :-1], travel, nodes)
        if self.mobile_mes:
            return Trace(pos=pos[:, 1:], mes=pos[:, 0], dt=dt)
        return Trace(pos=pos, mes=_static_mes(steps, self.area), dt=dt)


# ---------------------------------------------------------------------------
# Gauss-Markov
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GaussMarkovModel:
    num_devices: int = 20
    area: float = 1000.0
    mean_speed: float = 10.0  # E|v|
    corr_dist: float = 200.0  # m travelled before velocity decorrelates
    seed: int = 0

    def trace(self, duration: float, dt: float = 1.0) -> Trace:
        rng = np.random.default_rng(self.seed)
        steps = int(duration / dt)
        n = self.num_devices
        # alpha = exp(-v dt / d_corr): the memory time is d_corr / v, so the
        # whole process is a time-rescaling in mean_speed (inverse-speed law)
        alpha = np.exp(-dt * self.mean_speed / max(self.corr_dist, 1e-9))
        sig_c = self.mean_speed / np.sqrt(np.pi / 2.0)  # E|v| = sig_c sqrt(pi/2)
        scale = sig_c * np.sqrt(max(1.0 - alpha * alpha, 0.0))

        noise = rng.normal(0.0, 1.0, (steps, n, 2))
        v = np.empty((steps, n, 2))
        prev = rng.normal(0.0, sig_c, (n, 2))
        for t in range(steps):  # O(steps) recurrence on (n, 2) vectors
            prev = alpha * prev + scale * noise[t]
            v[t] = prev
        x0 = rng.uniform(0, self.area, (n, 2))
        pos = _reflect(x0[None] + np.cumsum(v, axis=0) * dt, self.area)
        return Trace(pos=pos, mes=_static_mes(steps, self.area), dt=dt)


# ---------------------------------------------------------------------------
# Manhattan grid (vehicular)
# ---------------------------------------------------------------------------

_DIRS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float64)


@dataclasses.dataclass
class ManhattanGridModel:
    num_devices: int = 20
    area: float = 1000.0
    mean_speed: float = 10.0  # per-device speeds ~ U(0.5v, 1.5v), constant
    block: float = 100.0  # m street spacing
    p_turn: float = 0.5  # turn probability at an intersection (split L/R)
    seed: int = 0

    def trace(self, duration: float, dt: float = 1.0) -> Trace:
        rng = np.random.default_rng(self.seed)
        steps = int(duration / dt)
        n = self.num_devices
        grid_n = max(int(round(self.area / self.block)), 1)
        a = grid_n * self.block  # snap area to a whole number of blocks

        speeds = rng.uniform(0.5 * self.mean_speed, 1.5 * self.mean_speed, n)
        speeds = np.maximum(speeds, 1e-9)
        m = int(duration * speeds.max() / self.block) + 2

        # i.i.d. turns -> heading per leg by cumulative rotation (mod 4)
        u = rng.random((n, m))
        turn = np.where(u < 0.5 * self.p_turn, 1, np.where(u < self.p_turn, -1, 0))
        head0 = rng.integers(0, 4, n)
        head = (head0[:, None] + np.concatenate(
            [np.zeros((n, 1), np.int64), np.cumsum(turn, axis=1)[:, :-1]], axis=1
        )) % 4
        start = rng.integers(0, grid_n + 1, (n, 2)) * self.block
        nodes = start[:, None, :] + self.block * np.concatenate(
            [np.zeros((n, 1, 2)), np.cumsum(_DIRS[head], axis=1)], axis=1
        )
        # reflection folds lattice points onto lattice points (block | area),
        # so interpolated positions always stay on a street
        nodes = _reflect(nodes, a)

        # constant leg duration per device -> leg index is a direct divide
        leg_dur = self.block / speeds  # (n,)
        tq = np.arange(steps) * dt
        idx = np.clip((tq[None, :] / leg_dur[:, None]).astype(np.int64), 0, m - 1)
        frac = np.clip(
            tq[None, :] / leg_dur[:, None] - idx, 0.0, 1.0
        )
        gather = np.broadcast_to(idx[:, :, None], (n, steps, 2))
        p0 = np.take_along_axis(nodes, gather, axis=1)
        p1 = np.take_along_axis(nodes, gather + 1, axis=1)
        pos = (p0 + frac[:, :, None] * (p1 - p0)).transpose(1, 0, 2)
        return Trace(pos=pos, mes=_static_mes(steps, a), dt=dt)


# ---------------------------------------------------------------------------
# Hotspot clusters (quasi-static crowds)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HotspotClusterModel:
    num_devices: int = 20
    area: float = 1000.0
    mean_speed: float = 10.0  # 0 -> perfectly static devices
    num_hotspots: int = 4
    hotspot_radius: float = 150.0  # RMS excursion around the anchor
    seed: int = 0

    def trace(self, duration: float, dt: float = 1.0) -> Trace:
        rng = np.random.default_rng(self.seed)
        steps = int(duration / dt)
        n = self.num_devices
        centers = rng.uniform(0.15 * self.area, 0.85 * self.area,
                              (self.num_hotspots, 2))
        anchor = centers[rng.integers(0, self.num_hotspots, n)]

        sig_c = self.hotspot_radius / np.sqrt(2.0)  # per-axis -> RMS = radius
        if self.mean_speed <= 0:  # static scenario
            off = rng.normal(0.0, sig_c, (n, 2))
            pos = np.broadcast_to(
                np.clip(anchor + off, 0.0, self.area), (steps, n, 2)
            ).copy()
            return Trace(pos=pos, mes=_static_mes(steps, self.area), dt=dt)

        # smooth wander around the anchor: Gauss-Markov VELOCITY with a
        # restoring drift toward the hotspot centre.  A velocity-level (not
        # position-level) noise keeps sample paths differentiable, so range
        # crossings have macroscopic duration and the whole process is a
        # time-rescaling in mean_speed (inverse-speed law).
        radius = max(self.hotspot_radius, 1e-9)
        rate = self.mean_speed / radius  # 1/s relaxation
        alpha = np.exp(-dt * rate)
        vel_sig = self.mean_speed / np.sqrt(np.pi / 2.0)
        scale = vel_sig * np.sqrt(max(1.0 - alpha * alpha, 0.0))
        noise = rng.normal(0.0, 1.0, (steps, n, 2))
        pos = np.empty((steps, n, 2))
        off = rng.normal(0.0, sig_c, (n, 2))
        vel = rng.normal(0.0, vel_sig, (n, 2))
        for t in range(steps):  # O(steps) recurrence on (n, 2) vectors
            vel = alpha * vel - (1.0 - alpha) * rate * off + scale * noise[t]
            off = off + vel * dt
            pos[t] = anchor + off
        pos = np.clip(pos, 0.0, self.area)
        return Trace(pos=pos, mes=_static_mes(steps, self.area), dt=dt)
