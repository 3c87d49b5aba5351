"""Device-resident mobility kinematics: the torch twin of ``kinematics.py``.

The numpy models in ``kinematics.py`` are the *oracle*: readable,
host-side, and equal to the reference's arrays.  This module runs the same
four models as plain tensor code on the run's device (float32, like the
reference's ``scenarios/jax_kinematics.py``), so the whole scenario
pipeline — trace -> in-range -> contact intervals -> per-round
(zeta, tau) -> position-coupled h2 — stays on the card, with no host
round-trip between the first draw and the finished (rounds, N) schedule.
Generation cost then scales with the card's bandwidth, not with host
Python, up to million-device federations.

Differences from the oracle, by construction (the same as the JAX
twin's):

* Randomness: ``torch.Generator`` streams cannot reproduce
  ``np.random.default_rng`` draws, so parity with the oracle is
  *statistical* (distributional bounds and CI bands,
  tests/test_torch_device_scenarios.py).  Every stream has a generator of
  its own on the run's device, seeded from ``(seed, stream)``
  (``stream_generator``), so adding a stream shifts no other.  The
  downstream extraction (``torch_contacts.py``) IS exact: on a shared
  in-range matrix it reproduces the oracle cell by cell.
* Random waypoint draws a *static* leg budget (2.2x the expected leg
  count + 16) instead of the oracle's redraw-until-covered loop; a device
  that exhausts it parks at its last waypoint (the clamp ``np.interp``
  applies past the final breakpoint).
* Manhattan sizes its leg budget by the worst-case per-device speed
  (1.5 v) rather than the realised ``speeds.max()``.

The AR(1) recurrences (Gauss-Markov, hotspot, the channel's LOS and
shadowing state) are Python loops of a few launches per step: the host
paces them at ~1,000 launches per 200 steps.

Every model is a frozen dataclass satisfying the ``MobilityModel``
protocol (``num_devices`` / ``area`` / ``mean_speed`` / ``trace``) with a
``device`` field (the card unless the caller asks for the CPU).  Memory:
a trace holds (steps, N, 2) float32 positions on the device (~0.8 GB at
N = 1e5, 1000 steps); for N -> 1e6 keep the horizon short.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.scenarios.torch_contacts import rounds_from_in_range
from repro_torch.utils.device import resolve_device

__all__ = [
    "TorchTrace",
    "TorchRandomWaypointModel",
    "TorchGaussMarkovModel",
    "TorchManhattanGridModel",
    "TorchHotspotClusterModel",
    "TORCH_MODELS",
    "stream_generator",
    "torch_gains_along_trace",
    "torch_schedule_from_model",
]

# stream families of one seed: the trace's, the channel's and the
# heterogeneity layer's draws
TRACE, CHANNEL, HETEROGENEITY = 0, 1, 2


def stream_generator(device, seed: int, *stream: int) -> torch.Generator:
    """A generator on ``device`` for one random stream of ``seed``."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _uniform(shape, lo, hi, gen):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _normal(shape, gen):
    return torch.randn(shape, generator=gen, device=gen.device)


@dataclasses.dataclass
class TorchTrace:
    """Device-resident twin of ``kinematics.Trace`` (float32 tensors)."""

    pos: torch.Tensor  # (steps, num_devices, 2), metres
    mes: torch.Tensor  # (steps, 2) MES position
    dt: float

    @property
    def steps(self) -> int:
        return self.pos.shape[0]

    @property
    def num_devices(self) -> int:
        return self.pos.shape[1]

    def distances(self) -> torch.Tensor:
        return torch.linalg.norm(self.pos - self.mes[:, None, :], dim=-1)

    def in_range(self, comm_range: float) -> torch.Tensor:
        return self.distances() < comm_range

    def to_numpy(self):
        """Host copy as the oracle's ``Trace`` (tests only)."""
        from repro_torch.scenarios.kinematics import Trace

        return Trace(pos=self.pos.cpu().numpy(), mes=self.mes.cpu().numpy(),
                     dt=self.dt)


def _reflect(x: torch.Tensor, hi: float) -> torch.Tensor:
    """Fold unbounded coordinates into [0, hi] by reflection at the walls."""
    y = torch.remainder(x, 2.0 * hi)
    return torch.where(y > hi, 2.0 * hi - y, y)


def _static_mes(steps: int, area: float, device) -> torch.Tensor:
    return torch.full((steps, 2), 0.5 * area, dtype=torch.float32,
                      device=device)


# ---------------------------------------------------------------------------
# Positions (gens: the model's trace streams, on the run's device)
# ---------------------------------------------------------------------------


def _rwp_positions(gens, steps: int, dt: float, n: int, area: float,
                   mean_speed: float, pause_max: float):
    """Leg-based random waypoint, batched over devices: one batched
    ``searchsorted`` over the (n, 2m) breakpoint table and a gather
    replace the oracle's per-device ``np.interp`` loop."""
    duration = steps * dt
    est_leg = 0.5214 * area / max(mean_speed, 1e-9) + 0.5 * pause_max
    m = int(duration / max(est_leg, 1e-9) * 2.2) + 16  # static budget
    g_nodes, g_speed, g_pause = gens[:3]
    nodes = _uniform((n, m + 1, 2), 0.0, area, g_nodes)
    speeds = _uniform((n, m), 0.5 * mean_speed, 1.5 * mean_speed, g_speed)
    pauses = _uniform((n, m), 0.0, pause_max, g_pause)
    travel = (torch.linalg.norm(torch.diff(nodes, dim=1), dim=-1)
              / speeds.clamp(min=1e-9))
    leg_start = torch.cumsum(travel + pauses, dim=1) - (travel + pauses)

    # breakpoints: (depart, node_k) then (arrive, node_{k+1}) per leg —
    # renders motion and pause (a flat segment) like the oracle
    tp = torch.stack([leg_start, leg_start + travel], dim=2).reshape(n, 2 * m)
    xs = torch.stack([nodes[:, :-1], nodes[:, 1:]], dim=2).reshape(n, 2 * m, 2)

    tq = torch.arange(steps, dtype=torch.float32, device=tp.device) * dt
    idx = torch.searchsorted(tp, tq.expand(n, steps).contiguous(), right=True)
    i1 = idx.clamp(1, 2 * m - 1)
    i0 = i1 - 1
    t0 = torch.gather(tp, 1, i0)  # (n, steps)
    t1 = torch.gather(tp, 1, i1)
    x0 = torch.gather(xs, 1, i0[:, :, None].expand(n, steps, 2))
    x1 = torch.gather(xs, 1, i1[:, :, None].expand(n, steps, 2))
    den = t1 - t0
    frac = torch.where(den > 0, (tq[None] - t0) / den.clamp(min=1e-12),
                       1.0).clamp(0.0, 1.0)
    pos = x0 + frac[:, :, None] * (x1 - x0)
    return pos.transpose(0, 1)  # (steps, n, 2)


def _gm_positions(gens, steps: int, dt: float, n: int, area: float,
                  mean_speed: float, corr_dist: float):
    """AR(1) velocity with reflecting walls, the oracle's recurrence; the
    displacement is integrated in the loop's carry."""
    alpha = math.exp(-dt * mean_speed / max(corr_dist, 1e-9))
    sig_c = mean_speed / math.sqrt(math.pi / 2.0)
    scale = sig_c * math.sqrt(max(1.0 - alpha * alpha, 0.0))
    g_noise, g_v0, g_x0 = gens[:3]
    noise = _normal((steps, n, 2), g_noise)
    v = sig_c * _normal((n, 2), g_v0)
    x0 = _uniform((n, 2), 0.0, area, g_x0)
    disp = torch.empty_like(noise)
    s = torch.zeros_like(v)
    for t in range(steps):  # O(steps) recurrence on (n, 2) tensors
        v = alpha * v + scale * noise[t]
        s = s + v * dt
        disp[t] = s
    return _reflect(x0[None] + disp, area)


def _manhattan_positions(gens, steps: int, dt: float, n: int, area: float,
                         mean_speed: float, block: float, p_turn: float):
    """Lattice streets, i.i.d. turns: the oracle's closed form (cumsum of
    turns, direct leg-index divide), one-to-one."""
    grid_n = max(int(round(area / block)), 1)
    a = grid_n * block
    duration = steps * dt
    m = int(duration * 1.5 * mean_speed / block) + 2  # worst-case speed
    g_speed, g_turn, g_head, g_start = gens[:4]
    dev = g_speed.device
    speeds = _uniform((n,), 0.5 * mean_speed, 1.5 * mean_speed,
                      g_speed).clamp(min=1e-9)
    u = torch.rand((n, m), generator=g_turn, device=dev)
    turn = torch.where(u < 0.5 * p_turn, 1, torch.where(u < p_turn, -1, 0))
    head0 = torch.randint(0, 4, (n,), generator=g_head, device=dev)
    head = (head0[:, None] + torch.cat(
        [torch.zeros((n, 1), dtype=turn.dtype, device=dev),
         torch.cumsum(turn, dim=1)[:, :-1]], dim=1)) % 4
    start = torch.randint(0, grid_n + 1, (n, 2), generator=g_start,
                          device=dev).to(torch.float32) * block
    # unit step of heading 0..3 = east, north, west, south (built on the
    # device: a host table would be a synchronising copy)
    step = torch.stack([(head == 0).float() - (head == 2).float(),
                        (head == 1).float() - (head == 3).float()], dim=-1)
    nodes = start[:, None, :] + block * torch.cat(
        [torch.zeros((n, 1, 2), device=dev), torch.cumsum(step, dim=1)],
        dim=1)
    # reflection folds lattice points onto lattice points (block | area)
    nodes = _reflect(nodes, a)

    leg_dur = block / speeds  # (n,)
    tq = torch.arange(steps, dtype=torch.float32, device=dev) * dt
    pos_t = tq[None, :] / leg_dur[:, None]
    idx = pos_t.to(torch.int64).clamp(0, m - 1)
    frac = (pos_t - idx).clamp(0.0, 1.0)
    gather = idx[:, :, None].expand(n, steps, 2)
    p0 = torch.gather(nodes, 1, gather)
    p1 = torch.gather(nodes, 1, gather + 1)
    pos = p0 + frac[:, :, None] * (p1 - p0)
    return pos.transpose(0, 1), a


def _hotspot_positions(gens, steps: int, dt: float, n: int, area: float,
                       mean_speed: float, num_hotspots: int, radius: float):
    """OU excursion around hotspot anchors; ``mean_speed == 0`` is the
    static crowd."""
    g_center, g_anchor, g_off, g_vel, g_noise = gens[:5]
    centers = _uniform((num_hotspots, 2), 0.15 * area, 0.85 * area, g_center)
    anchor = centers[torch.randint(0, num_hotspots, (n,), generator=g_anchor,
                                   device=g_anchor.device)]
    sig_c = radius / math.sqrt(2.0)
    off = sig_c * _normal((n, 2), g_off)
    if mean_speed <= 0:  # static scenario
        pos = (anchor + off).clamp(0.0, area)
        return pos[None].expand(steps, n, 2)

    rate = mean_speed / max(radius, 1e-9)
    alpha = math.exp(-dt * rate)
    vel_sig = mean_speed / math.sqrt(math.pi / 2.0)
    scale = vel_sig * math.sqrt(max(1.0 - alpha * alpha, 0.0))
    vel = vel_sig * _normal((n, 2), g_vel)
    noise = _normal((steps, n, 2), g_noise)
    offs = torch.empty_like(noise)
    for t in range(steps):  # O(steps) recurrence on (n, 2) tensors
        vel = alpha * vel - (1.0 - alpha) * rate * off + scale * noise[t]
        off = off + vel * dt
        offs[t] = off
    return (anchor[None] + offs).clamp(0.0, area)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


class _TorchModelBase:
    """Shared ``trace`` / stream plumbing of the four models below."""

    def positions(self, steps: int, dt: float, seed=None):
        """(pos, mes) tensors on the model's device for ``steps`` samples;
        ``seed`` overrides the model's own."""
        device = resolve_device(self.device)
        seed = self.seed if seed is None else seed
        gens = [stream_generator(device, seed, TRACE, i) for i in range(5)]
        return self._positions(gens, steps, float(dt))

    def trace(self, duration: float, dt: float = 1.0) -> TorchTrace:
        pos, mes = self.positions(int(duration / dt), dt)
        return TorchTrace(pos=pos, mes=mes, dt=float(dt))


@dataclasses.dataclass(frozen=True)
class TorchRandomWaypointModel(_TorchModelBase):
    num_devices: int = 20
    area: float = 1000.0
    mean_speed: float = 10.0  # m/s; per-leg speeds ~ U(0.5v, 1.5v)
    pause_max: float = 5.0
    seed: int = 0
    device: str = "cuda"

    def _positions(self, gens, steps: int, dt: float):
        pos = _rwp_positions(gens, steps, dt, self.num_devices, self.area,
                             self.mean_speed, self.pause_max)
        return pos, _static_mes(steps, self.area, pos.device)


@dataclasses.dataclass(frozen=True)
class TorchGaussMarkovModel(_TorchModelBase):
    num_devices: int = 20
    area: float = 1000.0
    mean_speed: float = 10.0
    corr_dist: float = 200.0  # inverse-speed law by construction (oracle)
    seed: int = 0
    device: str = "cuda"

    def _positions(self, gens, steps: int, dt: float):
        pos = _gm_positions(gens, steps, dt, self.num_devices, self.area,
                            self.mean_speed, self.corr_dist)
        return pos, _static_mes(steps, self.area, pos.device)


@dataclasses.dataclass(frozen=True)
class TorchManhattanGridModel(_TorchModelBase):
    num_devices: int = 20
    area: float = 1000.0
    mean_speed: float = 10.0
    block: float = 100.0
    p_turn: float = 0.5
    seed: int = 0
    device: str = "cuda"

    def _positions(self, gens, steps: int, dt: float):
        pos, a = _manhattan_positions(
            gens, steps, dt, self.num_devices, self.area, self.mean_speed,
            self.block, self.p_turn)
        return pos, _static_mes(steps, a, pos.device)


@dataclasses.dataclass(frozen=True)
class TorchHotspotClusterModel(_TorchModelBase):
    num_devices: int = 20
    area: float = 1000.0
    mean_speed: float = 10.0  # 0 -> perfectly static devices
    num_hotspots: int = 4
    hotspot_radius: float = 150.0
    seed: int = 0
    device: str = "cuda"

    def _positions(self, gens, steps: int, dt: float):
        pos = _hotspot_positions(
            gens, steps, dt, self.num_devices, self.area, self.mean_speed,
            self.num_hotspots, self.hotspot_radius)
        return pos, _static_mes(steps, self.area, pos.device)


TORCH_MODELS = {
    "rwp": TorchRandomWaypointModel,
    "gauss_markov": TorchGaussMarkovModel,
    "manhattan": TorchManhattanGridModel,
    "hotspot": TorchHotspotClusterModel,
}


# ---------------------------------------------------------------------------
# Position-coupled channel gains (twin of scenarios/channel.py)
# ---------------------------------------------------------------------------


def torch_gains_along_trace(seed: int, pos, mes, *, carrier_ghz: float = 3.5,
                            shadow_los_db: float = 4.0,
                            shadow_nlos_db: float = 8.2,
                            shadow_corr_dist: float = 25.0):
    """|h|^2 per (round, device) from per-round positions, on their device.

    pos: (rounds, N, 2); mes: (rounds, 2).  The TR 38.901 UMi model of
    ``gains_along_trace``: distance path loss, Gudmundson AR(1) lognormal
    shadowing (round-to-round correlation ``exp(-displacement /
    shadow_corr_dist)``) and a persistent LOS state redrawn only when the
    device moves.  The draws come from ``seed``'s channel streams, so the
    gains match the numpy path in distribution, not bitwise.
    """
    device = pos.device
    d = torch.linalg.norm(pos - mes[:, None, :], dim=-1)  # (R, n)
    r_total, n = d.shape
    dm = d.clamp(min=1e-9)
    p_los = torch.where(d <= 18.0, 1.0,
                        torch.clamp(18.0 / dm + torch.exp(-d / 36.0)
                                    * (1.0 - 18.0 / dm), max=1.0))
    disp = torch.cat([torch.zeros((1, n), device=device),
                      torch.linalg.norm(pos[1:] - pos[:-1], dim=-1)])
    rho = torch.exp(-disp / max(shadow_corr_dist, 1e-9))
    # round 0 draws fresh LOS/shadowing state: zero correlation with the
    # (all-zeros) initial state
    rho[0] = 0.0
    innov = torch.sqrt(torch.clamp(1.0 - rho ** 2, min=0.0))
    g_redraw, g_los, g_z = (stream_generator(device, seed, CHANNEL, i)
                            for i in range(3))
    redraw = torch.rand((r_total, n), generator=g_redraw, device=device) >= rho
    fresh = torch.rand((r_total, n), generator=g_los, device=device) < p_los
    eps = _normal((r_total, n), g_z)

    los = torch.empty((r_total, n), dtype=torch.bool, device=device)
    z = torch.empty((r_total, n), device=device)
    los_p = torch.zeros(n, dtype=torch.bool, device=device)
    z_p = torch.zeros(n, device=device)
    for r in range(r_total):  # O(rounds) recurrence on (n,) tensors
        los_p = torch.where(redraw[r], fresh[r], los_p)
        z_p = rho[r] * z_p + innov[r] * eps[r]
        los[r], z[r] = los_p, z_p

    dcl = d.clamp(min=1.0)
    pl = (32.4 + torch.where(los, 21.0, 31.9) * torch.log10(dcl)
          + 20.0 * math.log10(carrier_ghz))
    sigma = torch.where(los, shadow_los_db, shadow_nlos_db)
    return (10.0 ** (-(pl + sigma * z) / 10.0)).to(torch.float32)


# ---------------------------------------------------------------------------
# End-to-end schedule: trace -> contacts -> (zeta, tau, h2), on the device
# ---------------------------------------------------------------------------


def torch_schedule_from_model(model, rounds: int, round_duration: float,
                              *, dt: float = 1.0, comm_range: float = 100.0,
                              shadow_corr_dist: float = 25.0,
                              carrier_ghz: float = 3.5,
                              drop_truncated: bool = False, seed=None):
    """(zeta, tau, h2) tensors on the model's device from a torch model.

    The whole pipeline — draws, kinematics, in-range test, interval
    extraction, round mapping, channel gains — runs on the device and
    never waits for it: no intermediate crosses to the host.
    ``drop_truncated`` drops contacts still open at the trace end instead
    of censoring them at the window.  ``seed`` overrides the model's.
    """
    seed = model.seed if seed is None else seed
    steps = int(rounds * round_duration / dt)
    pos, mes = model.positions(steps, dt, seed)
    dist = torch.linalg.norm(pos - mes[:, None, :], dim=-1)
    zeta, tau = rounds_from_in_range(dist < comm_range, dt, rounds,
                                     round_duration,
                                     drop_truncated=drop_truncated)
    # per-round sample index, the oracle's non-drifting derivation
    # (floor of r * round_duration / dt in float64, not a fixed stride)
    ratio = round_duration / dt
    ridx = (torch.arange(rounds, dtype=torch.float64, device=pos.device)
            * ratio).to(torch.int64).clamp(max=steps - 1)
    h2 = torch_gains_along_trace(
        seed, pos[ridx], mes[ridx], carrier_ghz=carrier_ghz,
        shadow_corr_dist=shadow_corr_dist)
    return zeta, tau, h2
