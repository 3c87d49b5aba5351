"""ScenarioProvider — streaming (zeta, tau, h2) round inputs for AFL.

One object owns the whole scenario: a mobility model (or the paper's
exponential renewal abstraction), the contact extractor, the
position-coupled channel and the heterogeneity gate.
``from_config(fl)`` reads everything from the ``FLConfig`` scenario
fields; the full rounds x N schedule is built on first access and then
streamed per round to ``core/runner.py``.

Two backends (``fl.scenario_backend``, the reference's values):
``"numpy"`` builds on the host with the numpy oracle (equal to the
reference's arrays for the same seeds); ``"jax"`` names the reference's
device-resident engine and here means its torch twin
(``torch_kinematics.py``), which builds the schedule as tensors on
``from_config``'s ``device``.  The exponential renewal abstraction always
builds on the host.

    provider = ScenarioProvider.from_config(fl, rounds)
    for zeta_r, tau_r, h2_r in provider: ...   # or provider.round(r)
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.channel.wireless import WirelessChannel
from repro_torch.mobility.contact import ContactProcess
from repro_torch.scenarios.contacts import rounds_from_trace
from repro_torch.scenarios.heterogeneity import HeterogeneityModel, torch_apply
from repro_torch.scenarios.kinematics import (
    GaussMarkovModel,
    HotspotClusterModel,
    ManhattanGridModel,
    MobilityModel,
    RandomWaypointModel,
)
from repro_torch.scenarios.torch_kinematics import (
    TORCH_MODELS,
    torch_schedule_from_model,
)

Schedule = Tuple[np.ndarray, np.ndarray, np.ndarray]

MODELS = {
    "rwp": RandomWaypointModel,
    "gauss_markov": GaussMarkovModel,
    "manhattan": ManhattanGridModel,
    "hotspot": HotspotClusterModel,
}


def _channel_from_config(fl, seed: int) -> WirelessChannel:
    return WirelessChannel(
        bandwidth=fl.bandwidth, carrier_ghz=fl.carrier_ghz,
        noise_dbm_hz=fl.noise_dbm_hz, seed=seed,
    )


def _model_kwargs(fl, seed: int):
    """(class key, constructor kwargs) of the FLConfig-selected model.

    ``fl.speed = 0`` is the legacy "unset" sentinel and maps to 10 m/s for
    the moving models; ``static`` is a zero-speed hotspot crowd.
    """
    name = fl.mobility_model
    speed = fl.speed if fl.speed > 0 else 10.0
    kw = dict(num_devices=fl.num_devices, area=fl.area, mean_speed=speed,
              seed=seed)
    if name == "rwp":
        return name, dict(pause_max=fl.pause_max, **kw)
    if name == "gauss_markov":
        return name, dict(corr_dist=fl.gm_corr_dist, **kw)
    if name == "manhattan":
        return name, dict(block=fl.street_block, **kw)
    if name in ("hotspot", "static"):
        if name == "static":
            kw["mean_speed"] = 0.0
        return "hotspot", dict(num_hotspots=fl.num_hotspots,
                               hotspot_radius=fl.hotspot_radius, **kw)
    raise KeyError(f"unknown mobility model {name!r}; known: "
                   f"exponential, static, {sorted(MODELS)}")


def model_from_config(fl, seed: Optional[int] = None) -> MobilityModel:
    """Build the FLConfig-selected kinematic model (trace models only)."""
    key, kw = _model_kwargs(fl, fl.seed if seed is None else seed)
    return MODELS[key](**kw)


def torch_model_from_config(fl, seed: Optional[int] = None, device="cuda"):
    """The device-resident twin of ``model_from_config``: the same FLConfig
    fields and speed sentinel, a frozen torch model on ``device``."""
    key, kw = _model_kwargs(fl, fl.seed if seed is None else seed)
    return TORCH_MODELS[key](device=str(device), **kw)


class ScenarioProvider:
    """Streams per-round (zeta, tau, h2); precomputes the schedule lazily.

    With a ``HeterogeneityModel`` attached (``fl.het_*`` knobs), the built
    schedule is gated once — effective window = contact ∩ available, minus
    compute time, minus dropout — on the schedule's own device, and the
    per-round loss masks are exposed as ``aux`` / ``aux_round``.
    """

    def __init__(self, rounds: int, num_devices: int,
                 build: Optional[Callable[[], Schedule]] = None,
                 schedule: Optional[Schedule] = None,
                 het: Optional[HeterogeneityModel] = None):
        self.rounds = rounds
        self.num_devices = num_devices
        self._build = build
        self._schedule = schedule
        self._het = het if (het is not None and het.enabled()) else None
        self._aux = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_config(cls, fl, rounds: Optional[int] = None,
                    seed: Optional[int] = None,
                    device="cuda") -> "ScenarioProvider":
        """Scenario selected by ``fl.mobility_model``.

        ``"exponential"`` reproduces the paper's renewal abstraction with
        i.i.d. channel gains; the trace models derive (zeta, tau) from
        simulated motion and h2 from the actual device-MES distances.
        Only the device-resident backend (``fl.scenario_backend="jax"``)
        reads ``device``.
        """
        rounds = fl.rounds if rounds is None else rounds
        seed = fl.seed if seed is None else seed
        chan = _channel_from_config(fl, seed + 1)
        het = HeterogeneityModel.from_config(fl, seed + 2)

        backend = fl.scenario_backend
        if backend not in ("numpy", "jax"):
            raise KeyError(f"unknown scenario backend {backend!r}; "
                           "known: numpy, jax")
        # the renewal abstraction has no kinematics: it always builds
        # host-side (already O(rounds x N) vectorized)
        if backend == "jax" and fl.mobility_model != "exponential":
            model = torch_model_from_config(fl, seed, device)

            def build() -> Schedule:
                return torch_schedule_from_model(
                    model, rounds, fl.round_duration, dt=fl.mobility_dt,
                    comm_range=fl.comm_range,
                    shadow_corr_dist=fl.shadow_corr_dist,
                    carrier_ghz=fl.carrier_ghz,
                )

            return cls(rounds, fl.num_devices, build=build, het=het)

        if fl.mobility_model == "exponential":
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
                # no positions in the renewal abstraction: i.i.d. gains
                h2 = chan.sample_gain((rounds, fl.num_devices))
                return zeta, tau, h2.astype(np.float32)
        else:
            model = model_from_config(fl, seed)

            def build() -> Schedule:
                trace = model.trace(rounds * fl.round_duration, fl.mobility_dt)
                zeta, tau, h2 = rounds_from_trace(
                    trace, fl.comm_range, rounds, fl.round_duration,
                    channel=chan, shadow_corr_dist=fl.shadow_corr_dist,
                    rng=np.random.default_rng(seed + 1),
                )
                return zeta, tau, h2.astype(np.float32)

        return cls(rounds, fl.num_devices, build=build, het=het)

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

    @classmethod
    def from_model(cls, model: MobilityModel, rounds: int,
                   round_duration: float, comm_range: float = 100.0,
                   channel: Optional[WirelessChannel] = None,
                   dt: float = 1.0, shadow_corr_dist: float = 25.0,
                   seed: int = 0) -> "ScenarioProvider":
        """Scenario from an explicit numpy kinematic model (tests /
        notebooks)."""
        channel = channel or WirelessChannel(seed=seed + 1)

        def build() -> Schedule:
            trace = model.trace(rounds * round_duration, dt)
            zeta, tau, h2 = rounds_from_trace(
                trace, comm_range, rounds, round_duration, channel=channel,
                shadow_corr_dist=shadow_corr_dist,
                rng=np.random.default_rng(seed + 1),
            )
            return zeta, tau, h2.astype(np.float32)

        return cls(rounds, model.num_devices, build=build)

    # -- access -------------------------------------------------------------

    def prefetch(self) -> "ScenarioProvider":
        """Force schedule materialisation now (otherwise lazy)."""
        self.schedule()
        return self

    def schedule(self) -> Schedule:
        """The full (zeta, tau, h2), each (rounds, num_devices): numpy
        arrays, or tensors on the device of a device-resident build."""
        if self._schedule is None:
            zeta, tau, h2 = self._build()
            if self._het is not None:
                if isinstance(zeta, torch.Tensor):  # gate on its device
                    zeta, tau, self._aux = torch_apply(self._het, zeta, tau)
                else:
                    zeta, tau, self._aux = self._het.apply(zeta, tau)
            self._schedule = (zeta, tau, h2)
        return self._schedule

    @property
    def aux(self):
        """Heterogeneity loss masks {"unavail", "dropout"}, each
        (rounds, N) on the schedule's device, or None when the layer is
        disabled."""
        self.schedule()
        return self._aux

    def aux_round(self, r: int):
        """Round r's slice of ``aux`` (None when disabled)."""
        aux = self.aux
        return None if aux is None else {k: v[r] for k, v in aux.items()}

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
