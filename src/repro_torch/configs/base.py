"""Config system: the model config, the federated config and the registry.

``FLConfig`` copies ``repro.configs.base.FLConfig`` with the same fields
and defaults, so a configuration means the same thing in both packages;
the knobs of layers not ported yet are refused where they would be read.
``ModelConfig`` keeps only the fields of the ported model family
(vision); the other families add theirs when they are ported.  The
registry lists only the architectures this package ports (``load_all``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

@dataclass(frozen=True)
class ModelConfig:
    """One architecture of a ported family (vision: ResNet-9)."""

    name: str
    family: str  # vision
    num_layers: int
    d_model: int  # vision: base channel width
    vocab_size: int  # vision: number of classes
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    source: str = ""  # citation

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FLConfig:
    """Paper system model parameters (Table I defaults)."""

    num_devices: int = 20  # N
    rounds: int = 200  # R
    round_duration: float = 10.0  # delta, seconds
    learning_rate: float = 0.01  # eta
    batch_size: int = 32
    # mobility (exponential inter-contact model, §III-B)
    mean_contact: float = 4.0  # c_n seconds
    mean_intercontact: float = 400.0  # lambda_n seconds
    speed: float = 0.0  # if >0: c=C/v, lambda=Lambda/v
    contact_const: float = 40.0  # C
    intercontact_const: float = 4000.0  # Lambda
    # scenario engine (repro/scenarios): trace-based mobility + channels
    mobility_model: str = "exponential"  # exponential|rwp|gauss_markov|manhattan|hotspot|static
    area: float = 1000.0  # m, square side
    comm_range: float = 100.0  # m, device-MES contact range
    mobility_dt: float = 1.0  # s, kinematics sampling step
    pause_max: float = 5.0  # s, rwp waypoint pause
    gm_corr_dist: float = 200.0  # m, gauss_markov velocity decorrelation
    street_block: float = 100.0  # m, manhattan grid spacing
    num_hotspots: int = 4
    hotspot_radius: float = 150.0  # m, RMS excursion around a hotspot
    shadow_corr_dist: float = 25.0  # m, Gudmundson shadowing decorrelation
    # scenario backend: "numpy" keeps the oracle kinematics; "jax" builds
    # the whole schedule device-resident (repro/scenarios/jax_kinematics).
    # Host-side knob — the compiled round consumes the same arrays either way
    scenario_backend: str = "numpy"
    # per-client system heterogeneity (repro/scenarios/heterogeneity):
    # contact windows are gated by a Markov availability chain, an Exp
    # compute-latency draw, and an i.i.d. dropout coin.  Defaults disable
    # the layer entirely (no schedule rewrite, no aux masks)
    het_availability: float = 1.0  # stationary P(client available)
    het_avail_persist: float = 0.0  # availability chain persistence rho
    het_compute_mean: float = 0.0  # s, mean Exp local-compute latency
    het_dropout: float = 0.0  # P(upload lost despite a fitting window)
    # wireless (Table I)
    bandwidth: float = 1e6  # B_n, Hz
    carrier_ghz: float = 3.5
    max_power: float = 0.2  # W
    noise_dbm_hz: float = -174.0
    value_bits: int = 32  # u
    # energy / MADS
    energy_budget: Tuple[float, float] = (50.0, 150.0)  # J, uniform range
    lyapunov_v: float = 1e-4
    # sparsification
    sparsifier: str = "exact"  # exact | sampled
    sample_size: int = 65536
    # compression codecs (repro/compression; host-side — consumed by the
    # baselines.* policy factories, not by the compiled round)
    compress_b_min: int = 2  # smallest usable value bit-width
    compress_b_max: int = 16  # largest value bit-width the codecs consider
    fixed_k_frac: float = 0.01  # fixed-kb baseline: keep-fraction target
    fixed_bits: int = 8  # fixed-kb baseline: value bit-width
    # joint codec: solve (k_l, b_l) per pytree leaf by greedy water-filling
    # against the same tau*A budget (repro/compression/perlayer.py)
    per_layer_budget: bool = False
    # staleness-discounted aggregation (core/afl.py::StalenessWeight): the
    # FedAsync alpha * s(delta_tau) mixing family shared by the engines and
    # the streaming ingestion server (repro/serve).  The default — constant
    # at alpha = 1 — is the paper's rule and compiles to the identity
    staleness_family: str = "constant"  # constant | hinge | poly
    staleness_alpha: float = 1.0
    staleness_hinge_a: float = 10.0
    staleness_hinge_b: float = 4.0
    staleness_poly_a: float = 0.5
    # telemetry (the reference's repro/telemetry: metric registry,
    # per-device flight recorder, theory probes).  Not ported yet:
    # core/runner.py::run_afl raises NotImplementedError when any is set
    telemetry: bool = False
    telemetry_perdevice: bool = False
    telemetry_probes: bool = False
    # non-iid
    dirichlet_rho: float = 0.5
    seed: int = 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all() -> None:
    """Import every ported config module (they self-register)."""
    import importlib

    for mod in ("resnet9_cifar10",):
        importlib.import_module(f"repro_torch.configs.{mod}")
