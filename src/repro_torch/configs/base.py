"""Config system: the model config, the federated config and the registry.

``FLConfig`` copies ``repro.configs.base.FLConfig`` with the same fields
and defaults, so a configuration means the same thing in both packages;
the knobs of layers not ported yet are refused where they would be read.
``ModelConfig`` has the reference's model fields and defaults for every
family (vision, trajectory, dense, MoE, ssm, hybrid, audio, VLM).  The
registry lists every architecture of the reference (``load_all``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.sharding.rules import torch_dtype


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. Covers dense / MoE / SSM / hybrid / enc-dec / VLM,
    and the paper's vision and trajectory models."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | vision | trajectory
    num_layers: int
    d_model: int  # vision: base channel width
    vocab_size: int  # vision: number of classes
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, ...] = ()  # Qwen2-VL M-RoPE (t, h, w) splits
    sliding_window: int = 0  # 0 = full attention; >0 = ring-buffer cache
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (d_ff used for shared/dense)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0  # mamba2 value heads; 0 -> derived
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    attn_every: int = 0  # hybrid: shared attention block every k layers
    # --- enc-dec (whisper) ----------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0  # frames after the (stubbed) conv frontend
    # --- misc -----------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""  # "" = activation dtype; "int8" = quantized cache
    expert_dtype: str = ""  # "" = param dtype; "int8" = quantized expert weights
    source: str = ""  # citation

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def reduced(self) -> "ModelConfig":
        """Reduced variant for CPU tests, the reference's ``reduced()`` (2
        layers, d_model <= 256, <= 4 experts; the hybrid keeps 4 layers)."""
        changes = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=32,
            ssm_heads=0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )
        if self.is_moe:
            changes.update(
                num_experts=min(self.num_experts, 4),
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_d_ff=min(self.moe_d_ff or self.d_ff, 128),
            )
        if self.encoder_layers:
            changes.update(encoder_layers=2, encoder_seq=64)
        if self.attn_every:
            changes.update(attn_every=2, num_layers=4)
        return dataclasses.replace(self, **changes)

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
    # scenario engine (scenarios/): trace-based mobility + channels
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
    # scenario backend: "numpy" keeps the oracle kinematics on the host;
    # "jax" (the reference's name, kept so that a configuration means the
    # same in both packages) builds the whole schedule device-resident,
    # here with the torch engine (scenarios/torch_kinematics.py) on the
    # run's device.  The round consumes the same (zeta, tau, h2) either way
    scenario_backend: str = "numpy"
    # per-client system heterogeneity (scenarios/heterogeneity.py):
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
    # telemetry (repro_torch/telemetry, as the reference's): the metric
    # registry; the per-device flight recorder and the theory probes each
    # upgrade it to a TelemetrySuite (core/runner.py::resolve_telemetry)
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
    """Import every config module (they self-register)."""
    import importlib

    for mod in ("resnet9_cifar10", "lanegcn_argoverse", "llama3_2_3b",
                "mamba2_2_7b", "internlm2_1_8b", "qwen2_7b", "qwen3_32b",
                "qwen2_moe_a2_7b", "qwen3_moe_30b_a3b", "zamba2_7b",
                "whisper_large_v3", "qwen2_vl_72b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
