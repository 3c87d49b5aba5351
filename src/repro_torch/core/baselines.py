"""§VI-B benchmark policies, all running on the Algorithm-1 engine.

1. SFL-Spar   — synchronous FL with sparsification: no local training during
                inter-contact; gradient computed only at contact rounds.
2. AFL        — FedAsync [11]: continuous local training, FULL uploads
                (all-or-nothing: fails when s(u+log2 s) > tau*A), energy-capped.
3. AFL-Spar   — Algorithm 1 with contact-window-filling top-k at fixed max
                power, energy-capped (consumes the budget then stops).
4. FedMobile  — [16]: relaying boosts contact opportunities (schedule-level
                transform: a non-contact device relays through a contacted
                neighbour with probability p_relay, at halved effective
                contact time for the two-hop path); FULL uploads.
5. Optimal    — MADS structure without energy constraints (max feasible
                power, k filling the window) — the paper's upper benchmark.
6. MADS       — the proposed controller (Propositions 1-2 + queues).

Compression-codec policies (beyond-paper; compression/): all use the
MADS power controller, so ONLY the codec differs — an apples-to-apples
comparison of how the same tau*A(p) bit budget is spent:

7. MADS-joint — sparsify x quantize, (k, b) split solved in closed form
                per round (`compression.joint`).
8. fixed-kb   — static (keep-fraction, bit-width) targets clipped to the
                budget (`compression.topk.FixedKbCompressor`).
9. MADS-topk  — the Proposition-1 spend routed through the codec API
                (`compression.topk.TopKCompressor` at u=value_bits): the
                codec twin of plain MADS.
10. QSGD      — dense stochastic quantisation, bit-width from the budget
                (`compression.qsgd.QSGDCompressor`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.compression.joint import JointCompressor
from repro_torch.compression.qsgd import QSGDCompressor
from repro_torch.compression.topk import FixedKbCompressor, TopKCompressor
from repro_torch.core.afl import Policy, StalenessWeight
from repro_torch.core.mads import MadsController


def _staleness(fl) -> StalenessWeight:
    """The FLConfig-selected alpha * s(delta_tau) aggregation discount.

    Every policy factory threads this through ``Policy.staleness``; the
    default (constant, alpha=1) is the identity."""
    return StalenessWeight(
        family=fl.staleness_family,
        alpha=fl.staleness_alpha,
        hinge_a=fl.staleness_hinge_a,
        hinge_b=fl.staleness_hinge_b,
        poly_a=fl.staleness_poly_a,
    )


def _controller(s: int, fl, **kw) -> MadsController:
    return MadsController(
        s=s,
        u=fl.value_bits,
        bandwidth=fl.bandwidth,
        noise_w_hz=10 ** (fl.noise_dbm_hz / 10.0) / 1000.0,
        p_max=fl.max_power,
        v_weight=fl.lyapunov_v,
        **kw,
    )


def mads(s: int, fl) -> Policy:
    return Policy(name="mads", controller=_controller(s, fl),
                  staleness=_staleness(fl))


def optimal(s: int, fl) -> Policy:
    return Policy(
        name="optimal",
        staleness=_staleness(fl),
        controller=_controller(s, fl, energy_unconstrained=True),
    )


def afl_spar(s: int, fl) -> Policy:
    return Policy(
        name="afl-spar",
        staleness=_staleness(fl),
        controller=_controller(s, fl),
        fixed_power=fl.max_power,
        energy_capped=True,
    )


def fedasync(s: int, fl) -> Policy:
    return Policy(
        name="afl",
        staleness=_staleness(fl),
        controller=_controller(s, fl),
        sparsify=False,
        error_feedback=False,
        fixed_power=fl.max_power,
        energy_capped=True,
    )


def sfl_spar(s: int, fl) -> Policy:
    return Policy(
        name="sfl-spar",
        staleness=_staleness(fl),
        controller=_controller(s, fl),
        fixed_power=fl.max_power,
        local_updates=False,
        train_every_round=False,
        energy_capped=True,
    )


def fedmobile(s: int, fl) -> Policy:
    # FedMobile = FedAsync + relays; the relay boost is applied to the
    # (zeta, tau) schedule by ``apply_relays`` below.
    return Policy(
        name="fedmobile",
        staleness=_staleness(fl),
        controller=_controller(s, fl),
        sparsify=False,
        error_feedback=False,
        fixed_power=fl.max_power,
        energy_capped=True,
    )


def apply_relays(zeta: np.ndarray, tau: np.ndarray, p_relay: float = 0.3,
                 seed: int = 0):
    """FedMobile schedule transform: a device not in contact may relay its
    update through some contacted device (if any exists that round)."""
    rng = np.random.default_rng(seed)
    zeta = zeta.copy()
    tau = tau.copy()
    rounds, n = zeta.shape
    for r in range(rounds):
        direct = np.flatnonzero(zeta[r])
        if len(direct) == 0:
            continue
        for d in np.flatnonzero(zeta[r] == 0):
            if rng.random() < p_relay:
                helper = rng.choice(direct)
                zeta[r, d] = 1
                tau[r, d] = 0.5 * tau[r, helper]  # two-hop halves the window
    return zeta, tau


def mads_joint(s: int, fl) -> Policy:
    """MADS power + the closed-form joint (k, b) codec; per-leaf (k_l, b_l)
    pairs when ``fl.per_layer_budget`` is set."""
    return Policy(
        name="mads-joint",
        staleness=_staleness(fl),
        controller=_controller(s, fl),
        compressor=JointCompressor(
            s=s, method=fl.sparsifier, sample=fl.sample_size,
            b_grid=tuple(range(fl.compress_b_min, fl.compress_b_max + 1)),
            per_layer=fl.per_layer_budget,
        ),
    )


def mads_topk(s: int, fl) -> Policy:
    """MADS power + the top-k codec at the paper's value width.

    The codec twin of plain ``mads``: identical spend (Proposition 1 at
    u = fl.value_bits) but routed through the ``Compressor`` API."""
    return Policy(
        name="mads-topk",
        staleness=_staleness(fl),
        controller=_controller(s, fl),
        compressor=TopKCompressor(
            s=s, method=fl.sparsifier, sample=fl.sample_size,
            u=fl.value_bits,
        ),
    )


def fixed_kb(s: int, fl) -> Policy:
    """MADS power + static (k, b) targets clipped to the contact budget."""
    return Policy(
        name="fixed-kb",
        staleness=_staleness(fl),
        controller=_controller(s, fl),
        compressor=FixedKbCompressor(
            s=s, method=fl.sparsifier, sample=fl.sample_size,
            k_frac=fl.fixed_k_frac, b=fl.fixed_bits,
        ),
    )


def qsgd(s: int, fl) -> Policy:
    """MADS power + dense stochastic quantisation (no sparsification)."""
    return Policy(
        name="qsgd",
        staleness=_staleness(fl),
        controller=_controller(s, fl),
        compressor=QSGDCompressor(
            s=s, b_min=fl.compress_b_min, b_max=fl.compress_b_max,
        ),
    )


def mads_no_ef(s: int, fl) -> Policy:
    """Ablation: MADS without the error-feedback memory (dropped residuals).

    Isolates the contribution of e_n (Stich et al. memory) to Algorithm 1 —
    under heavy sparsification the dropped-coordinate mass is lost forever
    without it, degrading convergence."""
    return Policy(
        name="mads-noef",
        staleness=_staleness(fl), controller=_controller(s, fl), error_feedback=False
    )


ALL = {
    "mads": mads,
    "optimal": optimal,
    "afl-spar": afl_spar,
    "afl": fedasync,
    "sfl-spar": sfl_spar,
    "fedmobile": fedmobile,
    "mads-noef": mads_no_ef,
    "mads-joint": mads_joint,
    "mads-topk": mads_topk,
    "fixed-kb": fixed_kb,
    "qsgd": qsgd,
}
