"""Closed-form theory from the paper (Lemmas 2-4, Theorems 1-2, Corollary 1).

These are the quantities the experiments validate against:
* ``staleness_second_moment`` — Lemma 2's Theta_n bound,
* ``gamma`` — Lemma 3's sparsification-survival factor,
* ``theorem1_rhs`` / ``theorem2_rhs`` — the convergence bounds,
* ``corollary1_bound(v)`` — the U-shaped speed curve (Remark 3).

Everything is plain numpy so benchmarks can sweep parameters cheaply; the
module is the reference's ``repro/core/theory.py`` unchanged, so both
packages give equal values.
"""
from __future__ import annotations

import numpy as np


def staleness_second_moment(c: float, lam: float, delta: float) -> float:
    """Lemma 2: E[(theta_n)^2] <= Theta_n.

    Theta = 1 + lam/(lam+c) * (e^{-4d/l} - 3 e^{-3d/l} + 4 e^{-2d/l})
                              / (1 - 2 e^{-d/l} + e^{-2d/l}).
    """
    x = np.exp(-delta / lam)
    num = x**4 - 3 * x**3 + 4 * x**2
    den = max((1 - x) ** 2, 1e-12)
    return 1.0 + (lam / (lam + c)) * num / den


def gamma(rate: float, c: float, s: int, u: int = 32) -> float:
    """Lemma 3 as written: gamma_n = exp(-(u + log2 s) / (A_n c_n)).

    NOTE (EXPERIMENTS.md §Paper-validation): with realistic rates this is
    ~1 - 1e-5 and the resulting (1-gamma)||x||^2 UNDER-estimates the true
    sparsification error whenever the contact window cannot carry the whole
    model — the appendix's final inequality is loose in the wrong direction
    for gamma -> 1.  Use ``gamma_model`` for quantitative work.
    """
    return float(np.exp(-(u + np.log2(max(s, 2))) / max(rate * c, 1e-12)))


def gamma_model(rate: float, c: float, s: int, u: int = 32) -> float:
    """Full-model form: probability the window carries ALL s coordinates,
    gamma_model = exp(-s (u + log2 s)/(A c)).  This is the variant that
    reproduces the paper's U-shaped speed curve at vehicular speeds."""
    bits = s * (u + np.log2(max(s, 2)))
    return float(np.exp(-min(bits / max(rate * c, 1e-12), 700.0)))


def expected_error_fraction(rate: float, c: float, s: int, u: int = 32,
                            mc: int = 20000, seed: int = 0) -> float:
    """Monte-Carlo E[(s - k)/s] with k = min(tau A/(u+log2 s), s), the
    *correct* expected top-k residual-mass upper bound for uniform x."""
    rng = np.random.default_rng(seed)
    tau = rng.exponential(c, mc)
    k = np.minimum(tau * rate / (u + np.log2(max(s, 2))), s)
    return float(np.mean((s - k) / s))


def sparsification_error_factor(rate: float, c: float, s: int, u: int = 32) -> float:
    """Lemma 3 bound: E||x - S(x)||^2 <= (1 - gamma) ||x||^2."""
    return 1.0 - gamma(rate, c, s, u)


def local_memory_bound(rate, c, lam, delta, s, eta, g2, u: int = 32) -> float:
    """Lemma 4: E||e_n||^2 <= 4 (1 - gamma^2)/gamma^2 * Theta * eta^2 G^2."""
    gam = gamma(rate, c, s, u)
    th = staleness_second_moment(c, lam, delta)
    return 4 * (1 - gam**2) / max(gam**2, 1e-12) * th * eta**2 * g2


def theorem1_rhs(
    f0_gap: float,
    eta: float,
    big_l: float,
    g2: float,
    sigma: float,
    n: int,
    rounds: int,
    zeta: np.ndarray,  # (R, N)
    theta: np.ndarray,  # (R, N)
    k: np.ndarray,  # (R, N)
    x_norm2: np.ndarray,  # (R, N)
    s: int,
) -> float:
    """Theorem 1 upper bound on E||grad F(z^R)||^2 (round-wise, empirical)."""
    t1 = 4 * f0_gap / (eta * rounds)
    coupling = zeta * theta * (5 - 3 * k / s) * x_norm2
    t2 = 4 * big_l**2 / (n * rounds) * coupling.sum()
    t3 = 8 * eta**2 * big_l**2 * g2 / (n * rounds) * (theta**2).sum()
    t4 = 4 * eta * big_l * sigma / n
    return float(t1 + t2 + t3 + t4)


def theorem2_rhs(
    f0_gap: float,
    big_l: float,
    sigma: float,
    g2: float,
    n: int,
    rounds: int,
    rate: float,
    c: float,
    lam: float,
    delta: float,
    s: int,
    u: int = 32,
) -> float:
    """Theorem 2 bound (expectation over contact statistics)."""
    gam = max(gamma(rate, c, s, u), 1e-9)
    th = staleness_second_moment(c, lam, delta)
    t1 = 8 * big_l * f0_gap / np.sqrt(rounds)
    t2 = 2 * sigma / (n * np.sqrt(rounds))
    poly = 16 - 8 * gam - 11 * gam**2 + 6 * gam**3
    t3 = g2 / (n * rounds) * n * poly * th / gam**2  # summed over N identical devices
    return float(t1 + t2 + t3)


def corollary1_bound(
    v: float,
    f0_gap: float,
    big_l: float,
    sigma: float,
    g2: float,
    n: int,
    rounds: int,
    rate: float,
    contact_const: float,
    intercontact_const: float,
    delta: float,
    s: int,
    u: int = 32,
    gamma_mode: str = "paper",
) -> float:
    """Corollary 1: bound as a function of device speed v (c=C/v, lam=L/v).

    gamma_mode="paper" uses the literal per-element exponent (which only
    turns upward at ~1e5 m/s with Table-I constants); "model" uses the
    full-model bit cost s(u+log2 s) (see ``gamma_model``), which reproduces
    the paper's Fig. 5 U-shape at vehicular speeds.
    """
    big_c, big_l_mob = contact_const, intercontact_const
    t1 = 8 * big_l * f0_gap / np.sqrt(rounds)
    t2 = 2 * sigma / (n * np.sqrt(rounds))
    bit_cost = (u + np.log2(max(s, 2))) * (s if gamma_mode == "model" else 1.0)
    expo = np.exp(min(2 * bit_cost * v / (rate * big_c), 700.0))
    y = np.exp(-delta * v / big_l_mob)
    num = y**4 - 3 * y**3 + 4 * y**2
    den = max((1 - y) ** 2, 1e-12)
    theta_term = 1 + (big_l_mob / (big_l_mob + big_c)) * num / den
    t3 = 16 * g2 * expo / rounds * theta_term
    return float(t1 + t2 + t3)


def optimal_speed(args: dict, v_grid=None) -> float:
    """argmin_v of Corollary 1 on a grid (Remark 3's interior optimum)."""
    v_grid = v_grid if v_grid is not None else np.linspace(0.5, 60.0, 240)
    vals = [corollary1_bound(v, **args) for v in v_grid]
    return float(v_grid[int(np.argmin(vals))])
