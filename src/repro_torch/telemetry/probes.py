"""Online theory-vs-practice probes: does a run match the closed forms?

The paper's convergence story (core/theory.py) rests on three measurable
quantities MADS optimizes against:

* the **sparsification-error fraction** ``E[(s - k)/s]`` per contact
  (Lemma 3 / ``theory.expected_error_fraction``),
* the **staleness second moment** ``E[theta^2]`` at upload (Lemma 2 /
  ``theory.staleness_second_moment``),
* the **upload success rate** ``P(k >= 1)`` — Lemma 3's survival factor
  ``theory.gamma`` (for tau ~ Exp(c) and Proposition-1 spend,
  ``P(tau * A >= u + log2 s) = exp(-(u + log2 s)/(A c)) = gamma``).

``TheoryProbes`` accumulates the measured counterparts DURING the run as a
dict of scalar f32 tensors on the run's device — with the same
no-mid-run-host-sync contract as ``MetricRegistry`` — and ``report``
compares them at fetch against the closed forms, emitting per-term ``measured / expected / delta`` records
plus a Theorem-1 bound decomposition (t1..t4, from the online
``coupling_sum`` / ``theta2_all_sum`` accumulators that mirror the
round-wise sums in ``theory.theorem1_rhs``).  A run thus self-reports when
practice drifts from the theory MADS assumes — e.g. when the mobility
model's contact-time distribution stops being exponential, or a codec's
realized k diverges from the Proposition-1 spend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from repro_torch.core import theory
from repro_torch.telemetry.metrics import as_f32, to_host

#: scalar accumulators in the probe state, all merged by addition
PROBE_FIELDS = (
    "rounds",             # rounds advanced
    "contacts",           # sum okf
    "successes",          # sum success
    "err_frac_sum",       # sum over contacts of (s - k)/s
    "theta2_contact_sum",  # sum theta^2 over contacted devices (Lemma 2)
    "theta2_all_sum",     # sum theta^2 over ALL devices (Theorem 1 t3)
    "coupling_sum",       # sum okf * theta * (5 - 3k/s) * ||x||^2 (t2)
    "tau_sum",            # sum tau over contacts (measured mean c)
    "rate_sum",           # sum bits/tau over successes (measured mean A)
    "bits_sum",           # sum realized bits
)


@dataclasses.dataclass(frozen=True)
class TheoryProbes:
    """Probe spec (frozen + hashable).

    ``s`` is the model size, ``u`` the value bit-width — the same (s, u)
    the run's ``MadsController``/codec spends with, so measured and
    expected terms share one operating point.
    """

    s: int
    u: int = 32

    # -- state ---------------------------------------------------------------

    def init_state(self, device="cpu") -> dict:
        return {f: torch.zeros((), dtype=torch.float32, device=device)
                for f in PROBE_FIELDS}

    # -- update ----------------------------------------------------------------

    def update(self, state: dict, metrics: Mapping, tau) -> dict:
        """Fold one round's metric dict in.  Uses uploads/success/theta/
        k/bits plus ``x_norm2`` when present (needed only for the
        Theorem-1 coupling term)."""
        dev = state["rounds"].device
        okf = as_f32(metrics["uploads"], dev)
        succ = as_f32(metrics["success"], dev)
        theta = as_f32(metrics["theta"], dev)
        k = as_f32(metrics["k"], dev)
        bits = as_f32(metrics["bits"], dev)
        tau = as_f32(tau, dev)
        x2 = metrics.get("x_norm2")
        x2 = (as_f32(x2, dev) if x2 is not None else torch.zeros_like(theta))
        s = float(self.s)
        return {
            "rounds": state["rounds"] + 1.0,
            "contacts": state["contacts"] + torch.sum(okf),
            "successes": state["successes"] + torch.sum(succ),
            "err_frac_sum": state["err_frac_sum"]
            + torch.sum(okf * (s - k) / s),
            "theta2_contact_sum": state["theta2_contact_sum"]
            + torch.sum(okf * theta**2),
            "theta2_all_sum": state["theta2_all_sum"] + torch.sum(theta**2),
            "coupling_sum": state["coupling_sum"]
            + torch.sum(okf * theta * (5.0 - 3.0 * k / s) * x2),
            "tau_sum": state["tau_sum"] + torch.sum(okf * tau),
            "rate_sum": state["rate_sum"]
            + torch.sum(succ * bits / torch.clamp_min(tau, 1e-9)),
            "bits_sum": state["bits_sum"] + torch.sum(bits),
        }

    # -- merge ---------------------------------------------------------------

    def merge(self, a: dict, b: dict) -> dict:
        return {f: a[f] + b[f] for f in a}

    def merge_stacked(self, state: dict, axis: int = 0) -> dict:
        return {f: torch.sum(state[f], dim=axis) for f in state}

    # -- host side -----------------------------------------------------------

    def fetch(self, state: dict) -> dict:
        """Device state -> host floats, in one copy."""
        host = to_host(state)
        return {f: float(host[f]) for f in PROBE_FIELDS}

    def measured(self, snapshot: dict) -> dict:
        """Measured means from a fetched (or JSONL-loaded) probe state."""
        contacts = max(snapshot["contacts"], 1.0)
        successes = max(snapshot["successes"], 1.0)
        n_dev_rounds = max(snapshot["rounds"], 1.0)
        return {
            "error_fraction": snapshot["err_frac_sum"] / contacts,
            "staleness_second_moment":
                snapshot["theta2_contact_sum"] / contacts,
            "success_rate": snapshot["successes"]
            / max(snapshot["contacts"], 1.0),
            "mean_tau": snapshot["tau_sum"] / contacts,
            "mean_rate": snapshot["rate_sum"] / successes,
            "rounds": n_dev_rounds,
        }

    def report(self, snapshot: dict, *, c: float, lam: float, delta: float,
               rate: Optional[float] = None, f0_gap: float = 1.0,
               big_l: float = 1.0, g2: float = 1.0, sigma: float = 1.0,
               n: Optional[int] = None) -> dict:
        """Theory-vs-measured comparison at the run's operating point.

        ``c``/``lam``/``delta`` are the contact model parameters the closed
        forms assume (``contact_params(fl)`` derives them from an
        FLConfig).  ``rate`` is the link rate A (bit/s) the theory is
        evaluated at; by default the run's *measured* mean upload rate —
        the self-calibrating choice, so deltas isolate distributional
        drift rather than rate mis-specification.  The Theorem-1 terms use
        ``n`` devices (``report_from_config`` supplies ``fl.num_devices``)
        and the standard-constant defaults for (f0_gap, L, G^2, sigma).
        """
        m = self.measured(snapshot)
        rate = float(rate) if rate else max(m["mean_rate"], 1.0)
        terms = {}

        expected_err = theory.expected_error_fraction(rate, c, self.s,
                                                      self.u)
        terms["error_fraction"] = _term(m["error_fraction"], expected_err)

        bound_theta2 = theory.staleness_second_moment(c, lam, delta)
        terms["staleness_second_moment"] = _term(
            m["staleness_second_moment"], bound_theta2)

        gam = theory.gamma(rate, c, self.s, self.u)
        terms["success_rate"] = _term(m["success_rate"], gam)

        # Theorem-1 bound decomposition from the online accumulators
        rounds = max(snapshot["rounds"], 1.0)
        n = max(int(n), 1) if n is not None else 1
        eta_ref = 1.0 / (big_l * math.sqrt(rounds))  # Theorem-2 step size
        t1 = 4.0 * f0_gap / (eta_ref * rounds)
        t2 = 4.0 * big_l**2 / (n * rounds) * snapshot["coupling_sum"]
        t3 = (8.0 * eta_ref**2 * big_l**2 * g2 / (n * rounds)
              * snapshot["theta2_all_sum"])
        t4 = 4.0 * eta_ref * big_l * sigma / n
        theorem1 = {
            "t1_init_gap": t1,
            "t2_sparsify_staleness_coupling": t2,
            "t3_staleness_sq": t3,
            "t4_grad_noise": t4,
            "total": t1 + t2 + t3 + t4,
        }
        return {
            "s": self.s, "u": self.u, "c": c, "lam": lam, "delta": delta,
            "rate": rate, "terms": terms, "theorem1": theorem1,
            "measured": m,
        }

    def summary(self, report: dict) -> str:
        """Terminal theory-vs-measured table from a ``report`` dict."""
        lines = [f"{'probe':<26s} {'measured':>12s} {'expected':>12s} "
                 f"{'delta':>12s} {'rel':>8s}"]
        for name, t in report["terms"].items():
            lines.append(
                f"{name:<26s} {t['measured']:>12.4g} {t['expected']:>12.4g} "
                f"{t['delta']:>+12.4g} {t['rel']:>+8.1%}"
            )
        th = report["theorem1"]
        lines.append("theorem1 bound decomposition: "
                     + "  ".join(f"{k}={v:.4g}" for k, v in th.items()))
        return "\n".join(lines)


def _term(measured: float, expected: float) -> dict:
    return {
        "measured": float(measured),
        "expected": float(expected),
        "delta": float(measured - expected),
        "rel": float((measured - expected) / expected) if expected else
        float("inf"),
    }


def contact_params(fl) -> tuple[float, float, float]:
    """(c, lam, delta) the closed forms assume, from an FLConfig — the
    same speed scaling ``ContactProcess.from_speed`` applies."""
    if fl.speed > 0:
        v = max(fl.speed, 1e-6)
        return fl.contact_const / v, fl.intercontact_const / v, \
            fl.round_duration
    return fl.mean_contact, fl.mean_intercontact, fl.round_duration


def report_from_config(probes: TheoryProbes, snapshot: dict, fl,
                       **kw) -> dict:
    """``TheoryProbes.report`` with (c, lam, delta, n) read off an
    FLConfig — the one-liner the launch layer calls."""
    c, lam, delta = contact_params(fl)
    kw.setdefault("n", fl.num_devices)
    return probes.report(snapshot, c=c, lam=lam, delta=delta, **kw)


def probes_to_jsonable(snapshot: Optional[dict]) -> Optional[dict]:
    if snapshot is None:
        return None
    return {f: float(v) for f, v in snapshot.items()}


__all__ = [
    "PROBE_FIELDS",
    "TheoryProbes",
    "contact_params",
    "probes_to_jsonable",
    "report_from_config",
]
