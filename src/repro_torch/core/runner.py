"""Simulation runner: wires data, mobility, channel, and the AFL engine.

Build a federation, pick a policy (MADS or a §VI-B baseline), run R
rounds, record metrics + periodic global-model evaluation.  This is the
reference's loop engine (one ``afl_round`` per round), with its telemetry
(``repro_torch.telemetry``: recorded on the run's device each round,
fetched once at the end) and phase tracing; ``engine="scan"`` hands the
run to the whole-run engine (``experiments/scan_engine.py``: on CUDA the
round captured once as a CUDA graph and replayed).
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from repro_torch.channel import WirelessChannel
from repro_torch.core import baselines as BL
from repro_torch.core.afl import AflState, afl_init, afl_round
from repro_torch.scenarios import ScenarioProvider
from repro_torch.telemetry import (AFL_REGISTRY, HIST_KEYS, DeviceTable,
                                   TelemetrySuite, TheoryProbes, record_het,
                                   record_round)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.runner")

__all__ = ["HIST_KEYS", "RunResult", "resolve_telemetry", "run_afl"]


@dataclasses.dataclass
class RunResult:
    policy: str
    history: dict  # lists per metric
    final_eval: float
    state: AflState
    # host wall clock of each round, ending in the metrics' copy to the
    # host (which waits for the device); eval time is not included
    round_seconds: list
    # fetched MetricRegistry snapshot, or a TelemetrySuite's sectioned
    # {"metrics"/"device"/"probes"} snapshot when the suite knobs are on
    telemetry: Optional[dict] = None
    # the whole-run engine's seconds per eval, apart from the rounds
    eval_seconds: Optional[list] = None


def resolve_telemetry(fl, telemetry, s: int = 0):
    """The run's telemetry: an explicit registry/suite wins; otherwise the
    FLConfig knobs decide — ``telemetry`` alone turns on the built-in AFL
    registry, and ``telemetry_perdevice`` / ``telemetry_probes`` upgrade
    it to a ``TelemetrySuite`` carrying the per-device flight recorder
    and/or the theory probes alongside the registry.

    ``s`` is the model size (``model.num_params()``): the probes compare
    measured error/staleness/success against the closed forms at that
    (s, u) operating point.
    """
    if telemetry is not None:
        return telemetry
    want_dev = fl.telemetry_perdevice
    want_probes = fl.telemetry_probes and s > 0
    if want_dev or want_probes:
        return TelemetrySuite(
            metrics=AFL_REGISTRY,
            device=DeviceTable(fl.num_devices) if want_dev else None,
            probes=(TheoryProbes(s=s, u=fl.value_bits)
                    if want_probes else None),
        )
    return AFL_REGISTRY if fl.telemetry else None


def make_eval_fn(model, cfg):
    """Family-appropriate eval metric over a params tree: accuracy for
    vision (higher is better), ADE for trajectory and the LM loss for the
    language families (lower is better; the value of ``model.loss_fn``)."""
    if cfg.family == "vision":
        from repro_torch.models.resnet import accuracy

        return lambda p, b: accuracy(p, cfg, b)
    if cfg.family == "trajectory":
        from repro_torch.models.lanegcn import ade, forward

        def f(p, b):
            pred, _ = forward(p, cfg, b["past"], b["lanes"])
            return ade(pred, b["future"])

        return f
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.layers import cross_entropy

        def lm_loss(p, b):
            # ``loss_fn`` (no aux loss in these families) through the
            # inference forward: its Mamba2 layers keep the CUDA ssd_scan
            # (``loss_fn`` trains through the chunked formula)
            logits, _ = model.forward(p, cfg, b["tokens"])
            return cross_entropy(logits, b["labels"])

        return lm_loss
    return lambda p, b: model.loss_fn(p, cfg, b)


def evaluate(model, cfg, w_flat, eval_batch) -> float:
    """Eval metric of the flat global model ``w_flat`` (s,)."""
    with torch.no_grad():
        return float(make_eval_fn(model, cfg)(model.layout.unflatten(w_flat),
                                              eval_batch))


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def build_provider(fl, policy_name: str, schedule, rounds: int,
                   seed: int, device="cuda") -> ScenarioProvider:
    """Resolve ``schedule`` (None, a ScenarioProvider, or (zeta, tau)[+h2]
    arrays) into a ScenarioProvider; applies FedMobile's relay rewrite.

    ``device`` is where a device-resident scenario build runs
    (``fl.scenario_backend="jax"``)."""
    if schedule is None:
        provider = ScenarioProvider.from_config(fl, rounds, seed, device)
    elif isinstance(schedule, ScenarioProvider):
        provider = schedule
    else:  # (zeta, tau) [+ h2] arrays; without h2: i.i.d. gains
        chan = WirelessChannel(
            bandwidth=fl.bandwidth, carrier_ghz=fl.carrier_ghz,
            noise_dbm_hz=fl.noise_dbm_hz, seed=seed + 1,
        )
        provider = ScenarioProvider.from_arrays(*schedule, channel=chan)
    if policy_name == "fedmobile":
        # the relay rewrite is host code: a device-resident schedule is
        # brought to the host first
        zeta, tau, h2 = map(_host, provider.schedule())
        zeta, tau = BL.apply_relays(zeta, tau, seed=seed)
        provider = ScenarioProvider.from_arrays(zeta, tau, h2=h2)
    return provider


def sample_budgets(fl, seed: int) -> np.ndarray:
    """Per-device energy budgets E_n^con, (N,) float32."""
    rng_np = np.random.default_rng(seed + 2)
    return rng_np.uniform(*fl.energy_budget, fl.num_devices).astype(np.float32)


def _on(device, arrays: dict) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}


def _round_batch(loader, r: int, shard_key, device) -> dict:
    """One stacked (N, B, ...) batch on ``device``: a ``DataShard`` draws
    round r's batch on its own device (the whole-run engine draws the
    same), a ``DeviceLoader`` is copied over."""
    if shard_key is not None:
        return loader.traced_batch(shard_key, r)
    return _on(device, loader.sample_all())


def het_masks(telemetry, provider, device):
    """The heterogeneity loss masks, (rounds, N) f32 on ``device``, when a
    per-device table records them (else None): brought to the device once,
    before round 0, so that no round copies them over."""
    if not (isinstance(telemetry, TelemetrySuite)
            and telemetry.device is not None) or provider.aux is None:
        return None
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
            for k, v in provider.aux.items()}


def run_afl(
    model,
    cfg,
    fl,
    policy_name: str,
    loader,
    eval_batch,
    rounds: Optional[int] = None,
    eval_every: int = 20,
    seed: Optional[int] = None,
    schedule=None,
    log_progress: bool = False,
    engine: str = "loop",
    device="cuda",
    params=None,
    telemetry=None,
    tracer=None,
) -> RunResult:
    """Run ``rounds`` AFL rounds of ``policy_name`` on ``device``.

    ``params`` (a tree of tensors) replaces the seeded initial model.
    ``telemetry`` (a registry or suite; by default from the FLConfig knobs,
    ``resolve_telemetry``) is recorded on ``device`` inside each round and
    fetched once at the end into ``RunResult.telemetry``.  ``tracer`` (a
    ``PhaseTracer``) times each round under the span ``compile`` (round 0,
    which pays kernel loading and cuDNN autotuning) or ``execute``, and
    each evaluation under ``eval``.  ``loader`` is a ``DeviceLoader`` or a
    ``DataShard`` on ``device``.

    ``engine="scan"`` runs the whole-run engine instead
    (``experiments.scan_engine.run_afl_scanned``, with the same arguments).
    """
    rounds = rounds or fl.rounds
    seed = fl.seed if seed is None else seed
    s = model.num_params()
    telemetry = resolve_telemetry(fl, telemetry, s=s)
    if engine == "scan":
        from repro_torch.experiments.scan_engine import run_afl_scanned

        return run_afl_scanned(
            model, cfg, fl, policy_name, loader, eval_batch, rounds=rounds,
            eval_every=eval_every, seed=seed, schedule=schedule,
            log_progress=log_progress, telemetry=telemetry, tracer=tracer,
            device=device, params=params)
    if engine != "loop":
        raise ValueError(f"unknown engine {engine!r}; known: loop, scan")
    device = resolve_device(device)
    policy = BL.ALL[policy_name](s, fl)
    provider = build_provider(fl, policy_name, schedule, rounds, seed, device)
    budgets = torch.as_tensor(sample_budgets(fl, seed), device=device)

    state = afl_init(model, fl, seed, device, params=params)
    eval_batch = _on(device, eval_batch)
    hist: dict = {k: [] for k in HIST_KEYS}
    tstate = telemetry.init_state(device) if telemetry is not None else None
    het = het_masks(telemetry, provider, device)
    span = tracer.span if tracer is not None else (
        lambda name, **kw: nullcontext())
    tot_uploads = tot_k = tot_power = tot_theta = tot_bits = 0.0
    n = fl.num_devices
    round_seconds = []
    shard_key = loader.seed_key(seed) if hasattr(loader, "seed_key") else None
    for r in range(rounds):
        t0 = time.perf_counter()
        batch = _round_batch(loader, r, shard_key, device)
        zeta_r, tau_r, h2_r = provider.round(r)
        tau_dev = torch.as_tensor(tau_r, dtype=torch.float32, device=device)
        with span("compile" if r == 0 else "execute"):
            state, m = afl_round(
                state, batch, torch.as_tensor(zeta_r, device=device), tau_dev,
                torch.as_tensor(h2_r, dtype=torch.float32, device=device),
                budgets, model=model, fl=fl, policy=policy,
            )
            if telemetry is not None:
                tstate = record_round(telemetry, tstate, m, tau_dev)
                tstate = record_het(telemetry, tstate, None if het is None
                                    else {k: v[r] for k, v in het.items()})
            # the round's one wait for the device
            sums = torch.stack([m[k].sum() for k in (
                "success", "k", "power", "theta", "bits")]).tolist()
            if tracer is not None:
                tracer.fence(m)
        round_seconds.append(time.perf_counter() - t0)
        tot_uploads += sums[0]
        tot_k += sums[1]
        tot_power += sums[2]
        tot_theta += sums[3]
        tot_bits += sums[4]
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            with span("eval"):
                ev = evaluate(model, cfg, state.w, eval_batch)
            hist["round"].append(r + 1)
            hist["eval"].append(ev)
            hist["uploads"].append(tot_uploads)  # cumulative
            hist["k_mean"].append(tot_k / max(tot_uploads, 1.0))
            hist["energy"].append(float(state.energy.sum()))
            hist["theta_mean"].append(tot_theta / ((r + 1) * n))
            hist["power_mean"].append(tot_power / max(tot_uploads, 1.0))
            hist["bits_mean"].append(tot_bits / max(tot_uploads, 1.0))
            if log_progress:
                log.info(
                    "policy=%s r=%d eval=%.4f uploads=%.0f k=%.0f E=%.0fJ",
                    policy_name, r + 1, ev, hist["uploads"][-1],
                    hist["k_mean"][-1], hist["energy"][-1],
                )
    snapshot = telemetry.fetch(tstate) if telemetry is not None else None
    return RunResult(policy_name, hist, hist["eval"][-1], state, round_seconds,
                     telemetry=snapshot)
