"""Whole-run AFL engine: the round captured once as a CUDA graph, replayed.

``core/runner.py::run_afl`` (the loop engine) issues every round op by op
from Python, copies each round's batch and scenario row to the card and
reads its metric sums back.  Here everything a run of R rounds reads is on
the run's device before round 0, and on CUDA the round is captured once as
a CUDA graph and replayed: the counterpart of the reference's whole run
as one compiled ``lax.scan`` program.

* The scenario schedule (zeta, tau, h2 from ``ScenarioProvider.schedule``),
  the heterogeneity masks, the energy budgets and the codecs' dither seeds
  (drawn for the whole run before it starts, row by row, with the loop
  engine's generator calls) are (R, N) tensors on the device.  The round
  reads row r through the round counter on the device (``AflState.rnd``, a
  0-dim int32 tensor), which it advances.
* Minibatches come from a device-resident ``DataShard`` (round r's batch a
  pure function of (key, r), drawn on the device) or from a prestacked
  (R, N, B, ...) tensor of ``DeviceLoader`` draws (exact loader parity).
* The round writes the new federation state, the telemetry state and the
  f32 run totals (uploads, k, power, theta, bits) into static buffers with
  ``copy_``: the initial state's own buffers, advanced in place.
* Eval runs eagerly at the reference's segment boundaries
  (``eval_points``) on the static state; the history stays on the device
  and is fetched once, at the end.

On CUDA, round 0 runs eagerly on a side stream (the warm-up: it loads the
kernels, fills the constant caches and lets cuDNN pick its algorithms),
then the round is captured and replayed for rounds 1 to R - 1.  A capture
that fails raises: there is no eager fallback on the card.  Replays and
evals run under ``torch.cuda.set_sync_debug_mode("error")``, so a host
sync anywhere in them raises.  The kernels' launch counts are host
bookkeeping that a replay does not touch: the counts seen while capturing
are taken back and added once per replay.  On the CPU (the tests) the
same round runs eagerly, round by round, on the same device-side inputs.

``run_afl_scanned`` is metric-equivalent to the loop runner on the same
seeds (tests/test_torch_experiments.py); it and the seed batch
(``batch.py``) are one-seed and S-seed calls of ``run_seeds``.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.compression import quant as Q
from repro_torch.core import baselines as BL
from repro_torch.core.afl import AflState, afl_init, afl_round
from repro_torch.core.runner import (RunResult, build_provider, het_masks,
                                     make_eval_fn, resolve_telemetry,
                                     sample_budgets)
from repro_torch.experiments.grid import engine_fl, engine_policy
from repro_torch.kernels import sparsify_ef as K
from repro_torch.telemetry import HIST_KEYS, record_het, record_round
from repro_torch.utils.device import resolve_device
from repro_torch.utils.fmath import div
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.scan_engine")

# per-round metric sums carried through a run, in this order
TOTALS = ("success", "k", "power", "theta", "bits")


def _no_span(name, **kw):
    return nullcontext()


def _row(a: torch.Tensor, r) -> torch.Tensor:
    """Row r of ``a`` (R, ...): ``r`` a Python int or a 0-dim integer
    tensor on ``a``'s device (read on the device, no host sync)."""
    if isinstance(r, int):
        return a[r]
    return a.index_select(0, r.reshape(1).to(torch.int64))[0]


# ---------------------------------------------------------------------------
# Batch sources
# ---------------------------------------------------------------------------


class DataShard:
    """Device-resident federation data with on-device minibatch sampling.

    Per-device arrays are wrap-padded to a rectangular (N, M, ...) block and
    copied to ``device`` once; round r's stacked (N, B, ...) minibatch is a
    per-device gather at indices drawn on the device, so sampling needs no
    host work inside a run (and the loop runner draws the same batches
    through ``traced_batch`` for engine-equivalence tests).

    Sampling is uniform with replacement over each device's true row count
    (padding rows are never drawn), unlike ``DeviceLoader``'s
    epoch-permutation semantics: both are unbiased samplers of D_n.  The
    draw is a counter hash, not the reference's ``jax.random``: slot j of
    device n in round r under key k takes row ``floor(h * count_n / 2^32)``
    with ``h = lowbias32(lowbias32(k, r), n B + j)``
    (``compression/quant.py``), the same on the CPU and the card.
    """

    def __init__(self, device_arrays: list[dict], batch_size: int,
                 seed: int = 0, device="cuda"):
        counts = np.array(
            [len(next(iter(d.values()))) for d in device_arrays], np.int64)
        m = int(counts.max())
        self.device = torch.device(device)
        self.data = {
            k: torch.as_tensor(np.stack([
                np.resize(d[k], (m,) + d[k].shape[1:]) for d in device_arrays
            ])).to(self.device)
            for k in device_arrays[0]
        }
        self.counts = torch.as_tensor(counts).to(self.device)
        self.num_devices = len(device_arrays)
        self.batch_size = batch_size
        self.seed = seed
        n, b = self.num_devices, batch_size
        self._slots = torch.arange(n * b, device=self.device).view(n, b)
        self._rows = torch.arange(n, device=self.device)[:, None]

    def __len__(self):
        return self.num_devices

    def seed_key(self, seed: int) -> torch.Tensor:
        """Independent sampling stream for one grid seed: a 0-dim int64
        key on the shard's device."""
        return Q.lowbias32(torch.tensor(int(seed)), self.seed).to(self.device)

    def traced_batch(self, key, r) -> dict:
        """(N, B, ...) minibatch for round r (an int, or a 0-dim integer
        tensor on the shard's device) under ``key``; an (S,) stack of keys
        gives S seeds' batches as (S N, B, ...) rows, seed by seed."""
        keys = key.reshape(-1)
        h = Q.lowbias32(Q.lowbias32(keys, r)[:, None, None], self._slots[None])
        idx = (h * self.counts[None, :, None]) >> 32  # (S, N, B)
        return {k: v[self._rows, idx].flatten(0, 1)
                for k, v in self.data.items()}


def prestack_batches(loader, rounds: int, device="cuda") -> dict:
    """Materialise ``rounds`` DeviceLoader draws as (rounds, N, B, ...)
    tensors on ``device``: exact loader parity for engine-equivalence
    runs."""
    rows = [loader.sample_all() for _ in range(rounds)]
    return {k: torch.as_tensor(np.stack([row[k] for row in rows])).to(device)
            for k in rows[0]}


def _prestacked_sampler(ctx: dict, r) -> dict:
    return {k: _row(v, r) for k, v in ctx.items()}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def eval_points(rounds: int, eval_every: int) -> list[int]:
    """1-based round indices at which the loop runner evaluates."""
    pts = [r for r in range(eval_every, rounds + 1, eval_every)]
    if not pts or pts[-1] != rounds:
        pts.append(rounds)
    return pts


class _Stopwatch:
    """Seconds per round and per eval, laps of one timeline: CUDA events
    on the card (read once the card is idle), the host clock on the CPU.
    Each lap runs from the previous lap's end, so host gaps between
    replays count in the round after them.  ``note`` adds a host-clock
    reading."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = {"round": [], "eval": []}
        self._last = None

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        self._last = self._now()

    def lap(self, kind: str) -> None:
        now = self._now()
        self.marks[kind].append((self._last, now))
        self._last = now

    def note(self, kind: str, seconds: float) -> None:
        self.marks[kind].append(seconds)

    def seconds(self, kind: str) -> list:
        out = []
        for m in self.marks[kind]:
            if isinstance(m, float):
                out.append(m)
            elif self.cuda:
                out.append(m[0].elapsed_time(m[1]) / 1e3)
            else:
                out.append(m[1] - m[0])
        return out


@contextmanager
def _no_sync(device: torch.device):
    """Raise on any host sync with the card inside the block."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _copy_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


_STATE_TENSORS = ("w", "w_n", "g_n", "e_n", "kappa", "q", "energy", "rnd")


def _capture(body: Callable, device: torch.device):
    """Run ``body`` (round 0) eagerly on a side stream, then capture it as
    a CUDA graph: (the graph's replay, the kernel launches one replay
    runs).  The launches counted while capturing are taken back: nothing
    ran."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(K.LAUNCHES)
    with torch.cuda.graph(graph):
        body()
    launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    K.LAUNCHES.update(before)
    return graph.replay, launched


def make_run_fn(model, cfg, fl, policy, *, rounds: int, eval_every: int,
                sampler: Callable, telemetry=None):
    """A function running a whole AFL experiment on the state's device.

    Returns ``run(state0, zeta, tau, h2, budgets, eval_batch, sample_ctx,
    tstates, het, seeds=None, span=...) -> (state, hist, tstates, watch)``:
    ``hist`` is an (evals, G, 7) device tensor of the loop runner's history
    keys but "round" (``HIST_KEYS[1:]``, per eval point and seed group) and
    ``watch`` the per-round and per-eval clock (read once the card is
    idle).  ``sampler(sample_ctx, r)`` yields round r's stacked minibatch:
    ``DataShard.traced_batch`` with a key, or ``_prestacked_sampler`` with
    a dict of (R, ...) tensors.

    ``state0`` is advanced in place (its buffers are the round's static
    state); a (G, s) global model runs G seed groups of N =
    ``fl.num_devices`` devices each, whose per-device inputs (``zeta``,
    ``tau``, ``h2``, ``het``'s masks and the (R, G N) int32 dither
    ``seeds`` of a codec policy) are stacked along the device axis, and
    ``tstates`` holds one telemetry state per group (``[]`` without
    telemetry), updated in place.  ``het`` is the scenario's heterogeneity
    masks, (R, G N) each, or ``{}``.  ``span`` opens the ``capture`` (on
    CUDA) and ``run`` phases.
    """
    n = fl.num_devices
    eval_fn = make_eval_fn(model, cfg)
    pts = set(eval_points(rounds, eval_every))

    def run(state0, zeta, tau, h2, budgets, eval_batch, sample_ctx, tstates,
            het, seeds=None, span=_no_span):
        dev = state0.w.device
        groups = state0.w.numel() // state0.w_n.shape[-1]
        st = state0
        if not isinstance(st.rnd, torch.Tensor):
            st = dataclasses.replace(st, rnd=torch.tensor(
                st.rnd, dtype=torch.int32).to(dev))
        tot = torch.zeros(groups, len(TOTALS), dtype=torch.float32,
                          device=dev)
        hist, watch = [], _Stopwatch(dev)

        def body():
            zeta_r, tau_r = _row(zeta, st.rnd), _row(tau, st.rnd)
            new, m = afl_round(
                st, sampler(sample_ctx, st.rnd), zeta_r, tau_r,
                _row(h2, st.rnd), budgets, model=model, fl=fl, policy=policy,
                seeds=None if seeds is None else _row(seeds, st.rnd))
            het_r = {k: _row(v, st.rnd) for k, v in het.items()}
            for g, ts in enumerate(tstates):
                rows = slice(g * n, (g + 1) * n)
                ts_new = record_round(telemetry, ts,
                                      {k: v[rows] for k, v in m.items()},
                                      tau_r[rows])
                ts_new = record_het(telemetry, ts_new, {
                    k: v[rows] for k, v in het_r.items()} if het else None)
                _copy_into(ts, ts_new)
            tot.add_(torch.stack([m[k].view(groups, n).sum(1)
                                  for k in TOTALS], dim=1))
            for f in _STATE_TENSORS:
                getattr(st, f).copy_(getattr(new, f))

        def evaluate(stop: int):
            with torch.no_grad():
                w = st.w.view(groups, -1)
                ev = torch.stack([eval_fn(model.layout.unflatten(w[g]),
                                          eval_batch) for g in range(groups)])
            up = torch.clamp(tot[:, 0], min=1.0)
            hist.append(torch.stack([
                ev.to(torch.float32), tot[:, 0], tot[:, 1] / up,
                st.energy.view(groups, n).sum(1),
                div(tot[:, 3], float(stop * n)), tot[:, 2] / up,
                tot[:, 4] / up], dim=1))

        cuda = dev.type == "cuda"
        step, launched = body, {}
        if cuda:
            with span("capture"):
                t0 = time.perf_counter()
                step, launched = _capture(body, dev)
                torch.cuda.synchronize(dev)
                watch.note("round", time.perf_counter() - t0)
        with span("run"):
            with _no_sync(dev):
                watch.start()
                for r in range(rounds):
                    if not (cuda and r == 0):
                        step()
                        watch.lap("round")
                        for k, v in launched.items():
                            K.LAUNCHES[k] += v
                    if r + 1 in pts:
                        evaluate(r + 1)
                        watch.lap("eval")
            if cuda:
                torch.cuda.synchronize(dev)
        return st, torch.stack(hist), tstates, watch

    return run


def _run_inputs(fl, policy_name: str, policy, seeds, gens, rounds: int,
                device, schedule, telemetry):
    """Each seed's schedule (zeta, tau, h2), heterogeneity masks, energy
    budgets and (codec policies) the run's dither seeds drawn from its
    state's generator ``gens[i]`` as the loop draws them, round by round;
    stacked along the device axis on ``device``: (R, S N) rows, (S N,)
    budgets."""
    zeta, tau, h2, het, budgets, dither = [], [], [], [], [], []
    for seed, gen in zip(seeds, gens):
        provider = build_provider(fl, policy_name, schedule, rounds, seed,
                                  device)
        z, t, h = provider.schedule()
        zeta.append(torch.as_tensor(z).to(device))
        tau.append(torch.as_tensor(t).to(device=device, dtype=torch.float32))
        h2.append(torch.as_tensor(h).to(device=device, dtype=torch.float32))
        het.append(het_masks(telemetry, provider, device) or {})
        budgets.append(torch.as_tensor(sample_budgets(fl, seed)))
        if policy.compressor is not None:
            dither.append(torch.stack([
                Q.draw_seeds(gen, fl.num_devices) for _ in range(rounds)]))
    return dict(
        zeta=torch.cat(zeta, dim=1), tau=torch.cat(tau, dim=1),
        h2=torch.cat(h2, dim=1),
        het={k: torch.cat([m[k] for m in het], dim=1) for k in het[0]},
        budgets=torch.cat(budgets).to(device),
        seeds=torch.cat(dither, dim=1).to(device) if dither else None)


def fetch_history(hist_dev: torch.Tensor, rounds: int,
                  eval_every: int) -> list[dict]:
    """The (evals, G, 7) history of a run as one loop-runner history dict
    per seed group (one copy to the host)."""
    host = hist_dev.cpu().numpy()
    out = []
    for g in range(host.shape[1]):
        hist = {"round": eval_points(rounds, eval_every)}
        hist.update({k: [float(x) for x in host[:, g, i]]
                     for i, k in enumerate(HIST_KEYS[1:])})
        out.append(hist)
    return out


def _stack_states(states: list) -> AflState:
    """Single-seed states as one state of seed groups: (S, s) global
    models, (S N, s) per-device rows, seed by seed (one state as it is)."""
    if len(states) == 1:
        return states[0]
    cat = {f: torch.cat([getattr(st, f) for st in states])
           for f in ("w_n", "g_n", "e_n", "kappa", "q", "energy")}
    return AflState(w=torch.stack([st.w for st in states]), rnd=0,
                    gen=states[0].gen, **cat)


def _seed_state(state: AflState, i: int, seeds: int, gen) -> AflState:
    """Seed ``i``'s federation out of a state of ``seeds`` groups (views),
    with its own generator and a host round index."""
    n = state.w_n.shape[0] // seeds
    rows = slice(i * n, (i + 1) * n)
    return AflState(w=state.w.view(seeds, -1)[i], w_n=state.w_n[rows],
                    g_n=state.g_n[rows], e_n=state.e_n[rows],
                    kappa=state.kappa[rows],
                    q=state.q[rows], energy=state.energy[rows],
                    rnd=int(state.rnd), gen=gen)


def run_seeds(model, cfg, fl, policy_name: str, states: list, seeds: list,
              sampler: Callable, sample_ctx, eval_batch, *, rounds: int,
              eval_every: int, telemetry=None, schedule=None,
              span=_no_span) -> list[RunResult]:
    """Run the federations ``states`` (``afl_init`` of each of ``seeds``,
    on the run's device) as one run: one seed group each, every seed's
    schedule, budgets and dither seeds its own (``_run_inputs``).
    ``sample_ctx`` is the sampler's context for all of them (an (S,)
    stack of ``DataShard`` keys, or prestacked batches).  One
    ``RunResult`` per seed, its telemetry snapshot fetched on its own."""
    device = states[0].w.device
    telemetry = resolve_telemetry(fl, telemetry, s=model.num_params())
    policy = BL.ALL[policy_name](model.num_params(), fl)
    gens = [st.gen for st in states]
    inputs = _run_inputs(fl, policy_name, policy, seeds, gens, rounds,
                         device, schedule, telemetry)
    run = make_run_fn(model, cfg, engine_fl(fl), engine_policy(policy),
                      rounds=rounds, eval_every=eval_every, sampler=sampler,
                      telemetry=telemetry)
    eval_b = {k: torch.as_tensor(v).to(device) for k, v in eval_batch.items()}
    tstates = ([telemetry.init_state(device) for _ in seeds]
               if telemetry is not None else [])
    state, hist_dev, tstates, watch = run(
        _stack_states(states), inputs["zeta"], inputs["tau"], inputs["h2"],
        inputs["budgets"], eval_b, sample_ctx, tstates, inputs["het"],
        seeds=inputs["seeds"], span=span)

    with span("fetch"):
        hists = fetch_history(hist_dev, rounds, eval_every)
        snaps = ([telemetry.fetch(ts) for ts in tstates]
                 if telemetry is not None else [None] * len(seeds))
        round_s, eval_s = watch.seconds("round"), watch.seconds("eval")
        return [RunResult(policy_name, hist, hist["eval"][-1],
                          _seed_state(state, i, len(seeds), gens[i]), round_s,
                          telemetry=snaps[i], eval_seconds=eval_s)
                for i, hist in enumerate(hists)]


def run_afl_scanned(
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
    batch_mode: str = "auto",
    telemetry=None,
    tracer=None,
    device="cuda",
    params=None,
) -> RunResult:
    """Drop-in replacement for ``runner.run_afl`` running the whole
    experiment as one captured round, replayed (eagerly on the CPU).

    ``batch_mode``: "shard" samples on the device from a ``DataShard``
    (on ``device``); "prestack" materialises the DeviceLoader's exact
    draw sequence up front (or takes a dict of (rounds, N, B, ...)
    tensors); "auto" picks by loader type.  ``telemetry`` carries a
    registry or suite state through the run (fetched once at the end into
    ``RunResult.telemetry``); ``tracer`` records the capture, run and
    fetch spans.  ``params`` replaces the seeded initial model.
    ``RunResult.round_seconds``: round 0 with the warm-up and the capture
    (host clock) on the card, then each replay between CUDA events;
    ``eval_seconds`` the evals apart.
    """
    device = resolve_device(device)
    rounds = rounds or fl.rounds
    seed = fl.seed if seed is None else seed

    if batch_mode == "auto":
        batch_mode = "shard" if isinstance(loader, DataShard) else "prestack"
    if batch_mode == "shard":
        if loader.device != device:
            raise ValueError(f"the DataShard is on {loader.device}, the run "
                             f"on {device}")
        sampler, sample_ctx = loader.traced_batch, loader.seed_key(seed)
    elif batch_mode == "prestack":
        sampler = _prestacked_sampler
        sample_ctx = ({k: torch.as_tensor(v).to(device)
                       for k, v in loader.items()}
                      if isinstance(loader, dict)
                      else prestack_batches(loader, rounds, device))
    else:
        raise ValueError(f"unknown batch_mode {batch_mode!r}")

    res, = run_seeds(
        model, cfg, fl, policy_name,
        [afl_init(model, fl, seed, device, params=params)], [seed], sampler,
        sample_ctx, eval_batch, rounds=rounds, eval_every=eval_every,
        telemetry=telemetry, schedule=schedule,
        span=tracer.span if tracer is not None else _no_span)
    if log_progress:
        hist = res.history
        for i, r in enumerate(hist["round"]):
            log.info(
                "policy=%s r=%d eval=%.4f uploads=%.0f k=%.0f E=%.0fJ",
                policy_name, r, hist["eval"][i], hist["uploads"][i],
                hist["k_mean"][i], hist["energy"][i],
            )
    return res
