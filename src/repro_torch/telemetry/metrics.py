"""Device-resident metrics: counters, gauges, and fixed-bin histograms.

The accumulation state of a :class:`MetricRegistry` is a plain dict of
float32 tensors with the reference's keys, living on the run's device
(``init_state(device)``).  Every update is a handful of elementwise ops and
reductions enqueued on that device: no update copies to or from the host,
so recording adds no wait to a round.  The state is fetched ONCE at run
end (``fetch``: one device-to-host copy of every leaf) and merged across
seeds / shards (``merge`` / ``merge_stacked``).

The reference compiles the loop engine's recording step (``jit_record``);
this port has no counterpart to it and records eagerly, op by op.

Bit-identity contract: histogram bin counts and the round/contact/success
counters are sums of 0/1 weights, i.e. exact integers in float32, so
their value is independent of the reduction order; they equal the
reference's bit for bit on shared inputs.  Float-valued counters
(``bits_total``, ``energy_total``) are exact only up to reduction order.

Histogram edges live on the state's device, built once when the state is
created: an edge table handed over from the host at each update would be
a host-to-device copy, which waits for the card.

``HIST_KEYS`` — the per-eval-point history keys of the run — also lives
here, as in the reference; ``core/runner.py`` re-exports it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

# Per-eval-point history keys of ``core/runner.py::run_afl``.
HIST_KEYS = (
    "round", "eval", "uploads", "k_mean", "energy", "theta_mean",
    "power_mean", "bits_mean"
)


# ---------------------------------------------------------------------------
# Device helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _edges(edges: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A histogram's interior edges as an f32 tensor on ``device`` (one
    copy per (edges, device); read-only)."""
    return torch.tensor(edges, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=64)
def _bin_ids(num_bins: int, device: torch.device) -> torch.Tensor:
    return torch.arange(num_bins, device=device)


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` as an f32 tensor on ``device`` (no copy when it already is)."""
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def _increment(x, device: torch.device):
    """A counter increment: tensors move to ``device`` as f32; Python and
    numpy scalars stay scalars (a scalar tensor made on the card from a
    host value would be a copy that waits)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return float(x)


def _leaves(x, out: list) -> list:
    if isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    elif isinstance(x, torch.Tensor):
        out.append(x)
    return out


def to_host(state):
    """A (nested) dict of tensors as the same dict of numpy float32 arrays,
    through ONE device-to-host copy of all leaves; non-tensor leaves pass
    through unchanged (so a fetched or host state is returned as is)."""
    leaves = _leaves(state, [])
    if not leaves:
        return state
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in leaves]).cpu()
    parts = iter(flat.split([t.numel() for t in leaves]))

    def rebuild(x):
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return next(parts).reshape(x.shape).numpy()
        return x

    return rebuild(state)


# ---------------------------------------------------------------------------
# Metric specs (frozen and hashable, as in the reference)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Counter:
    """Monotone accumulator (sums of per-round increments)."""

    name: str
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class Gauge:
    """Last-value-wins scalar (e.g. the current round index)."""

    name: str
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class Histogram:
    """Fixed-bin histogram.  ``edges`` are the ascending interior edges;
    the state holds ``len(edges) + 1`` bins: an underflow bin
    ``(-inf, e0)``, the half-open interior bins ``[e_i, e_{i+1})``, and an
    overflow bin ``[e_last, inf)`` — so no sample is ever dropped."""

    name: str
    edges: Tuple[float, ...]
    doc: str = ""

    @property
    def num_bins(self) -> int:
        return len(self.edges) + 1


@dataclasses.dataclass(frozen=True)
class MetricRegistry:
    """A fixed set of metrics plus the pure update/merge/fetch algebra."""

    counters: Tuple[Counter, ...] = ()
    gauges: Tuple[Gauge, ...] = ()
    histograms: Tuple[Histogram, ...] = ()

    # -- state ---------------------------------------------------------------

    def init_state(self, device="cpu") -> dict:
        """Zeroed accumulation state on ``device``; builds the histogram
        edges there once."""
        zeros = functools.partial(torch.zeros, dtype=torch.float32,
                                  device=device)
        state = {
            "counters": {c.name: zeros(()) for c in self.counters},
            "gauges": {g.name: zeros(()) for g in self.gauges},
            "hist": {h.name: zeros((h.num_bins,)) for h in self.histograms},
        }
        for h in self.histograms:
            # keyed by the tensors' own device ("cuda" -> "cuda:0"), as
            # update looks the edges up
            dev = state["hist"][h.name].device
            _edges(h.edges, dev)
            _bin_ids(h.num_bins, dev)
        return state

    def _hist(self, name: str) -> Histogram:
        for h in self.histograms:
            if h.name == name:
                return h
        raise KeyError(f"unknown histogram {name!r}; known: "
                       f"{[h.name for h in self.histograms]}")

    # -- update ----------------------------------------------------------------

    def update(self, state: dict, counters: Optional[Mapping] = None,
               gauges: Optional[Mapping] = None,
               hists: Optional[Mapping] = None) -> dict:
        """One accumulation step — pure and shape-preserving, on the
        state's device.

        ``counters``: name -> scalar increment; ``gauges``: name -> new
        value; ``hists``: name -> (values, weights) arrays of equal shape
        (weights 0/1 masks keep the counts exactly integral).
        """
        new_c = dict(state["counters"])
        for name, inc in (counters or {}).items():
            new_c[name] = new_c[name] + _increment(inc, new_c[name].device)
        new_g = dict(state["gauges"])
        for name, val in (gauges or {}).items():
            dev = new_g[name].device
            new_g[name] = (val.to(device=dev, dtype=torch.float32)
                           if isinstance(val, torch.Tensor) else
                           torch.full((), float(val), dtype=torch.float32,
                                      device=dev))
        new_h = dict(state["hist"])
        for name, (values, weights) in (hists or {}).items():
            spec = self._hist(name)
            dev = new_h[name].device
            v = as_f32(values, dev).reshape(-1)
            w = as_f32(weights, dev).reshape(-1)
            idx = torch.searchsorted(_edges(spec.edges, dev), v, right=True)
            # one-hot contraction, as the reference: with 0/1 weights the
            # bin counts are integers, exact under any reduction order
            onehot = idx[:, None] == _bin_ids(spec.num_bins, dev)[None, :]
            new_h[name] = new_h[name] + w @ onehot.to(torch.float32)
        return {"counters": new_c, "gauges": new_g, "hist": new_h}

    # -- merge ---------------------------------------------------------------

    def merge(self, a: dict, b: dict) -> dict:
        """Combine two accumulation states (counters/hists add, gauges
        take the maximum — merge order must not matter)."""
        return {
            "counters": {k: a["counters"][k] + b["counters"][k]
                         for k in a["counters"]},
            "gauges": {k: torch.maximum(a["gauges"][k], b["gauges"][k])
                       for k in a["gauges"]},
            "hist": {k: a["hist"][k] + b["hist"][k] for k in a["hist"]},
        }

    def merge_stacked(self, state: dict, axis: int = 0) -> dict:
        """Collapse a leading batch axis (stacked seeds or shards)."""
        return {
            "counters": {k: torch.sum(v, dim=axis)
                         for k, v in state["counters"].items()},
            "gauges": {k: torch.amax(v, dim=axis)
                       for k, v in state["gauges"].items()},
            "hist": {k: torch.sum(v, dim=axis)
                     for k, v in state["hist"].items()},
        }

    # -- host side -----------------------------------------------------------

    def fetch(self, state: dict) -> dict:
        """Device state -> host snapshot (floats + np histogram arrays).
        The ONE host round-trip of a run."""
        host = to_host(state)
        return {
            "counters": {k: float(v) for k, v in host["counters"].items()},
            "gauges": {k: float(v) for k, v in host["gauges"].items()},
            "hist": {k: np.asarray(v) for k, v in host["hist"].items()},
        }

    def hist_stats(self, name: str, counts) -> dict:
        """Approximate count/mean/p50/p90 from binned counts (interior
        bins use their midpoint; under/overflow clamp to the edge)."""
        spec = self._hist(name)
        c = np.asarray(counts, np.float64)
        e = np.asarray(spec.edges, np.float64)
        rep = np.concatenate([[e[0]], (e[:-1] + e[1:]) / 2.0, [e[-1]]])
        total = float(c.sum())
        if total <= 0:
            return {"count": 0.0, "mean": float("nan"),
                    "p50": float("nan"), "p90": float("nan")}
        cdf = np.cumsum(c) / total
        return {
            "count": total,
            "mean": float((c * rep).sum() / total),
            "p50": float(rep[int(np.searchsorted(cdf, 0.5))]),
            "p90": float(rep[int(np.searchsorted(cdf, 0.9))]),
        }

    def summary(self, snapshot: dict) -> str:
        """Terminal summary table of a fetched snapshot."""
        lines = [f"{'metric':<22s} {'value':>14s}"]
        for c in self.counters:
            lines.append(f"{c.name:<22s} {snapshot['counters'][c.name]:>14.6g}")
        sc = snapshot["counters"]
        if "successes" in sc and "contacts" in sc:
            rate = sc["successes"] / max(sc["contacts"], 1.0)
            lines.append(f"{'success_rate':<22s} {rate:>14.4f}")
        for g in self.gauges:
            lines.append(f"{g.name:<22s} {snapshot['gauges'][g.name]:>14.6g}")
        lines.append(f"{'histogram':<22s} {'count':>10s} {'mean':>12s} "
                     f"{'p50':>12s} {'p90':>12s}")
        for h in self.histograms:
            st = self.hist_stats(h.name, snapshot["hist"][h.name])
            lines.append(f"{h.name:<22s} {st['count']:>10.0f} "
                         f"{st['mean']:>12.4g} {st['p50']:>12.4g} "
                         f"{st['p90']:>12.4g}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Composition: registry + per-device table + theory probes as ONE state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TelemetrySuite:
    """Composite telemetry carried through a run as a single state.

    A suite bundles up to three accumulators — the global
    ``MetricRegistry``, a per-client ``perdevice.DeviceTable``, and
    ``probes.TheoryProbes`` — under the state keys ``"metrics"`` /
    ``"device"`` / ``"probes"``.  It quacks like a registry
    (``init_state`` / ``merge`` / ``merge_stacked`` / ``fetch`` /
    ``summary``), and ``record_round`` dispatches to
    ``TelemetrySuite.record``, so the runner records a suite unchanged.
    ``fetch`` copies every section to the host in one transfer.
    """

    metrics: Optional[MetricRegistry] = None
    device: Optional[object] = None  # perdevice.DeviceTable
    probes: Optional[object] = None  # probes.TheoryProbes

    def _parts(self):
        return [(k, a) for k, a in (("metrics", self.metrics),
                                    ("device", self.device),
                                    ("probes", self.probes))
                if a is not None]

    def init_state(self, device="cpu") -> dict:
        return {k: a.init_state(device) for k, a in self._parts()}

    def record(self, state: dict, metrics: Mapping, tau) -> dict:
        out = {}
        for k, a in self._parts():
            if k == "metrics":
                out[k] = record_round(a, state[k], metrics, tau)
            else:
                out[k] = a.update(state[k], metrics, tau)
        return out

    def merge(self, a: dict, b: dict) -> dict:
        return {k: acc.merge(a[k], b[k]) for k, acc in self._parts()}

    def merge_stacked(self, state: dict, axis: int = 0) -> dict:
        return {k: a.merge_stacked(state[k], axis=axis)
                for k, a in self._parts()}

    def fetch(self, state: dict) -> dict:
        host = to_host(state)
        return {k: a.fetch(host[k]) for k, a in self._parts()}

    def summary(self, snapshot: dict) -> str:
        parts = []
        if self.metrics is not None:
            parts.append(self.metrics.summary(snapshot["metrics"]))
        if self.device is not None:
            parts.append("per-device stragglers (fewest contacts first):")
            parts.append(self.device.summary(snapshot["device"]))
        if self.probes is not None:
            m = self.probes.measured(snapshot["probes"])
            parts.append(
                "probes (measured): "
                + "  ".join(f"{k}={v:.4g}" for k, v in m.items())
            )
        return "\n".join(parts)


# ---------------------------------------------------------------------------
# Host-side snapshot algebra (post-fetch / post-JSONL merging)
# ---------------------------------------------------------------------------


def _merge_fetched_registry(snaps) -> dict:
    out = {
        "counters": {k: 0.0 for k in snaps[0]["counters"]},
        "gauges": {k: -np.inf for k in snaps[0]["gauges"]},
        "hist": {k: np.zeros_like(np.asarray(v, np.float64))
                 for k, v in snaps[0]["hist"].items()},
    }
    for s in snaps:
        for k, v in s["counters"].items():
            out["counters"][k] += float(v)
        for k, v in s["gauges"].items():
            out["gauges"][k] = max(out["gauges"][k], float(v))
        for k, v in s["hist"].items():
            out["hist"][k] = out["hist"][k] + np.asarray(v, np.float64)
    return out


def merge_fetched(snapshots) -> dict:
    """Merge fetched (or JSONL-loaded) snapshots: counters/hists add,
    gauges max — the numpy mirror of ``MetricRegistry.merge``.  Suite
    snapshots (with ``"metrics"`` / ``"device"`` / ``"probes"`` sections)
    merge section-wise: device fields follow ``perdevice.FIELD_KIND``
    (sums add, maxima max), probe accumulators all add.
    """
    snaps = list(snapshots)
    if not snaps:
        raise ValueError("no snapshots to merge")
    if "counters" in snaps[0]:  # plain registry snapshot
        return _merge_fetched_registry(snaps)
    out: dict = {}
    if "metrics" in snaps[0]:
        out["metrics"] = _merge_fetched_registry(
            [s["metrics"] for s in snaps])
    if "device" in snaps[0]:
        from repro_torch.telemetry.perdevice import FIELD_KIND

        dev = {}
        for f, kind in FIELD_KIND.items():
            if f not in snaps[0]["device"]:
                continue
            stack = np.stack([np.asarray(s["device"][f], np.float64)
                              for s in snaps])
            dev[f] = (np.sum if kind == "sum" else np.max)(stack, axis=0)
        dev["rounds"] = float(dev["rounds"])
        out["device"] = dev
    if "probes" in snaps[0]:
        out["probes"] = {
            f: float(sum(s["probes"][f] for s in snaps))
            for f in snaps[0]["probes"]
        }
    return out


def to_jsonable(snapshot: dict) -> dict:
    """Fetched snapshot -> plain lists/floats for the JSONL sink.  Suite
    snapshots serialise section-wise (same keys back out of
    ``read_jsonl`` + ``merge_fetched``)."""
    if "counters" not in snapshot:  # suite snapshot
        out: dict = {}
        if "metrics" in snapshot:
            out["metrics"] = to_jsonable(snapshot["metrics"])
        if "device" in snapshot:
            from repro_torch.telemetry.perdevice import table_to_jsonable

            out["device"] = table_to_jsonable(snapshot["device"])
        if "probes" in snapshot:
            out["probes"] = {k: float(v)
                             for k, v in snapshot["probes"].items()}
        return out
    return {
        "counters": {k: float(v) for k, v in snapshot["counters"].items()},
        "gauges": {k: float(v) for k, v in snapshot["gauges"].items()},
        "hist": {k: [float(x) for x in np.asarray(v)]
                 for k, v in snapshot["hist"].items()},
    }


# ---------------------------------------------------------------------------
# The built-in AFL round registry
# ---------------------------------------------------------------------------

# fixed, model-independent edges (the reference's, so bins compare 1:1)
_STALENESS_EDGES = (1., 2., 3., 4., 6., 8., 12., 16., 24., 32., 48., 64.,
                    96., 128.)
_TAU_EDGES = (0.5, 1., 2., 4., 8., 16., 32., 64., 128., 256.)
_BITS_EDGES = tuple(float(2 ** e) for e in range(10, 31, 2))
_K_EDGES = tuple(float(4 ** e) for e in range(0, 13))
_B_EDGES = (1., 2., 3., 4., 5., 6., 8., 10., 12., 16., 20., 24., 32.)


def afl_registry() -> MetricRegistry:
    """The built-in registry for Algorithm-1 rounds: the staleness /
    realized-bits / contact-duration / success / per-codec (k, b)
    distributions the paper's convergence story runs on."""
    return MetricRegistry(
        counters=(
            Counter("rounds", "rounds advanced"),
            Counter("contacts", "feasible contact events (zeta & energy)"),
            Counter("successes", "uploads that shipped >0 coordinates"),
            Counter("bits_total", "realized payload bits (<= tau*A budget)"),
            Counter("energy_total", "transmit energy spent (J)"),
        ),
        gauges=(
            Gauge("round", "last round index recorded"),
        ),
        histograms=(
            Histogram("staleness", _STALENESS_EDGES,
                      "delta_tau = r - kappa_n at contact"),
            Histogram("contact_tau", _TAU_EDGES,
                      "contact duration tau_n (s) at contact"),
            Histogram("bits", _BITS_EDGES,
                      "realized bits per successful upload"),
            Histogram("k", _K_EDGES,
                      "coordinates kept per successful upload"),
            Histogram("b", _B_EDGES,
                      "value bit-width on the wire (u or the codec's b*)"),
        ),
    )


#: Shared default instance.
AFL_REGISTRY = afl_registry()


def record_round(registry, state: dict, metrics: dict, tau) -> dict:
    """Fold one AFL round's metric dict into the accumulation state.

    Uses the metric keys ``core/afl.py::afl_round`` emits:
    uploads/success/theta/bits/k/b/energy.  ``tau`` is the round's (N,)
    contact-duration input, on the state's device.

    ``registry`` may also be a :class:`TelemetrySuite` (or anything with a
    ``record`` method): the call dispatches, which is how the per-device
    table and theory probes ride the same call site.
    """
    if not isinstance(registry, MetricRegistry):
        return registry.record(state, metrics, tau)
    okf = metrics["uploads"]
    succ = metrics["success"]
    return registry.update(
        state,
        counters={
            "rounds": 1.0,
            "contacts": torch.sum(okf),
            "successes": torch.sum(succ),
            "bits_total": torch.sum(metrics["bits"]),
            "energy_total": torch.sum(metrics["energy"]),
        },
        gauges={"round": state["counters"]["rounds"] + 1.0},
        hists={
            "staleness": (metrics["theta"], okf),
            "contact_tau": (tau, okf),
            "bits": (metrics["bits"], succ),
            "k": (metrics["k"], succ),
            "b": (metrics["b"], succ),
        },
    )


# ---------------------------------------------------------------------------
# The streaming-ingest (serve-path) registry
# ---------------------------------------------------------------------------

_FILL_EDGES = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def serve_registry() -> MetricRegistry:
    """Registry for the streaming aggregation server (the reference's
    ``repro/serve``; the port's serve ingest path is not written yet).

    Device-side counters (``batches`` / ``ingested`` / ``bits_ingested`` /
    ``weight_sum`` and the histograms) accumulate per fused ingest batch;
    the arrival-queue counters (``received`` / ``accepted`` /
    ``rejected`` / ``deferred``) and queue gauges are host-side and folded
    in when the server snapshots.
    """
    return MetricRegistry(
        counters=(
            Counter("batches", "fused ingest batches executed"),
            Counter("ingested", "uploads aggregated into the global model"),
            Counter("bits_ingested", "wire bits decoded and aggregated"),
            Counter("weight_sum", "sum of alpha*s(delta_tau) mix weights"),
            Counter("received", "uploads offered to the arrival buffer"),
            Counter("accepted", "uploads admitted to the arrival buffer"),
            Counter("rejected", "uploads refused by backpressure (reject)"),
            Counter("deferred", "uploads pushed back by backpressure (defer)"),
        ),
        gauges=(
            Gauge("server_round", "aggregation rounds applied"),
            Gauge("queue_depth", "arrival-buffer depth at snapshot"),
            Gauge("queue_peak", "peak arrival-buffer depth"),
        ),
        histograms=(
            Histogram("staleness", _STALENESS_EDGES,
                      "delta_tau of ingested uploads"),
            Histogram("batch_fill", _FILL_EDGES,
                      "occupied fraction of each fused batch"),
            Histogram("bits", _BITS_EDGES,
                      "wire bits per ingested upload"),
        ),
    )


#: Shared default instance.
SERVE_REGISTRY = serve_registry()


def record_ingest(registry: MetricRegistry, state: dict, *, mask, dtau,
                  bits, weights) -> dict:
    """Fold one fused ingest batch into the serve registry state.
    ``mask`` is the (B,) slot-occupancy/feasibility mask, ``weights`` the
    realized ``mask * alpha * s(dtau)`` mixing weights."""
    dev = state["gauges"]["server_round"].device
    mask = as_f32(mask, dev)
    return registry.update(
        state,
        counters={
            "batches": 1.0,
            "ingested": torch.sum(mask),
            "bits_ingested": torch.sum(as_f32(bits, dev) * mask),
            "weight_sum": torch.sum(as_f32(weights, dev)),
        },
        gauges={"server_round": state["gauges"]["server_round"] + 1.0},
        hists={
            "staleness": (dtau, mask),
            "batch_fill": (torch.mean(mask)[None],
                           torch.ones((1,), dtype=torch.float32, device=dev)),
            "bits": (bits, mask),
        },
    )


def record_het(telemetry, state: dict, het) -> dict:
    """Fold one round's heterogeneity loss masks into a telemetry state.

    ``het`` is a ``ScenarioProvider.aux_round`` dict — (N,) masks under
    "unavail" / "dropout", on the state's device — or None.  Only a
    :class:`TelemetrySuite` carrying a per-device table has anywhere to
    put per-client loss counters, so everything else (plain registries,
    suites without a table, het=None) is an identity.
    """
    if (het is None or not isinstance(telemetry, TelemetrySuite)
            or telemetry.device is None):
        return state
    new = dict(state)
    new["device"] = telemetry.device.update_het(state["device"], het)
    return new
