"""Per-device flight recorder: a ``DeviceTable`` of client-resident metrics.

``MetricRegistry`` (metrics.py) answers *what the federation did*;
``DeviceTable`` answers *which device did it*.  Its accumulation state is a
dict of ``(N,)`` float32 tensors — one row per client — on the run's
device, with the reference's keys.  Every update is elementwise per client
and enqueued on that device: no host round-trip mid-run; ``fetch`` is the
one copy to the host, same contract as ``MetricRegistry``.

Bit-identity: the count-like fields (``contacts``, ``successes``,
``failures``, ``last_contact``, ``staleness_sum``, ``staleness_max``,
``unavail``, ``dropouts``) are sums/maxima of exact-integer-valued f32
updates applied elementwise in round order — no cross-device reduction
ever happens, so they equal the reference's bit for bit on shared inputs.
Float fields (``tau_sum``, ``bits_sum``, ``energy_sum``) are elementwise
too and agree whenever the per-round metric values do; ``e_norm2`` is a
parameter-dimension reduction inside the round, summed in another order
than XLA's.

Host-side, ``rows``/``top_stragglers``/``top_by`` turn a fetched table
into per-device records and top-k straggler/outlier extractions.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.telemetry.metrics import as_f32, to_host

# merge semantics per field (used by merge/merge_stacked and by
# metrics.merge_fetched for the host-side JSONL mirror):
#   sum — accumulators add across seeds/shards
#   max — last-value / extremum fields take the maximum
FIELD_KIND = {
    "rounds": "sum",
    "contacts": "sum",
    "successes": "sum",
    "failures": "sum",
    "last_contact": "max",
    "staleness_sum": "sum",
    "staleness_max": "max",
    "tau_sum": "sum",
    "bits_sum": "sum",
    "energy_sum": "sum",
    "e_norm2": "max",
    # heterogeneity loss counters (scenarios/heterogeneity): contacts a
    # client lost to unavailability or a dropout.  Zero unless the scenario
    # carries a HeterogeneityModel; folded in by ``update_het``, NOT by
    # ``update`` (the round's metric dict never contains them)
    "unavail": "sum",
    "dropouts": "sum",
}

#: per-device (N,) fields, in state order; "rounds" is the extra scalar
DEVICE_FIELDS = tuple(k for k in FIELD_KIND if k != "rounds")


@dataclasses.dataclass(frozen=True)
class DeviceTable:
    """Per-client flight-recorder spec (frozen + hashable).

    ``n`` is the federation size; every per-device field is an ``(n,)``
    f32 tensor in the accumulation state.
    """

    n: int

    # -- state ---------------------------------------------------------------

    def init_state(self, device="cpu") -> dict:
        state = {f: torch.zeros((self.n,), dtype=torch.float32, device=device)
                 for f in DEVICE_FIELDS}
        state["rounds"] = torch.zeros((), dtype=torch.float32, device=device)
        return state

    # -- update (elementwise per client) ---------------------------------------

    def update(self, state: dict, metrics: Mapping, tau) -> dict:
        """Fold one round's metric dict into the table.

        Uses uploads/success/theta/bits/energy, plus ``e_norm2``
        (EF-memory squared norm) when present.
        """
        dev = state["rounds"].device
        okf = as_f32(metrics["uploads"], dev)
        succ = as_f32(metrics["success"], dev)
        theta = as_f32(metrics["theta"], dev)
        tau = as_f32(tau, dev)
        r = state["rounds"] + 1.0
        new = {
            "rounds": r,
            "contacts": state["contacts"] + okf,
            "successes": state["successes"] + succ,
            "failures": state["failures"] + (okf - succ),
            "last_contact": torch.where(okf > 0, r, state["last_contact"]),
            "staleness_sum": state["staleness_sum"] + theta * okf,
            "staleness_max": torch.maximum(state["staleness_max"],
                                           theta * okf),
            "tau_sum": state["tau_sum"] + tau * okf,
            "bits_sum": state["bits_sum"] + as_f32(metrics["bits"], dev),
            "energy_sum": state["energy_sum"] + as_f32(metrics["energy"], dev),
        }
        # EF-memory norm: last value wins (a gauge per client); a metric
        # dict without it leaves the previous value in place
        e2 = metrics.get("e_norm2")
        new["e_norm2"] = (as_f32(e2, dev) if e2 is not None
                          else state["e_norm2"])
        # het counters ride through unchanged: update_het owns them
        new["unavail"] = state["unavail"]
        new["dropouts"] = state["dropouts"]
        return new

    def update_het(self, state: dict, het: Optional[Mapping]) -> dict:
        """Fold one round's heterogeneity loss masks into the table.

        ``het`` is a ``ScenarioProvider.aux_round`` dict — (N,) 0/1 masks
        under "unavail" / "dropout" — or None (layer disabled: no-op).
        """
        if het is None:
            return state
        dev = state["rounds"].device
        new = dict(state)
        new["unavail"] = state["unavail"] + as_f32(het["unavail"], dev)
        new["dropouts"] = state["dropouts"] + as_f32(het["dropout"], dev)
        return new

    # -- merge ---------------------------------------------------------------

    def merge(self, a: dict, b: dict) -> dict:
        """Combine two tables (seeds / shards): sums add, maxima max."""
        return {
            f: (torch.add if FIELD_KIND[f] == "sum" else torch.maximum)(
                a[f], b[f])
            for f in a
        }

    def merge_stacked(self, state: dict, axis: int = 0) -> dict:
        """Collapse a leading batch axis (stacked seeds or shards)."""
        return {
            f: (torch.sum if FIELD_KIND[f] == "sum" else torch.amax)(
                state[f], dim=axis)
            for f in state
        }

    # -- host side -----------------------------------------------------------

    def fetch(self, state: dict) -> dict:
        """Device state -> host snapshot (np arrays + float rounds), in one
        copy."""
        host = to_host(state)
        out = {f: np.asarray(host[f]) for f in DEVICE_FIELDS}
        out["rounds"] = float(host["rounds"])
        return out

    def summary(self, snapshot: dict, k: int = 5) -> str:
        """Terminal table of the k worst stragglers."""
        lines = [f"{'device':>6s} {'contacts':>9s} {'succ':>6s} "
                 f"{'fail':>6s} {'stale_mean':>11s} {'last_r':>7s} "
                 f"{'Mbits':>8s} {'J':>8s}"]
        for row in top_stragglers(snapshot, k=k):
            lines.append(
                f"{row['device']:>6d} {row['contacts']:>9.0f} "
                f"{row['successes']:>6.0f} {row['failures']:>6.0f} "
                f"{row['staleness_mean']:>11.2f} {row['last_contact']:>7.0f} "
                f"{row['bits_sum'] / 1e6:>8.2f} {row['energy_sum']:>8.2f}"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Host-side row extraction: stragglers and outliers
# ---------------------------------------------------------------------------


def rows(snapshot: dict) -> list[dict]:
    """Fetched table -> one record per device, with derived stats."""
    n = len(np.asarray(snapshot["contacts"]))
    # het counters: absent from snapshots written before the heterogeneity
    # layer existed (archived telemetry.jsonl)
    unavail = np.asarray(snapshot.get("unavail", np.zeros(n)))
    dropouts = np.asarray(snapshot.get("dropouts", np.zeros(n)))
    out = []
    for i in range(n):
        contacts = float(np.asarray(snapshot["contacts"])[i])
        succ = float(np.asarray(snapshot["successes"])[i])
        rec = {
            "device": i,
            "contacts": contacts,
            "successes": succ,
            "failures": float(np.asarray(snapshot["failures"])[i]),
            "success_rate": succ / max(contacts, 1.0),
            "last_contact": float(np.asarray(snapshot["last_contact"])[i]),
            "staleness_mean":
                float(np.asarray(snapshot["staleness_sum"])[i])
                / max(contacts, 1.0),
            "staleness_max": float(np.asarray(snapshot["staleness_max"])[i]),
            "tau_mean": float(np.asarray(snapshot["tau_sum"])[i])
            / max(contacts, 1.0),
            "bits_sum": float(np.asarray(snapshot["bits_sum"])[i]),
            "energy_sum": float(np.asarray(snapshot["energy_sum"])[i]),
            "e_norm2": float(np.asarray(snapshot["e_norm2"])[i]),
            "unavail": float(unavail[i]),
            "dropouts": float(dropouts[i]),
        }
        out.append(rec)
    return out


def top_by(snapshot: dict, field: str, k: int = 5,
           largest: bool = True) -> list[dict]:
    """Top-k outlier devices by any derived row field."""
    recs = rows(snapshot)
    recs.sort(key=lambda r: r[field], reverse=largest)
    return recs[:k]


def top_stragglers(snapshot: dict, k: int = 5) -> list[dict]:
    """The k most starved devices: fewest participations first, oldest
    last-contact breaking ties, then highest mean staleness."""
    recs = rows(snapshot)
    recs.sort(key=lambda r: (r["contacts"], r["last_contact"],
                             -r["staleness_mean"]))
    return recs[:k]


def participation_gini(snapshot: dict) -> float:
    """Gini coefficient of per-device participation counts (0 = uniform,
    1 = one device does everything) — a one-number starvation signal."""
    c = np.sort(np.asarray(snapshot["contacts"], np.float64))
    n = len(c)
    total = c.sum()
    if n == 0 or total <= 0:
        return 0.0
    cum = np.cumsum(c)
    return float((n + 1 - 2.0 * cum.sum() / total) / n)


def table_to_jsonable(snapshot: Optional[dict]) -> Optional[dict]:
    """Fetched table -> plain lists/floats for the JSONL sink."""
    if snapshot is None:
        return None
    return {
        f: ([float(x) for x in np.asarray(v)]
            if np.ndim(v) else float(v))
        for f, v in snapshot.items()
    }


__all__ = [
    "DEVICE_FIELDS",
    "DeviceTable",
    "FIELD_KIND",
    "participation_gini",
    "rows",
    "table_to_jsonable",
    "top_by",
    "top_stragglers",
]
