"""Fused batched decompress + staleness-weighted aggregation; the port of
``repro/serve/aggregate.py``.

One op takes a padded batch of wire payloads and applies it to the flat
global model on its device: dequantise the codes
(``wire.decode_values``), scatter the sparse coordinates, and mix with the
FedAsync ``alpha * s(delta_tau)`` weights (``core.afl.StalenessWeight``,
the object the engines carry on ``Policy``).  The reference computes this
step in plain array code outside any kernel, and so does the port: a
scatter-add and one matrix-vector product.

Two aggregation modes, chosen at build time:

Pad coordinates (``s``) add their zeros into slots past the model, spread
so that no one address takes every pad's add.

* ``mode="parity"`` (default): scatter into a dense ``(B, s)`` f32 block,
  then ``w - div(mix @ block, N).to(w.dtype)``, the port's ``afl_round``
  expression on the same flat layout, so a batch of B = N uploads lands on
  the weights one ``afl_round`` over those N devices produces, bit for bit
  (tests/test_torch_ingest.py).
* ``mode="scatter"``: weight the decoded values per row and scatter-add
  them into one ``(s,)`` accumulator, O(B K) work instead of O(B s); equal
  up to float summation order (exactly equal when no two uploads in the
  batch ship the same coordinate).

Telemetry rides inside the op: pass a ``serve_registry()`` and its state
is updated on the device per batch.  An ingest makes no host sync.

Over a mesh (``sharding``, ``core/distributed.py::IngestSharding``) the op
takes the rank's B/P rows of each batch: the rank's partial sum (its rows
of the parity block, or its scatter) goes through one ``all_reduce(SUM)``
before the update, and the rows' header columns are gathered (one
``all_gather``), so that every rank records the whole batch and ends with
the same ``w``.  With one rank both collectives change nothing, and the
op equals the op without a mesh bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.compression.wire import decode_values
from repro_torch.core.afl import StalenessWeight
from repro_torch.telemetry.metrics import MetricRegistry, record_ingest
from repro_torch.utils.fmath import div
from repro_torch.utils.tree import flatten_concat

__all__ = ["make_fused_ingest", "flat_model"]

_MODES = ("parity", "scatter")
# slots past the model that a batch's pad coordinates are spread over: a
# pad slot at flat position i of the (B, K) block adds its zero at slot
# i mod _SINKS, so no one address takes every pad's atomic add (a batch of
# sparse uploads is mostly padding)
_SINKS = 1 << 16


def flat_model(w) -> torch.Tensor:
    """A flat tensor, or a tree of tensors concatenated in flatten order, as
    one (s,) tensor."""
    return w.reshape(-1) if isinstance(w, torch.Tensor) else flatten_concat(w)


def _targets(coords, row_len: int, s: int):
    """Flat index each (B, K) entry adds at in a buffer of B rows of
    ``row_len`` (row_len = s for the parity block, 0 for the scatter
    accumulator, whose rows coincide), followed by _SINKS pad slots."""
    b = coords.shape[0]
    pos = torch.arange(coords.numel(), device=coords.device).view_as(coords)
    rows = torch.arange(b, device=coords.device)[:, None] * row_len
    sink = max(b * row_len, s) + pos % _SINKS
    return torch.where(coords < s, rows + coords, sink).reshape(-1)


def make_fused_ingest(w_template, *, batch: int, max_k: int,
                      num_devices: int,
                      staleness: StalenessWeight = StalenessWeight(),
                      registry: Optional[MetricRegistry] = None,
                      mode: str = "parity", sharding=None):
    """Build the ingest step for a fixed model/batch geometry.

    ``w_template`` (a flat tensor or a tree of tensors) fixes the flat size
    ``s``.  ``num_devices`` is the paper's N: the MES averages over the
    population, not over the batch.

    Returns ``ingest(w, packed, tstate) -> (w_new, tstate')``: ``w`` the
    flat (s,) global model, ``packed`` a ``wire.pack_batch`` dict (tensors
    on ``w``'s device, or host arrays on the CPU) and ``tstate`` the
    registry state (``{}`` when ``registry`` is None).  With ``sharding``
    (an ``IngestSharding``), ``batch`` is the rank's share of a batch and
    ``packed`` holds the rank's rows.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    s = flat_model(w_template).numel()

    def ingest(w, packed, tstate):
        dev = w.device
        p = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
        coords = p["coords"].to(torch.int64)
        vals = decode_values(p["codes"], p["step"], p["b"])
        mask = p["mask"].to(torch.float32)
        dtau = p["dtau"].to(torch.float32)
        # the engines' mixing rule (afl_round): the identity family skips
        # the multiply
        mix = mask if staleness.is_identity \
            else mask * staleness.weight(dtau)
        if mode == "parity":
            # the (B, s) block, contiguous as afl_round's uploads, then the
            # pad slots; a row's coordinates are distinct, so each block
            # entry adds one value to 0.0
            flat = torch.zeros(batch * s + _SINKS, dtype=torch.float32,
                               device=dev)
            flat.index_add_(0, _targets(coords, s, s), vals.reshape(-1))
            agg = mix @ flat[:batch * s].view(batch, s)
        else:
            acc = torch.zeros(s + _SINKS, dtype=torch.float32, device=dev)
            acc.index_add_(0, _targets(coords, 0, s),
                           (vals * mix[:, None]).reshape(-1))
            agg = acc[:s]
        if sharding is not None:
            dist.all_reduce(agg, group=sharding.group)
        w_new = w - div(agg, float(num_devices)).to(w.dtype)
        if registry is not None:
            bits = p["bits"]
            if sharding is not None:  # the whole batch's header columns
                cols = torch.stack([mask, dtau, bits.to(torch.float32), mix])
                parts = [torch.empty_like(cols)
                         for _ in range(sharding.world_size)]
                dist.all_gather(parts, cols, group=sharding.group)
                mask, dtau, bits, mix = torch.cat(parts, dim=1)
            tstate = record_ingest(registry, tstate, mask=mask, dtau=dtau,
                                   bits=bits, weights=mix)
        return w_new, tstate

    return ingest
