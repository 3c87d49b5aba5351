"""``IngestServer``, the streaming MES: arrival buffer + fused ingest; the
port of ``repro/serve/server.py``.

Clients ``submit`` wire payloads (bounded queue, counted backpressure),
``step`` drains up to one batch through the fused decompress + aggregate
op, and ``snapshot`` folds the host-side queue accounting into the
device-resident serve registry state for one device-to-host fetch.

The global model lives flat, (s,), on its device (a tree it is built
from is flattened in flatten order).  A batch is packed on the
host with numpy into one pinned staging buffer and reaches the card in one
non-blocking copy; the ingest span's fence is the step's only wait for the
card.  Sharding the batch over a mesh of cards waits for the distributed
step (``mesh=`` raises).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compression.wire import PACKED_KEYS, WirePayload, pack_batch
from repro_torch.core.afl import StalenessWeight
from repro_torch.serve.aggregate import flat_model, make_fused_ingest
from repro_torch.serve.queue import ArrivalBuffer
from repro_torch.telemetry.metrics import MetricRegistry, serve_registry
from repro_torch.telemetry.tracing import PhaseTracer

__all__ = ["IngestServer"]


def _staging(batch: int, max_k: int, device: torch.device):
    """(host int32 buffer, its numpy views keyed as ``PACKED_KEYS``, the
    device buffer's tensor views): the (batch, max_k) coordinate and code
    blocks, then five (batch,) float32 header columns, in one buffer so a
    batch moves in one copy.  On the CPU the device views are the host
    buffer's own."""
    bk = batch * max_k
    n = 2 * bk + len(PACKED_KEYS[2:]) * batch
    host = torch.empty(n, dtype=torch.int32, pin_memory=device.type == "cuda")
    dev = host if device.type == "cpu" else torch.empty(
        n, dtype=torch.int32, device=device)

    def views(buf):
        cols = buf[2 * bk:].view(torch.float32).view(-1, batch)
        out = {"coords": buf[:bk].view(batch, max_k),
               "codes": buf[bk:2 * bk].view(batch, max_k)}
        out.update(zip(PACKED_KEYS[2:], cols))
        return out

    host_np = {k: v.numpy() for k, v in views(host).items()}
    return host, host_np, dev, views(dev)


class IngestServer:
    """Bounded-queue ingestion front end over the fused aggregation op."""

    def __init__(self, w, *, num_devices: int, batch: int, max_k: int,
                 staleness: StalenessWeight = StalenessWeight(),
                 queue_capacity: Optional[int] = None,
                 queue_policy: str = "reject",
                 registry: Optional[MetricRegistry] = None,
                 tracer: Optional[PhaseTracer] = None,
                 mesh=None, mode: str = "parity"):
        if mesh is not None:
            raise NotImplementedError(
                "sharding the ingest over a mesh of cards is not ported "
                "(ROADMAP.md, queue 1 item 5: the distributed step); run "
                "with mesh=None")
        self.batch = int(batch)
        self.max_k = int(max_k)
        self.num_devices = int(num_devices)
        self.staleness = staleness
        self.w = flat_model(w)
        self.s = self.w.numel()
        self.registry = serve_registry() if registry is None else registry
        self.tracer = tracer or PhaseTracer()
        self.buffer = ArrivalBuffer(
            capacity=queue_capacity if queue_capacity is not None
            else 4 * self.batch,
            policy=queue_policy)
        self.tstate = self.registry.init_state(self.w.device)
        self.rnd = 0  # server-side model version counter
        self._host, self._host_np, self._dev, self.packed = _staging(
            self.batch, self.max_k, self.w.device)
        self._ingest = make_fused_ingest(
            self.w, batch=self.batch, max_k=self.max_k,
            num_devices=self.num_devices, staleness=staleness,
            registry=self.registry, mode=mode)

    # -- producer ------------------------------------------------------------

    def submit(self, payload: WirePayload) -> bool:
        """Offer one upload; ``False`` means backpressure (counted)."""
        return self.buffer.offer(payload)

    # -- consumer ------------------------------------------------------------

    def pack(self, items) -> dict:
        """Pack ``items`` at the current round into the staging buffer and
        start its one copy to the device; returns the device views."""
        pack_batch(items, s=self.s, max_k=self.max_k, batch=self.batch,
                   server_round=self.rnd, out=self._host_np)
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
        return self.packed

    def step(self) -> int:
        """Drain up to one batch through the fused op; returns the number
        of uploads aggregated (0 leaves all state untouched: an empty
        batch does not advance the model version)."""
        items = self.buffer.take(self.batch)
        if not items:
            return 0
        with self.tracer.span("serve.pack", n=len(items)):
            packed = self.pack(items)
        with self.tracer.span("serve.ingest", n=len(items)) as tr:
            self.w, self.tstate = self._ingest(self.w, packed, self.tstate)
            # the step's one wait for the card: the next pack reuses the
            # staging buffer the copy reads
            tr.fence(self.w)
        self.rnd += 1
        return len(items)

    def drain(self) -> int:
        """Step until the buffer is empty; returns uploads aggregated."""
        total = 0
        while len(self.buffer):
            total += self.step()
        return total

    # -- accounting ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Queue counters + device registry state -> one host fetch."""
        self.buffer.check_invariant()
        c = self.buffer.counters()
        st = self.registry.update(
            self.tstate,
            counters={k: float(c[k]) for k in
                      ("received", "accepted", "rejected", "deferred")},
            gauges={"queue_depth": float(c["depth"]),
                    "queue_peak": float(c["peak"])},
        )
        return self.registry.fetch(st)
