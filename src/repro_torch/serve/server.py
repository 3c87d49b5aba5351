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
card.

Over a mesh of P ranks (``mesh=``, one process a card; the reference's
``ingest_shardings``), each rank's server holds its own arrival buffer and
its own copy of ``w``: clients offer each rank its share of a batch, a
step takes up to B/P uploads, packs only those into the rank's staging
buffer (B/P rows, one copy a batch) and runs the fused op, whose partial
sum takes one ``all_reduce`` (``serve/aggregate.py``), so that ``w`` ends
each step bit-equal on every rank.  Steps are collective: every rank calls
``step`` together, and a step first agrees on the batch's size over the
group (a second, small all-reduce and a wait for it), so that a step with
no upload on any rank leaves every rank's state untouched.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.compression.wire import PACKED_KEYS, WirePayload, pack_batch
from repro_torch.core.afl import StalenessWeight
from repro_torch.core.distributed import ingest_shardings
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
        self.batch = int(batch)
        self.max_k = int(max_k)
        self.num_devices = int(num_devices)
        self.staleness = staleness
        self.w = flat_model(w)
        self.s = self.w.numel()
        self.registry = serve_registry() if registry is None else registry
        self.tracer = tracer or PhaseTracer()
        # the rank's rows of a batch (all of it without a mesh)
        self.sharding = None if mesh is None else ingest_shardings(mesh)
        rows = (slice(0, self.batch) if self.sharding is None
                else self.sharding.rows(self.batch))
        self.local_batch = rows.stop - rows.start
        if mesh is not None and self.w.device != mesh.device:
            raise ValueError(f"w is on {self.w.device}, the mesh rank on "
                             f"{mesh.device}")
        self.buffer = ArrivalBuffer(
            capacity=queue_capacity if queue_capacity is not None
            else 4 * self.local_batch,
            policy=queue_policy)
        self.tstate = self.registry.init_state(self.w.device)
        self.rnd = 0  # server-side model version counter
        self._host, self._host_np, self._dev, self.packed = _staging(
            self.local_batch, self.max_k, self.w.device)
        self._ingest = make_fused_ingest(
            self.w, batch=self.local_batch, max_k=self.max_k,
            num_devices=self.num_devices, staleness=staleness,
            registry=self.registry, mode=mode, sharding=self.sharding)

    # -- producer ------------------------------------------------------------

    def submit(self, payload: WirePayload) -> bool:
        """Offer one upload; ``False`` means backpressure (counted)."""
        return self.buffer.offer(payload)

    # -- consumer ------------------------------------------------------------

    def pack(self, items) -> dict:
        """Pack ``items`` (at most the rank's share of a batch) at the
        current round into the staging buffer and start its one copy to
        the device; returns the device views."""
        pack_batch(items, s=self.s, max_k=self.max_k, batch=self.local_batch,
                   server_round=self.rnd, out=self._host_np)
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
        return self.packed

    def _agree(self, n: int) -> int:
        """The batch's uploads over every rank (``n`` without a mesh)."""
        if self.sharding is None:
            return n
        t = torch.tensor([n], dtype=torch.int64, device=self.w.device)
        dist.all_reduce(t, group=self.sharding.group)
        return int(t.item())

    def step(self) -> int:
        """Drain up to one batch through the fused op; returns the number
        of uploads aggregated, over every rank of a mesh (0 leaves all
        state untouched: an empty batch does not advance the model
        version)."""
        items = self.buffer.take(self.local_batch)
        n = self._agree(len(items))
        if not n:
            return 0
        with self.tracer.span("serve.pack", n=len(items)):
            packed = self.pack(items)
        with self.tracer.span("serve.ingest", n=len(items)) as tr:
            self.w, self.tstate = self._ingest(self.w, packed, self.tstate)
            # the step's one wait for the card: the next pack reuses the
            # staging buffer the copy reads
            tr.fence(self.w)
        self.rnd += 1
        return n

    def drain(self) -> int:
        """Step until the buffer (every rank's, over a mesh) is empty;
        returns uploads aggregated."""
        total = 0
        while n := self.step():
            total += n
        return total

    # -- accounting ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Queue counters + device registry state -> one host fetch.  Over
        a mesh the queue counters and depth are summed over the ranks and
        the peak is the largest rank's (one all-reduce each), so that
        every rank's snapshot is the whole server's."""
        self.buffer.check_invariant()
        c = self.buffer.counters()
        if self.sharding is not None:
            keys = ("received", "accepted", "rejected", "deferred", "depth")
            t = torch.tensor([float(c[k]) for k in keys], dtype=torch.float64,
                             device=self.w.device)
            peak = torch.tensor([float(c["peak"])], dtype=torch.float64,
                                device=self.w.device)
            dist.all_reduce(t, group=self.sharding.group)
            dist.all_reduce(peak, op=dist.ReduceOp.MAX,
                            group=self.sharding.group)
            c = dict(zip(keys, t.tolist()), peak=float(peak))
        st = self.registry.update(
            self.tstate,
            counters={k: float(c[k]) for k in
                      ("received", "accepted", "rejected", "deferred")},
            gauges={"queue_depth": float(c["depth"]),
                    "queue_peak": float(c["peak"])},
        )
        return self.registry.fetch(st)
