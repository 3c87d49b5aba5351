"""Streaming ingestion path for compressed client uploads; the port of
``repro/serve``.

The simulation engines (``core/afl.py``, ``experiments/scan_engine.py``)
aggregate a whole round of uploads as one product: fine when the scenario
engine generates the uploads.  A deployed MES receives them one at a time
off the network instead.  This package is that server:

* ``queue``: ``ArrivalBuffer``, a bounded arrival queue with counted
  backpressure (reject or defer; nothing is dropped silently).
* ``aggregate``: ``make_fused_ingest``, decompress + staleness-weighted
  aggregation over a padded batch of wire payloads as one op on the
  device, bit-identical to ``afl_round``'s aggregation in its parity mode
  (tests/test_torch_ingest.py).
* ``server``: ``IngestServer``, buffer + fused op + serve telemetry
  registry, with a one-fetch snapshot.

Wire format: ``repro_torch.compression.wire``.  Staleness family:
``repro_torch.core.afl.StalenessWeight`` (shared with the engines through
``Policy``).
"""
from repro_torch.serve.aggregate import make_fused_ingest
from repro_torch.serve.queue import ArrivalBuffer
from repro_torch.serve.server import IngestServer

__all__ = ["ArrivalBuffer", "IngestServer", "make_fused_ingest"]
