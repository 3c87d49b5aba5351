"""Telemetry: device-resident round metrics, phase tracing, exporters.

The reference's ``repro/telemetry`` for the port, with its names and its
state layout: every state is a dict of float32 tensors with the
reference's keys, on the run's device, and ``fetch`` returns the
reference's host types, so JSONL records and reports are identical.
Quick map:

* ``metrics``   — ``MetricRegistry`` (counters / gauges / fixed-bin
  histograms) updated on the card each round and fetched once at run end;
  ``AFL_REGISTRY`` + ``record_round`` are the built-in Algorithm-1
  instrumentation; ``TelemetrySuite`` composes the registry with the
  layers below under one state.  The port records eagerly: the
  reference's ``jit_record`` has no counterpart.
* ``perdevice`` — ``DeviceTable`` per-client flight recorder ((N,) rows:
  participation, staleness, tau, bits, energy, EF norm, heterogeneity
  losses) with top-k straggler extraction at fetch.
* ``probes``    — ``TheoryProbes`` online theory-vs-practice accumulators
  compared against ``core/theory.py`` closed forms at fetch.
* ``tracing``   — ``PhaseTracer`` wall-clock spans (nested, exception-
  safe) with ``torch.cuda.synchronize`` fencing and ``torch.profiler``
  hooks.
* ``export``    — atomic JSONL event sink (NaN/inf sanitised to null),
  ``BENCH_<suite>.json`` trajectory files (``tools/bench_compare.py``).
* ``report``    — ``render_report``: telemetry.jsonl + snapshots ->
  self-contained markdown run report; ``python -m
  repro_torch.telemetry.report`` is its CLI.
"""
from repro_torch.telemetry.export import (
    JsonlSink,
    export_bench,
    load_bench,
    parse_csv_row,
    read_jsonl,
    sanitize,
)
from repro_torch.telemetry.metrics import (
    AFL_REGISTRY,
    HIST_KEYS,
    SERVE_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    TelemetrySuite,
    afl_registry,
    merge_fetched,
    record_het,
    record_ingest,
    record_round,
    serve_registry,
    to_jsonable,
)
from repro_torch.telemetry.perdevice import (
    DeviceTable,
    participation_gini,
    table_to_jsonable,
    top_by,
    top_stragglers,
)
from repro_torch.telemetry.probes import (
    TheoryProbes,
    contact_params,
    probes_to_jsonable,
    report_from_config,
)
from repro_torch.telemetry.tracing import PhaseTracer, Span


def __getattr__(name):
    # the report module loads on first use, so that ``python -m
    # repro_torch.telemetry.report`` does not find it imported already
    if name in ("ascii_hist", "render_report"):
        from repro_torch.telemetry import report

        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AFL_REGISTRY",
    "HIST_KEYS",
    "SERVE_REGISTRY",
    "Counter",
    "DeviceTable",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricRegistry",
    "PhaseTracer",
    "Span",
    "TelemetrySuite",
    "TheoryProbes",
    "afl_registry",
    "ascii_hist",
    "contact_params",
    "export_bench",
    "load_bench",
    "merge_fetched",
    "parse_csv_row",
    "participation_gini",
    "probes_to_jsonable",
    "read_jsonl",
    "record_het",
    "record_ingest",
    "record_round",
    "serve_registry",
    "render_report",
    "report_from_config",
    "sanitize",
    "table_to_jsonable",
    "to_jsonable",
    "top_by",
    "top_stragglers",
]
