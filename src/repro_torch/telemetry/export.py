"""Exporters: JSONL event sink, and the benchmark trajectory files that
``tools/bench_compare.py`` gates regressions against.

The sink buffers events host-side and lands them with an atomic
write-then-rename, so a kill mid-flush can never leave a truncated file
that downstream tooling would half-parse.  Stdlib only, and the same file
schemas as the reference's exporters.

Benchmark rows (the ``name,us_per_call,derived`` CSV every bench module
prints) export as ``BENCH_<suite>.json``: parsed rows plus a bounded
trajectory of previous exports to the same path, so a workstation or CI
artifact accumulates the suite's history.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import Iterable, Optional

log = logging.getLogger("repro_torch.telemetry.export")

MAX_BENCH_HISTORY = 20  # previous exports kept in a BENCH file


def _atomic_write(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# JSONL events
# ---------------------------------------------------------------------------


def sanitize(obj):
    """Replace non-finite floats with ``None`` recursively.

    Returns ``(clean, n_replaced)``.  ``json.dumps`` would happily emit
    ``NaN``/``Infinity`` — which is NOT valid JSON and breaks every strict
    reader of ``telemetry.jsonl`` — so the sink nulls them out instead of
    letting one diverged metric poison a whole sweep's artifact.  Only
    python floats are sanitised; callers convert device/numpy scalars via
    ``to_jsonable`` first (non-serialisable objects still fail eagerly).
    """
    if isinstance(obj, float):
        return (obj, 0) if math.isfinite(obj) else (None, 1)
    if isinstance(obj, dict):
        n = 0
        out = {}
        for k, v in obj.items():
            out[k], dn = sanitize(v)
            n += dn
        return out, n
    if isinstance(obj, (list, tuple)):
        n = 0
        items = []
        for v in obj:
            cv, dn = sanitize(v)
            items.append(cv)
            n += dn
        return (items if isinstance(obj, list) else tuple(items)), n
    return obj, 0


class JsonlSink:
    """Buffered JSONL writer with atomic flush (write-then-rename).

    Events are plain dicts; ``emit`` validates JSON-serialisability
    eagerly so a bad record fails at the call site, not at flush time.
    Non-finite floats are sanitised to ``null`` with a warning (a NaN'd
    counter mid-sweep must not kill the sweep or corrupt the JSONL).
    Usable as a context manager (flushes on exit).
    """

    def __init__(self, path: str):
        self.path = path
        self.events: list[dict] = []

    def emit(self, record: dict) -> None:
        record, bad = sanitize(record)
        if bad:
            log.warning("sanitized %d non-finite value(s) to null in %r "
                        "event", bad, record.get("kind", "?"))
        json.dumps(record, allow_nan=False)  # fail fast on non-jsonable
        self.events.append(record)

    def extend(self, records: Iterable[dict]) -> None:
        for r in records:
            self.emit(r)

    def flush(self) -> str:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        _atomic_write(
            self.path, "".join(json.dumps(r) + "\n" for r in self.events)
        )
        return self.path

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Benchmark trajectory files
# ---------------------------------------------------------------------------


def parse_csv_row(row: str) -> dict:
    """``name,us_per_call,derived`` -> a record with parsed metrics.

    The derived field is ``key=value`` pairs joined by ``;`` (values may
    carry a trailing ``x`` multiplier suffix); non-numeric values are kept
    verbatim under ``derived`` only.
    """
    name, us, derived = (row.split(",", 2) + ["", ""])[:3]
    rec: dict = {"name": name, "us_per_call": float(us or 0.0),
                 "derived": derived, "metrics": {}}
    for part in derived.split(";"):
        if "=" not in part:
            continue
        key, val = part.split("=", 1)
        try:
            rec["metrics"][key.strip()] = float(val.strip().rstrip("x"))
        except ValueError:
            pass
    return rec


def export_bench(suite: str, rows, out_dir: str = ".",
                 meta: Optional[dict] = None) -> str:
    """Write ``BENCH_<suite>.json`` (atomically) under ``out_dir``.

    ``rows``: CSV strings from a bench module's ``run()`` or pre-parsed
    record dicts.  If the file already exists, its latest rows are pushed
    onto a bounded ``history`` list — the regression *trajectory*.
    """
    recs = [parse_csv_row(r) if isinstance(r, str) else dict(r)
            for r in rows]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"BENCH_{suite}.json")
    history = []
    if os.path.exists(path):
        try:
            prev = load_bench(path)
            history = prev.get("history", [])[-(MAX_BENCH_HISTORY - 1):]
            history.append({"meta": prev.get("meta", {}),
                            "rows": prev.get("rows", [])})
        except (json.JSONDecodeError, OSError):
            history = []
    payload = {"suite": suite, "schema": 1, "meta": meta or {},
               "rows": recs, "history": history}
    _atomic_write(path, json.dumps(payload, indent=2) + "\n")
    return path


def load_bench(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
