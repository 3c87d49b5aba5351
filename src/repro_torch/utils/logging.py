"""Minimal structured logger (stdout, flush-friendly for tee'd benchmark runs).

Environment knobs:

* ``REPRO_LOG_FORMAT=json`` — one JSON object per line (``ts``, ``logger``,
  ``level``, ``msg``) instead of the human-readable format, so benchmark
  and sweep output can be ingested alongside the telemetry JSONL sinks.
* ``REPRO_LOG_LEVEL=DEBUG|INFO|WARNING|ERROR`` — root level for every
  ``repro_torch.*`` logger (default INFO).
"""
from __future__ import annotations

import json
import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "logger": record.name,
            "level": record.levelname,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def _make_formatter() -> logging.Formatter:
    if os.environ.get("REPRO_LOG_FORMAT", "").lower() == "json":
        return _JsonFormatter()
    return logging.Formatter(_FORMAT, datefmt="%H:%M:%S")


def _level() -> int:
    name = os.environ.get("REPRO_LOG_LEVEL", "INFO").upper()
    return getattr(logging, name, logging.INFO)


def get_logger(name: str = "repro_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_make_formatter())
        logger.addHandler(handler)
        logger.setLevel(_level())
        logger.propagate = False
    return logger
