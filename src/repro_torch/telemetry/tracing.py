"""Wall-clock span/phase tracing with asynchronous-launch-safe fencing.

CUDA launches are asynchronous: ``time.perf_counter()`` after a launch
times the *enqueue*, not the work, unless the caller waits for the card.
``PhaseTracer.span`` records honest wall-clock phases (compile vs execute
vs eval) when the caller fences inside the span (``tracer.fence(out)``,
which synchronises when ``out`` holds a CUDA tensor); repeated spans with
the same name aggregate in the summary, so per-round spans stay readable.

Optional profiler hooks: constructing the tracer with ``profile_dir``
(the ``--profile-dir`` flag of the train CLI) wraps each span in
``torch.profiler.record_function`` and brackets the run with a
``torch.profiler.profile`` of the CPU and, where CUDA is available, the
card (``start``/``stop``); ``stop`` exports a Chrome trace,
``<profile_dir>/trace.json``, in which the spans line up with the
kernels.  A profiler that fails to start or to export raises.  Without
``profile_dir`` a span costs two ``perf_counter`` calls and a list append.
"""
from __future__ import annotations

import dataclasses
import os
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch


@dataclasses.dataclass
class Span:
    name: str
    start: float  # perf_counter seconds
    duration: float
    meta: dict
    parent: Optional[str] = None  # enclosing span's name (nesting)
    depth: int = 0  # nesting depth at entry (0 = top level)
    error: Optional[str] = None  # exception type name if the body raised


def _holds_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_holds_cuda(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_holds_cuda(v) for v in x)
    return False


class PhaseTracer:
    """Collects named wall-clock spans; optionally mirrors them into
    ``torch.profiler`` when ``profile_dir`` is set."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.profile_dir = profile_dir or None
        self.spans: list[Span] = []
        self.trace_path: Optional[str] = None  # set by stop()
        self._prof = None
        self._stack: list[str] = []  # open span names (nesting)

    # -- spans ---------------------------------------------------------------

    @contextmanager
    def span(self, name: str, **meta):
        """Record a wall-clock span.  Exception-safe: a body that raises
        still lands its span (with the exception type under ``error``).
        Spans nest — an inner span records its enclosing span as
        ``parent`` and its ``depth``, surfaced by ``events()``."""
        ann = (torch.profiler.record_function(name)
               if self.profile_dir is not None else nullcontext())
        with ann:
            parent = self._stack[-1] if self._stack else None
            depth = len(self._stack)
            self._stack.append(name)
            err: Optional[str] = None
            t0 = time.perf_counter()
            try:
                yield self
            except BaseException as e:
                err = type(e).__name__
                raise
            finally:
                self._stack.pop()
                self.spans.append(
                    Span(name, t0, time.perf_counter() - t0, dict(meta),
                         parent=parent, depth=depth, error=err)
                )

    @staticmethod
    def fence(x):
        """Wait for the card when ``x`` (a tensor, or a dict / list / tuple
        of them) holds a CUDA tensor; a no-op on host data.  Call before
        leaving a span so its wall time covers the work."""
        if _holds_cuda(x):
            torch.cuda.synchronize()
        return x

    # -- profiler bracket ----------------------------------------------------

    def start(self) -> None:
        """Begin a profile for ``profile_dir`` (no-op without)."""
        if self.profile_dir is None or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
        self._prof = prof

    def stop(self) -> None:
        """End the profile and export its Chrome trace (no-op without a
        profile running)."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(self.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        self.trace_path = path

    # -- reporting -----------------------------------------------------------

    def totals(self) -> dict:
        """name -> {count, total_s, max_s} aggregated over spans."""
        out: dict = {}
        for s in self.spans:
            agg = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                          "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += s.duration
            agg["max_s"] = max(agg["max_s"], s.duration)
        return out

    def summary(self) -> str:
        lines = [f"{'phase':<24s} {'count':>6s} {'total_s':>10s} "
                 f"{'mean_ms':>10s} {'max_ms':>10s}"]
        for name, agg in self.totals().items():
            lines.append(
                f"{name:<24s} {agg['count']:>6d} {agg['total_s']:>10.3f} "
                f"{agg['total_s'] / agg['count'] * 1e3:>10.2f} "
                f"{agg['max_s'] * 1e3:>10.2f}"
            )
        return "\n".join(lines)

    def events(self) -> list[dict]:
        """Span records for the JSONL sink (parent/depth attribute nested
        spans; ``error`` marks spans whose body raised)."""
        out = []
        for s in self.spans:
            ev = {"kind": "span", "name": s.name,
                  "start_s": round(s.start, 6),
                  "duration_s": round(s.duration, 6), **s.meta}
            if s.parent is not None:
                ev["parent"] = s.parent
                ev["depth"] = s.depth
            if s.error is not None:
                ev["error"] = s.error
            out.append(ev)
        return out
