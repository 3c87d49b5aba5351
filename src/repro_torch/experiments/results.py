"""Resumable results store for experiment grids.

One directory per sweep: each completed cell (policy, mobility, speed,
seed) lands as ``cells/<key>.npz`` (the full metric history) and one JSON
line in ``results.jsonl`` (metadata + final eval), in the reference's
formats, so either package reads the other's directory.  A sweep
restarted over the same directory skips completed cells, so a killed
300-cell grid resumes where it stopped.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Iterable, Optional

import numpy as np

from repro_torch.experiments.grid import ExperimentGrid, GridCell
from repro_torch.telemetry import HIST_KEYS as _HIST_KEYS


def mean_ci(values, confidence: float = 0.95) -> tuple[float, float]:
    """Mean and normal-approximation confidence half-width across seeds."""
    v = np.asarray(list(values), np.float64)
    if v.size == 0:
        return float("nan"), float("nan")
    if v.size == 1:
        return float(v[0]), 0.0
    z = {0.90: 1.645, 0.95: 1.960, 0.99: 2.576}.get(round(confidence, 2), 1.960)
    return float(v.mean()), float(z * v.std(ddof=1) / math.sqrt(v.size))


class ResultsStore:
    """npz-per-cell + JSONL index under one sweep directory."""

    def __init__(self, root: str):
        self.root = root
        self.cell_dir = os.path.join(root, "cells")
        self.index_path = os.path.join(root, "results.jsonl")
        os.makedirs(self.cell_dir, exist_ok=True)

    # -- cell lifecycle -----------------------------------------------------

    def _cell_path(self, cell: GridCell) -> str:
        return os.path.join(self.cell_dir, cell.key + ".npz")

    def done(self, cell: GridCell) -> bool:
        return os.path.exists(self._cell_path(cell))

    def pending(self, cells: Iterable[GridCell]) -> list[GridCell]:
        return [c for c in cells if not self.done(c)]

    def save(self, cell: GridCell, history: dict,
             meta: Optional[dict] = None) -> None:
        arrays = {k: np.asarray(history[k]) for k in _HIST_KEYS
                  if k in history}
        # write-then-rename: a kill mid-save must not leave a truncated npz
        # that done() would treat as a completed cell on resume
        path = self._cell_path(cell)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # file object: savez won't append ".npz"
            np.savez(f, **arrays)
        os.replace(tmp, path)
        rec = dict(dataclasses.asdict(cell), cell=cell.key,
                   final_eval=float(history["eval"][-1]),
                   uploads=float(history["uploads"][-1]))
        if meta:
            rec.update(meta)
        with open(self.index_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def load(self, cell: GridCell) -> dict:
        with np.load(self._cell_path(cell)) as z:
            return {k: z[k].tolist() for k in z.files}

    # -- aggregation --------------------------------------------------------

    def aggregate(self, grid: ExperimentGrid, metric: str = "eval") -> dict:
        """mean±CI of the final ``metric`` across seeds, per grid group.

        Returns ``{(policy, mobility, speed, dropout): (mean, ci,
        n_seeds)}`` over the groups whose cells are (at least partially)
        complete.
        """
        out = {}
        for policy, mobility, speed, dropout, cells in grid.groups():
            finals = [self.load(c)[metric][-1] for c in cells if self.done(c)]
            if finals:
                m, ci = mean_ci(finals)
                out[(policy, mobility, speed, dropout)] = (m, ci, len(finals))
        return out

    def table(self, grid: ExperimentGrid, metric: str = "eval") -> str:
        """Paper-style comparison table: policy rows x (mobility, speed[,
        dropout]) columns of final-metric mean±CI.  The dropout suffix only
        appears when the grid actually sweeps the heterogeneity axis."""
        agg = self.aggregate(grid, metric)
        dropouts = getattr(grid, "dropouts", (0.0,))
        cols = [(m, v, d) for m in grid.mobility_models
                for v in grid.speeds for d in dropouts]
        head = f"{'policy':>12s}"
        for m, v, d in cols:
            label = m[:10] + "@v" + format(v, "g")
            if len(dropouts) > 1 or d:
                label += "@d" + format(d, "g")
            head += f" {label:>18s}"
        lines = [head]
        for p in grid.policies:
            row = f"{p:>12s}"
            for m, v, d in cols:
                cell = agg.get((p, m, float(v), float(d)))
                row += (f" {cell[0]:>10.4f}±{cell[1]:<6.4f}"
                        if cell else f" {'—':>18s}")
            lines.append(row)
        return "\n".join(lines)
