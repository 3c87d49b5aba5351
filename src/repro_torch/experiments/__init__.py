"""Whole-run experiment engine: an AFL run as one captured round on the
card, scaled across policy x mobility x speed x seed grids."""
from repro_torch.experiments.batch import run_seed_batch
from repro_torch.experiments.grid import ExperimentGrid, GridCell
from repro_torch.experiments.results import ResultsStore, mean_ci
from repro_torch.experiments.scan_engine import (
    DataShard,
    make_run_fn,
    prestack_batches,
    run_afl_scanned,
)

__all__ = [
    "DataShard",
    "ExperimentGrid",
    "GridCell",
    "ResultsStore",
    "make_run_fn",
    "mean_ci",
    "prestack_batches",
    "run_afl_scanned",
    "run_seed_batch",
]
