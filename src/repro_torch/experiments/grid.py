"""Declarative experiment grids: policies x mobility x speeds x dropout x seeds.

A paper figure is a grid of AFL runs differing only in scenario knobs and
the upload policy.  ``ExperimentGrid`` enumerates the cells, derives each
cell's ``FLConfig``, and groups same-shape cells so the batch engine
(``batch.py``) runs the seed axis of a group as one captured round.
``engine_policy`` and ``engine_fl`` project a policy and a config onto
what that round reads — e.g. FedAsync and FedMobile differ only in the
schedule transform, so both project onto the same round.

The ``dropouts`` axis sweeps the heterogeneity layer
(``scenarios/heterogeneity``): each value becomes ``fl.het_dropout`` for
the cell, gating contact windows with client dropout.  The default
``(0.0,)`` keeps the axis collapsed — and cell slugs identical to the
pre-heterogeneity store keys, so existing result stores resolve unchanged.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field

from repro_torch.configs import FLConfig
from repro_torch.core import baselines as BL
from repro_torch.core.afl import Policy


@dataclass(frozen=True)
class GridCell:
    """One experiment: a (policy, mobility, speed, dropout, seed) point."""

    policy: str
    mobility: str
    speed: float
    seed: int
    dropout: float = 0.0

    def _het_slug(self) -> str:
        # zero keeps legacy slugs stable (results stores predate the axis)
        return f"__d{self.dropout:g}" if self.dropout else ""

    @property
    def key(self) -> str:
        """Stable slug used by the results store."""
        return (f"{self.policy}__{self.mobility}__v{self.speed:g}"
                f"{self._het_slug()}__s{self.seed}")

    @property
    def group_key(self) -> str:
        """Slug of the seed-batched group this cell belongs to."""
        return (f"{self.policy}__{self.mobility}__v{self.speed:g}"
                f"{self._het_slug()}")


def engine_policy(policy: Policy) -> Policy:
    """Strip bookkeeping fields that do not change the captured round.

    ``Policy.name`` is metadata: two policies whose numeric flags coincide
    (e.g. ``afl`` and ``fedmobile``) hash equal after stripping, so they
    run the same round.
    """
    return dataclasses.replace(policy, name="")


def engine_fl(fl: FLConfig) -> FLConfig:
    """Project an FLConfig onto the fields the captured round reads.

    Scenario, channel, energy, and heterogeneity knobs (mobility_model,
    speed, area, bandwidth, energy_budget, het_*, scenario_backend, seed,
    ...) are consumed before the round runs — by ``build_provider``,
    ``sample_budgets``, and the policy/controller constructors — so every
    speed, mobility model and dropout level of a sweep projects onto the
    same round; this keeps only what ``afl_round``/``afl_init``/
    ``make_run_fn`` actually consume.
    """
    return FLConfig(
        num_devices=fl.num_devices,
        rounds=fl.rounds,
        learning_rate=fl.learning_rate,
        batch_size=fl.batch_size,
        sparsifier=fl.sparsifier,
        sample_size=fl.sample_size,
    )


@dataclass(frozen=True)
class ExperimentGrid:
    """The sweep specification behind a paper-style comparison table."""

    policies: tuple = ("mads",)
    mobility_models: tuple = ("exponential",)
    speeds: tuple = (0.0,)
    seeds: tuple = (0,)
    dropouts: tuple = (0.0,)  # heterogeneity axis: fl.het_dropout per cell
    rounds: int = 200
    eval_every: int = 20
    base: FLConfig = field(default_factory=FLConfig)

    def __post_init__(self):
        unknown = [p for p in self.policies if p not in BL.ALL]
        if unknown:
            raise KeyError(f"unknown policies {unknown}; known: "
                           f"{sorted(BL.ALL)}")

    def cells(self) -> list[GridCell]:
        return [
            GridCell(p, m, float(v), int(s), float(d))
            for p, m, v, d, s in itertools.product(
                self.policies, self.mobility_models, self.speeds,
                self.dropouts, self.seeds
            )
        ]

    def groups(self) -> list[tuple[str, str, float, float, list[GridCell]]]:
        """Cells bucketed by (policy, mobility, speed, dropout) — the seed
        axis of each bucket is what ``batch.run_seed_batch`` batches."""
        out = []
        for p, m, v, d in itertools.product(
            self.policies, self.mobility_models, self.speeds, self.dropouts
        ):
            out.append((p, m, float(v), float(d),
                        [GridCell(p, m, float(v), int(s), float(d))
                         for s in self.seeds]))
        return out

    def fl_for(self, mobility: str, speed: float,
               dropout: float = 0.0) -> FLConfig:
        """The cell's FLConfig: the base config with scenario knobs set."""
        return dataclasses.replace(
            self.base, mobility_model=mobility, speed=float(speed),
            het_dropout=float(dropout), rounds=self.rounds,
        )

    def size(self) -> int:
        return (len(self.policies) * len(self.mobility_models)
                * len(self.speeds) * len(self.dropouts) * len(self.seeds))
