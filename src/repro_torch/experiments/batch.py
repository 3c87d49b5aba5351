"""Seed batching of the whole-run engine: S seeds of a group in one run.

One grid group = one (policy, mobility, speed) point replicated over S
seeds.  The reference vmaps its compiled run over a leading seed axis.
The sparsify kernels here are launched through ctypes on a tensor's data
pointer, which a ``torch.func.vmap`` batched tensor does not have, so the
seed axis is folded into the rows instead: the S federations of N devices
are one (S N, s) federation whose global model is (S, s) (``core/afl.py``:
the thresholds, the codecs and the one kernel launch work row by row over
all S N rows; the gradients and the aggregation run group by group, in the
single federation's shapes, so that each seed's arithmetic is its own
run's).  Everything that varies per seed — scenario rows, budgets, the
initial federation state, the dither seeds, the minibatch key — is
stacked seed by seed along the device axis, and
``scan_engine.make_run_fn`` runs the whole group as one captured round
on the card.  Each seed keeps its own telemetry state, fetched on its
own.  With one card there is no seed mesh (ROADMAP.md, queue 1 item 5).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.afl import afl_init
from repro_torch.core.runner import RunResult
from repro_torch.experiments.scan_engine import run_seeds
from repro_torch.utils.device import resolve_device


def run_seed_batch(
    model,
    cfg,
    fl,
    policy_name: str,
    shard,
    eval_batch,
    seeds: Sequence[int],
    rounds: Optional[int] = None,
    eval_every: int = 20,
    mesh=None,
    telemetry=None,
    device="cuda",
) -> list[RunResult]:
    """All ``seeds`` of one grid group in a single run on ``device``.

    Scenario schedules, budgets and dither seeds are built per seed and
    stacked to (rounds, S N) device tensors; minibatches come from the
    ``DataShard`` ``shard`` (on ``device``) under each seed's key.
    Returns one ``RunResult`` per seed whose history matches an
    independent ``run_afl_scanned`` of that seed (bit for bit where the
    convolutions are deterministic: on the CPU, and on the card under
    ``torch.backends.cudnn.deterministic``).

    ``telemetry``: a registry or suite; each RunResult carries its seed's
    fetched snapshot (merge them with ``repro_torch.telemetry.
    merge_fetched``).  ``mesh`` must be None: sharding seeds across cards
    waits for the distributed step.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a seed mesh across cards is not ported (ROADMAP.md, queue 1 "
            "item 5: the distributed step); run with mesh=None")
    device = resolve_device(device)
    if shard.device != device:
        raise ValueError(f"the DataShard is on {shard.device}, the run on "
                         f"{device}")
    seeds = [int(sd) for sd in seeds]
    return run_seeds(
        model, cfg, fl, policy_name,
        [afl_init(model, fl, sd, device) for sd in seeds], seeds,
        shard.traced_batch, torch.stack([shard.seed_key(sd) for sd in seeds]),
        eval_batch, rounds=rounds or fl.rounds, eval_every=eval_every,
        telemetry=telemetry)
