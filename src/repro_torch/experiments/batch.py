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
own.

On a seed mesh (``launch/mesh.py::make_seed_mesh``: one process a card)
rank r runs seeds [r S/P, (r + 1) S/P) as one such run on its own card,
and the histories, telemetry snapshots and timings of all S seeds are
gathered over the group (one ``all_gather_object``), so that every rank
returns S ``RunResult``s in seed order.  A seed's final state stays on
the card of the rank that ran it (at full-width ResNet-9 a seed's state
is ~2 GB): on the other ranks ``RunResult.state`` is None.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.afl import afl_init
from repro_torch.core.runner import RunResult
from repro_torch.experiments.scan_engine import run_seeds
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.batch")


def _usable_mesh(mesh, num_seeds: int):
    """The mesh if its ranks split the seed axis evenly, else None (run
    unsharded, every rank all the seeds), as the reference decides."""
    if mesh is None:
        return None
    if num_seeds % mesh.world_size:
        log.warning("seeds=%d not divisible by mesh size %d; running "
                    "unsharded", num_seeds, mesh.world_size)
        return None
    return mesh


def _gather(results: list, mesh) -> list[RunResult]:
    """Every rank's seeds' results, in seed order, on every rank; the
    states only where they were run."""
    keep = ("policy", "history", "final_eval", "round_seconds", "telemetry",
            "eval_seconds")
    mine = [{k: getattr(r, k) for k in keep} for r in results]
    parts = [None] * mesh.world_size
    dist.all_gather_object(parts, mine, group=mesh.group)
    out = []
    for rank, part in enumerate(parts):
        for i, fields in enumerate(part):
            out.append(RunResult(state=results[i].state if rank == mesh.rank
                                 else None, **fields))
    return out


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
    merge_fetched``).  ``mesh``: a seed mesh (a ``ClientMesh`` whose rows
    are seeds; the run's device is its card); when S does not split
    evenly over it, every rank runs all S seeds, as the reference does.
    """
    device = resolve_device(device)
    if shard.device != device:
        raise ValueError(f"the DataShard is on {shard.device}, the run on "
                         f"{device}")
    seeds = [int(sd) for sd in seeds]
    mesh = _usable_mesh(mesh, len(seeds))
    mine = seeds if mesh is None else seeds[mesh.rows(len(seeds))]
    results = run_seeds(
        model, cfg, fl, policy_name,
        [afl_init(model, fl, sd, device) for sd in mine], mine,
        shard.traced_batch, torch.stack([shard.seed_key(sd) for sd in mine]),
        eval_batch, rounds=rounds or fl.rounds, eval_every=eval_every,
        telemetry=telemetry)
    return results if mesh is None else _gather(results, mesh)
