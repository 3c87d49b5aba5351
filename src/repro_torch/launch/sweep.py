"""Grid sweep CLI — a paper-style comparison table in one command.

    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --arch resnet9-cifar10 --policies mads,afl-spar,afl \
        --speeds 5,10,20 --mobility exponential --seeds 3 \
        --rounds 60 --devices 8 --out runs/sweep

Compression-codec comparison (one command, resumable — how the same
contact bit budget is best spent; see repro_torch/compression):

    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --arch resnet9-cifar10 --policies mads,mads-joint,qsgd,fixed-kb \
        --speeds 10 --seeds 3 --rounds 60 --out runs/codecs

``--codec`` is shorthand for a single codec policy (topk | joint | qsgd |
fixed-kb) and ``--per-layer`` upgrades the joint codec to per-leaf (k_l,
b_l) budgets.  Runs on the card by default (``--device cuda``, which
raises when CUDA is absent); ``--device cpu --width 4`` is a small sweep
on the CPU.  ``--mesh N`` spreads each group's seeds over N processes, one
a card (gloo ranks on the CPU with ``--device cpu``), the reference's seed
mesh (``launch/mesh.py::make_seed_mesh``); it runs under ``torchrun``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.sweep ... --mesh 4

Every rank runs its share of each group's seeds and receives all the
histories; rank 0 alone writes the results, the telemetry and the table.

Every (policy, mobility, speed, dropout) group runs its seeds as ONE
seed-batched run (repro_torch/experiments: on the card, one captured
round replayed); completed cells found in --out are skipped, so an
interrupted sweep resumes.  Results: per-cell npz histories +
results.jsonl under --out (the reference's formats), telemetry.jsonl
beside them, and a final mean±CI table on stdout.
"""
from __future__ import annotations

import argparse
import os
import time
from contextlib import nullcontext

from repro_torch.configs import FLConfig, get_config
from repro_torch.core import baselines as BL
from repro_torch.experiments import (DataShard, ExperimentGrid, ResultsStore,
                                     run_seed_batch)
from repro_torch.launch.mesh import local_device, make_seed_mesh
from repro_torch.launch.train import build_device_data
from repro_torch.models.registry import build_model
from repro_torch.telemetry import (AFL_REGISTRY, DeviceTable, JsonlSink,
                                   PhaseTracer, TelemetrySuite, TheoryProbes,
                                   merge_fetched, render_report,
                                   report_from_config, to_jsonable)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.sweep")


def run_sweep(grid: ExperimentGrid, store: ResultsStore, model, cfg, shard,
              eval_batch, mesh=None, metric: str = "eval", telemetry=None,
              tracer=None, sink=None, write: bool = True) -> str:
    """Execute every pending cell of ``grid`` into ``store``; returns the
    comparison table.  The groups run on ``shard``'s device, each group's
    seeds over the seed ``mesh`` when one is given; ``write=False`` (the
    other ranks of a mesh) saves no cell and emits no event.

    ``telemetry`` (a ``repro_torch.telemetry.MetricRegistry`` or
    ``TelemetrySuite``) instruments every group's run; per-group merged
    snapshots land in ``sink`` (a ``JsonlSink``) as ``group_metrics``
    events plus one sweep-wide ``metrics`` event.  A suite with probes
    additionally emits one ``probe_report`` event per group — the theory
    closed forms evaluated at that group's (c, lam, delta) contact point.
    ``tracer`` records one span per executed group.
    """
    span = tracer.span if tracer is not None else (
        lambda name, **kw: nullcontext())
    probes = telemetry.probes if isinstance(telemetry, TelemetrySuite) \
        else None
    snapshots = []
    for policy, mobility, speed, dropout, cells in grid.groups():
        todo = store.pending(cells)
        if not todo:
            log.info("group %s: all %d seeds done, skipping",
                     cells[0].group_key, len(cells))
            continue
        fl = grid.fl_for(mobility, speed, dropout)
        t0 = time.time()
        with span("group", group=cells[0].group_key):
            results = run_seed_batch(
                model, cfg, fl, policy, shard, eval_batch,
                seeds=[c.seed for c in todo], rounds=grid.rounds,
                eval_every=grid.eval_every, mesh=mesh, telemetry=telemetry,
                device=shard.device,
            )
        wall = time.time() - t0
        if write:
            for cell, res in zip(todo, results):
                store.save(cell, res.history,
                           meta={"arch": cfg.name, "rounds": grid.rounds,
                                 "wall_s": round(wall / len(todo), 3)})
        snaps = [r.telemetry for r in results if r.telemetry is not None]
        if snaps and write:
            gsnap = merge_fetched(snaps)
            snapshots.append(gsnap)
            if sink is not None:
                sink.emit({"kind": "group_metrics",
                           "group": cells[0].group_key,
                           "seeds": len(todo), **to_jsonable(gsnap)})
                if probes is not None and gsnap.get("probes") is not None:
                    rep = report_from_config(probes, gsnap["probes"], fl)
                    sink.emit({"kind": "probe_report",
                               "group": cells[0].group_key, **rep})
        log.info("group %s: %d seeds in %.1fs (%.1f rounds/s)",
                 cells[0].group_key, len(todo), wall,
                 grid.rounds * len(todo) / max(wall, 1e-9))
    if snapshots:
        total = merge_fetched(snapshots)
        if sink is not None:
            sink.emit({"kind": "metrics", **to_jsonable(total)})
        if telemetry is not None:
            log.info("sweep metrics:\n%s", telemetry.summary(total))
    return store.table(grid, metric)


# --codec shorthand -> the policy (MADS power, codec-only difference)
CODEC_POLICIES = {
    "topk": "mads-topk",
    "joint": "mads-joint",
    "qsgd": "qsgd",
    "fixed-kb": "fixed-kb",
}


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet9-cifar10")
    ap.add_argument("--policies", default="mads,afl-spar,afl",
                    help="comma-separated subset of: " + ",".join(BL.ALL))
    ap.add_argument("--codec", choices=sorted(CODEC_POLICIES),
                    help="single-codec shorthand; overrides --policies")
    ap.add_argument("--per-layer", action="store_true",
                    help="joint codec: per-leaf (k_l, b_l) bit budgets "
                         "(repro_torch/compression/perlayer.py)")
    ap.add_argument("--mesh", type=int, default=0,
                    help=">1: shard the seed axis over this many processes, "
                         "one a card, under torchrun --nproc-per-node N")
    ap.add_argument("--mobility", default="exponential",
                    help="comma-separated mobility models "
                         "(exponential|rwp|gauss_markov|manhattan|hotspot|static)")
    ap.add_argument("--speeds", default="10",
                    help="comma-separated device speeds (m/s)")
    ap.add_argument("--dropouts", default="0",
                    help="comma-separated heterogeneity dropout levels "
                         "(fl.het_dropout; repro_torch/scenarios/heterogeneity)")
    ap.add_argument("--scenario-backend", default="numpy",
                    choices=["numpy", "jax"],
                    help="scenario engine: numpy oracle kinematics on the "
                         "host, or 'jax', the device-resident engine (the "
                         "reference's name; here torch on --device; trace "
                         "models only)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="seeds per cell (0..seeds-1)")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--rho", type=float, default=0.5)
    ap.add_argument("--train-n", type=int, default=800)
    ap.add_argument("--contact-const", type=float, default=40.0)
    ap.add_argument("--intercontact-const", type=float, default=300.0)
    ap.add_argument("--energy", type=float, nargs=2, default=(40.0, 80.0))
    ap.add_argument("--fixed-k-frac", type=float, default=0.01,
                    help="fixed-kb codec: keep-fraction target")
    ap.add_argument("--fixed-bits", type=int, default=8,
                    help="fixed-kb codec: value bit-width")
    ap.add_argument("--staleness", default="constant",
                    choices=("constant", "hinge", "poly"),
                    help="alpha * s(delta_tau) mixing family "
                         "(core.afl.StalenessWeight)")
    ap.add_argument("--staleness-alpha", type=float, default=1.0,
                    help="mixing weight scale alpha")
    ap.add_argument("--b-range", type=int, nargs=2, default=(2, 16),
                    help="joint/qsgd codecs: value bit-width search range")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--width", type=int, default=0,
                    help=">0: override d_model (CPU-sized sweeps)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable the device-resident metric registry "
                         "(on by default; snapshots land in "
                         "--out/telemetry.jsonl)")
    ap.add_argument("--perdevice", action="store_true",
                    help="carry the per-device flight recorder "
                         "(repro_torch/telemetry/perdevice.py): (N,) rows "
                         "of participation/staleness/tau/bits/energy, "
                         "straggler table at fetch")
    ap.add_argument("--probes", action="store_true",
                    help="carry the online theory probes "
                         "(repro_torch/telemetry/probes.py): one "
                         "probe_report event per group comparing measured "
                         "error/staleness/success against core/theory.py")
    ap.add_argument("--report", action="store_true",
                    help="render --out/report.md from the telemetry "
                         "events after the sweep (same renderer as "
                         "python -m repro_torch.telemetry.report)")
    ap.add_argument("--profile-dir", default="",
                    help="torch.profiler Chrome trace dir for the sweep")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--out", default="runs/sweep")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.mesh > 1:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != args.mesh:
            raise ValueError(
                f"--mesh {args.mesh} runs under torchrun --nproc-per-node "
                f"{args.mesh}; this process group has WORLD_SIZE {world}")
        rank = int(os.environ["RANK"])
        mesh = make_seed_mesh(args.seeds, device=device)
        device = local_device(device)
    if args.codec:
        args.policies = CODEC_POLICIES[args.codec]

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.width > 0:
        cfg = cfg.replace(d_model=args.width)
    model = build_model(cfg)

    base = FLConfig(
        num_devices=args.devices, rounds=args.rounds,
        batch_size=args.batch_size, learning_rate=args.lr,
        dirichlet_rho=args.rho, contact_const=args.contact_const,
        intercontact_const=args.intercontact_const,
        energy_budget=tuple(args.energy),
        sparsifier="exact" if model.num_params() < 2_000_000 else "sampled",
        fixed_k_frac=args.fixed_k_frac, fixed_bits=args.fixed_bits,
        compress_b_min=args.b_range[0], compress_b_max=args.b_range[1],
        per_layer_budget=args.per_layer,
        staleness_family=args.staleness, staleness_alpha=args.staleness_alpha,
        scenario_backend=args.scenario_backend,
    )
    grid = ExperimentGrid(
        policies=tuple(args.policies.split(",")),
        mobility_models=tuple(args.mobility.split(",")),
        speeds=tuple(float(v) for v in args.speeds.split(",")),
        dropouts=tuple(float(d) for d in args.dropouts.split(",")),
        seeds=tuple(range(args.seeds)),
        rounds=args.rounds, eval_every=args.eval_every, base=base,
    )
    log.info("grid: %d cells (%d groups x %d seeds), arch=%s params=%d "
             "device=%s", grid.size(), len(grid.groups()), args.seeds,
             cfg.name, model.num_params(), device)

    dev, ev = build_device_data(cfg, base, train_n=args.train_n, seed=0)
    shard = DataShard(dev, base.batch_size, seed=0, device=device)
    store = ResultsStore(args.out)
    write = rank == 0

    telemetry = None if args.no_telemetry else AFL_REGISTRY
    if telemetry is not None and (args.perdevice or args.probes):
        telemetry = TelemetrySuite(
            metrics=AFL_REGISTRY,
            device=DeviceTable(args.devices) if args.perdevice else None,
            probes=(TheoryProbes(s=model.num_params(), u=base.value_bits)
                    if args.probes else None),
        )
    tracer = PhaseTracer(profile_dir=args.profile_dir or None)
    tracer.start()
    sink = JsonlSink(os.path.join(args.out, "telemetry.jsonl"))
    try:
        table = run_sweep(grid, store, model, cfg, shard, ev, mesh=mesh,
                          telemetry=telemetry, tracer=tracer, sink=sink,
                          write=write)
        sink.extend(tracer.events())
        if sink.events and write:  # a fully-resumed sweep must not blank
            sink.flush()  # the previous invocation's telemetry artifact
    finally:
        tracer.stop()
        if mesh is not None:
            mesh.close()
    if not write:
        return table
    print(table)
    if args.report:
        report_path = os.path.join(args.out, "report.md")
        with open(report_path, "w") as f:
            f.write(render_report(
                sink.events, title=f"Sweep report — {cfg.name}"))
        log.info("run report: %s", report_path)
    log.info("group wall clock:\n%s", tracer.summary())
    log.info("results under %s (cells/*.npz + results.jsonl + "
             "telemetry.jsonl)", args.out)
    return table


if __name__ == "__main__":
    main()
