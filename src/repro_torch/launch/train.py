"""Federated training CLI (simulation mode — the paper's experiment).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet9-cifar10 \
      --policy mads --rounds 200 --devices 20 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet9-cifar10 \
      --policy mads --mobility manhattan --speed 15 --area 500
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --reduced --policy mads --rounds 50    # federated LM fine-tuning

Runs on the card by default (``--device cuda``, which raises when CUDA is
absent); ``--device cpu`` runs the same path with the kernels' plain
versions.  The contact schedule comes from the scenario engine
(``--mobility``: the paper's exponential renewal model or one of the trace
models, rwp, gauss_markov, manhattan, hotspot and static, over an
``--area`` square with an MES of ``--comm-range`` at its centre); the trace
models build on the host (``--scenario-backend numpy``) or on the run's
device (``jax``, the reference's name for its device-resident engine, here
the torch one).  ``--dropout``, ``--availability`` and ``--compute-mean``
arm the heterogeneity layer.  The data are synthetic stand-ins generated
from the seed: CIFAR-10 for ResNet-9 (``--arch resnet9-cifar10``),
Argoverse tracks for LaneGCN (``--arch lanegcn-argoverse``, the paper's
§VI-C experiment), order-1 Markov token streams of ``--seq-len`` tokens
for the dense, moe, ssm, hybrid and vlm LM families (federated
fine-tuning; the VLM on text alone, as in the reference; ``--reduced``
runs the family's reduced variant, as the reference does: the token
generator's V x V table and N devices' (N, s) state do not fit at full
width).  The audio family is refused: its loss needs encoder frames,
which these batches do not carry.  A checkpoint of the global model and
a JSON metrics history land in ``--workdir``, in the reference's formats,
with ``telemetry.jsonl`` beside them: the phase spans and, with
``--telemetry`` (``--perdevice`` and ``--probes`` imply it), the run's
metric snapshot and the theory-vs-measured probe report
(``python -m repro_torch.telemetry.report`` renders it).
``--profile-dir`` adds a ``torch.profiler`` Chrome trace of the run.
``--engine scan`` (the default, as in the reference) runs the whole-run
engine (``experiments/scan_engine.py``): on the card, the round captured
once as a CUDA graph and replayed, minibatches drawn on the device from a
``DataShard``; ``--engine loop`` issues each round from Python, drawing
from a ``DeviceLoader``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.checkpoint import save
from repro_torch.configs import FLConfig, get_config
from repro_torch.core import baselines as BL
from repro_torch.core.runner import resolve_telemetry, run_afl
from repro_torch.data import (DeviceLoader, SyntheticCifar, SyntheticTokens,
                              SyntheticTrajectories, dirichlet_partition)
from repro_torch.experiments import DataShard
from repro_torch.models.registry import build_model
from repro_torch.telemetry import (JsonlSink, PhaseTracer, TelemetrySuite,
                                   report_from_config, to_jsonable)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.train")


def build_device_data(cfg, fl, *, train_n=2000, eval_n=512, seq_len=64,
                      seed=0):
    """Synthetic per-device datasets (numpy) and the eval batch.

    Images are split by Dirichlet class mixtures; trajectories and token
    streams (``train_n // 4`` sequences of ``seq_len``) have no classes and
    are dealt out by a seeded permutation in equal chunks."""
    if cfg.family == "vision":
        ds = SyntheticCifar(seed=seed)
        imgs, labels = ds.make_split(train_n, seed=seed + 1)
        parts = dirichlet_partition(labels, fl.num_devices, fl.dirichlet_rho,
                                    seed)
        dev = [{"images": imgs[p], "labels": labels[p]} for p in parts]
        ev = dict(zip(("images", "labels"),
                      ds.make_split(eval_n, seed=seed + 2)))
    elif cfg.family == "trajectory":
        ds = SyntheticTrajectories(seed=seed)
        data = ds.make_split(train_n, seed=seed + 1)
        order = np.random.default_rng(seed).permutation(train_n)
        chunks = np.array_split(order, fl.num_devices)
        dev = [{k: v[c] for k, v in data.items()} for c in chunks]
        ev = ds.make_split(eval_n, seed=seed + 2)
    elif cfg.family == "audio":
        raise NotImplementedError(
            "federated fine-tuning of the audio family is refused, as it "
            "fails in the reference: these token batches carry no 'frames' "
            "(encoder inputs), and the enc-dec loss_fn needs them; the "
            "distributed round (core/distributed.py) trains it on batches "
            "that carry them")
    else:  # the language families: order-1 Markov streams (VLM: text only)
        ds = SyntheticTokens(vocab_size=cfg.vocab_size, seed=seed)
        data = ds.make_split(train_n // 4, seq_len, seed=seed + 1)
        order = np.random.default_rng(seed).permutation(len(data["tokens"]))
        chunks = np.array_split(order, fl.num_devices)
        dev = [{k: v[c] for k, v in data.items()} for c in chunks]
        ev = ds.make_split(eval_n // 4, seq_len, seed=seed + 2)
    return dev, ev


def build_federation(cfg, fl, *, train_n=2000, eval_n=512, seq_len=64,
                     seed=0):
    """``build_device_data`` wrapped in the host-side DeviceLoader."""
    dev, ev = build_device_data(cfg, fl, train_n=train_n, eval_n=eval_n,
                                seq_len=seq_len, seed=seed)
    return DeviceLoader(dev, fl.batch_size, seed), ev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet9-cifar10")
    ap.add_argument("--policy", default="mads", choices=sorted(BL.ALL))
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--devices", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--rho", type=float, default=0.5, help="non-iid Dirichlet level")
    ap.add_argument("--speed", type=float, default=0.0, help="m/s; 0 = direct c/lambda")
    ap.add_argument("--mobility", default="exponential",
                    choices=["exponential", "rwp", "gauss_markov", "manhattan",
                             "hotspot", "static"],
                    help="scenario engine mobility model (scenarios/)")
    ap.add_argument("--scenario-backend", default="numpy",
                    choices=["numpy", "jax"],
                    help="scenario engine: numpy oracle kinematics on the "
                         "host, or 'jax', the device-resident engine (the "
                         "reference's name; here torch on --device, "
                         "scenarios/torch_kinematics.py; trace models only)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="heterogeneity dropout prob (fl.het_dropout)")
    ap.add_argument("--availability", type=float, default=1.0,
                    help="heterogeneity: stationary P(client available)")
    ap.add_argument("--compute-mean", type=float, default=0.0,
                    help="heterogeneity: mean Exp compute latency (s) "
                         "subtracted from each contact window")
    ap.add_argument("--area", type=float, default=1000.0, help="m, square side")
    ap.add_argument("--comm-range", type=float, default=100.0)
    ap.add_argument("--contact", type=float, default=4.0)
    ap.add_argument("--intercontact", type=float, default=400.0)
    ap.add_argument("--v-weight", type=float, default=1e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced variant (2 layers, d_model <= 256, "
                         "vocab <= 1024)")
    ap.add_argument("--width", type=int, default=0,
                    help=">0: override d_model (CPU-sized smoke runs)")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="tokens per sequence (language families)")
    ap.add_argument("--train-n", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--engine", default="scan", choices=["scan", "loop"],
                    help="scan: the whole run on the device, the round "
                         "captured once as a CUDA graph and replayed "
                         "(repro_torch/experiments); loop: per-round "
                         "dispatch from Python")
    ap.add_argument("--telemetry", action="store_true",
                    help="device-resident round metrics (repro_torch/"
                         "telemetry): staleness/bits/tau histograms + "
                         "counters, written to workdir/telemetry.jsonl")
    ap.add_argument("--perdevice", action="store_true",
                    help="also carry the per-device flight recorder (implies "
                         "--telemetry): (N,) participation/staleness/tau/"
                         "bits/energy rows, straggler table at the end")
    ap.add_argument("--probes", action="store_true",
                    help="also carry the online theory probes (implies "
                         "--telemetry): theory-vs-measured deltas against "
                         "core/theory.py closed forms, emitted as a "
                         "probe_report event")
    ap.add_argument("--profile-dir", default="",
                    help="torch.profiler Chrome trace dir (trace.json); also "
                         "annotates the compile/execute/eval phase spans")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default="runs/train")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.width > 0:
        cfg = cfg.replace(d_model=args.width)
    model = build_model(cfg)
    fl = FLConfig(
        num_devices=args.devices, rounds=args.rounds, batch_size=args.batch_size,
        learning_rate=args.lr, dirichlet_rho=args.rho, speed=args.speed,
        mobility_model=args.mobility, area=args.area, comm_range=args.comm_range,
        mean_contact=args.contact, mean_intercontact=args.intercontact,
        lyapunov_v=args.v_weight, seed=args.seed,
        scenario_backend=args.scenario_backend,
        het_dropout=args.dropout, het_availability=args.availability,
        het_compute_mean=args.compute_mean,
        sparsifier="exact" if model.num_params() < 2_000_000 else "sampled",
        telemetry=args.telemetry or args.perdevice or args.probes,
        telemetry_perdevice=args.perdevice,
        telemetry_probes=args.probes,
    )
    log.info("arch=%s params=%d policy=%s rounds=%d devices=%d device=%s",
             cfg.name, model.num_params(), args.policy, args.rounds,
             args.devices, device)

    dev, ev = build_device_data(cfg, fl, train_n=args.train_n,
                                seq_len=args.seq_len, seed=args.seed)
    if args.engine == "scan":
        # device-resident shard sampled inside the captured round; a
        # DeviceLoader would make the engine prestack every round's batch
        loader = DataShard(dev, fl.batch_size, seed=args.seed, device=device)
    else:
        loader = DeviceLoader(dev, fl.batch_size, args.seed)
    tracer = PhaseTracer(profile_dir=args.profile_dir or None)
    tracer.start()
    try:
        res = run_afl(model, cfg, fl, args.policy, loader, ev,
                      rounds=args.rounds, eval_every=args.eval_every,
                      log_progress=True, engine=args.engine, device=device,
                      tracer=tracer)
    finally:
        tracer.stop()

    os.makedirs(args.workdir, exist_ok=True)
    save(args.workdir, args.rounds, model.layout.unflatten(res.state.w))
    with open(os.path.join(args.workdir, "history.json"), "w") as f:
        json.dump({"args": vars(args), "history": res.history}, f, indent=2)
    # the same resolution run_afl used — registry alone, or the suite
    # carrying the per-device table / theory probes
    telemetry = resolve_telemetry(fl, None, s=model.num_params())
    with JsonlSink(os.path.join(args.workdir, "telemetry.jsonl")) as sink:
        sink.extend(tracer.events())
        if res.telemetry is not None:
            sink.emit({"kind": "metrics", **to_jsonable(res.telemetry)})
            if (isinstance(telemetry, TelemetrySuite)
                    and telemetry.probes is not None):
                rep = report_from_config(
                    telemetry.probes, res.telemetry["probes"], fl)
                sink.emit({"kind": "probe_report", **rep})
    if res.telemetry is not None:
        print(telemetry.summary(res.telemetry))
    log.info("phase wall clock:\n%s", tracer.summary())
    log.info("final eval=%.4f; wrote %s", res.final_eval, args.workdir)
    return res


if __name__ == "__main__":
    main()
