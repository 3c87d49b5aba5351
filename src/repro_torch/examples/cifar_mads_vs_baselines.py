"""Paper Fig. 8/9 style comparison: MADS vs the §VI-B benchmarks on
(synthetic) CIFAR-10 under a non-iid split and moderate mobility.

The twin of the reference's ``examples/cifar_mads_vs_baselines.py``: each
policy's three seeds run as ONE seed-batched run of the whole-run engine
(repro_torch/experiments: on the card, one captured round replayed 39
times) instead of 3 x 40 per-round dispatches, and the table reports
mean±CI across seeds.  Runs on the card unless ``--device cpu``.

Expected ordering (paper §VI-B): optimal >= mads >= afl-spar >= {afl,
fedmobile} >> sfl-spar.  The codec policies (repro_torch/compression)
spend the same MADS bit budget differently: mads-joint >= mads (more
coordinates per contact at a few bits each), qsgd degrades when short
contacts cannot afford dense quantisation.

    PYTHONPATH=src python -m repro_torch.examples.cifar_mads_vs_baselines \
        [--rounds 40] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import FLConfig, get_config
from repro_torch.data import SyntheticCifar, dirichlet_partition
from repro_torch.experiments import DataShard, mean_ci, run_seed_batch
from repro_torch.models.registry import build_model

POLICIES = ["optimal", "mads", "mads-joint", "qsgd", "fixed-kb",
            "afl-spar", "fedmobile", "afl", "sfl-spar"]
SEEDS = [0, 1, 2]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("resnet9-cifar10").replace(d_model=8)
    model = build_model(cfg)
    fl = FLConfig(
        num_devices=8, rounds=args.rounds, batch_size=16, learning_rate=0.02,
        mean_contact=2.0, mean_intercontact=30.0,  # short windows: spar matters
        energy_budget=(40.0, 80.0), dirichlet_rho=1.0,
    )
    ds = SyntheticCifar(noise=0.3)
    imgs, labels = ds.make_split(800, seed=1)
    parts = dirichlet_partition(labels, fl.num_devices, fl.dirichlet_rho, seed=1)
    shard = DataShard(
        [{"images": imgs[p], "labels": labels[p]} for p in parts],
        fl.batch_size, device=args.device,
    )
    ev = dict(zip(("images", "labels"), ds.make_split(256, seed=2)))

    print(f"{'policy':10s} {'accuracy':>15s} {'uploads':>8s} {'energy(J)':>10s}"
          f" {'Mbit/upl':>9s}")
    rows = []
    for pol in POLICIES:
        results = run_seed_batch(model, cfg, fl, pol, shard, ev, seeds=SEEDS,
                                 rounds=fl.rounds, eval_every=fl.rounds,
                                 device=args.device)
        acc, ci = mean_ci([r.final_eval for r in results])
        uploads = np.mean([r.history["uploads"][-1] for r in results])
        energy = np.mean([r.history["energy"][-1] for r in results])
        mbits = np.mean([r.history["bits_mean"][-1] for r in results]) / 1e6
        print(f"{pol:10s} {acc:9.4f}±{ci:<5.4f} {uploads:8.0f} {energy:10.1f}"
              f" {mbits:9.2f}")
        rows.append(dict(policy=pol, acc=acc, ci=ci, uploads=float(uploads),
                         energy=float(energy), mbits=float(mbits)))
    return rows


if __name__ == "__main__":
    main()
