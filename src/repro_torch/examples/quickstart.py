"""Quickstart: mobility-aware asynchronous federated learning with MADS.

Trains the paper's CIFAR-10 setup (synthetic stand-in, reduced-width
ResNet-9) with one mobile edge server and 8 mobile devices under the
exponential contact model, using the MADS controller for dynamic
sparsification + power control.  The twin of the reference's
``examples/quickstart.py``; runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.configs import FLConfig, get_config
from repro_torch.core.runner import run_afl
from repro_torch.data import DeviceLoader, SyntheticCifar, dirichlet_partition
from repro_torch.models.registry import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("resnet9-cifar10").replace(d_model=8)  # reduced width
    model = build_model(cfg)
    fl = FLConfig(
        num_devices=8, rounds=60, batch_size=16, learning_rate=0.02,
        mean_contact=6.0, mean_intercontact=30.0,  # mobility (paper §III-B)
        energy_budget=(40.0, 80.0), lyapunov_v=1e-4,  # MADS (paper §V)
        dirichlet_rho=10.0,  # non-iid level (paper §VI)
    )
    ds = SyntheticCifar(noise=0.3)
    imgs, labels = ds.make_split(800, seed=1)
    parts = dirichlet_partition(labels, fl.num_devices, fl.dirichlet_rho, seed=1)
    loader = DeviceLoader(
        [{"images": imgs[p], "labels": labels[p]} for p in parts], fl.batch_size
    )
    eval_batch = dict(zip(("images", "labels"), ds.make_split(256, seed=2)))

    res = run_afl(model, cfg, fl, "mads", loader, eval_batch,
                  rounds=fl.rounds, eval_every=10, log_progress=True,
                  device=args.device)
    print("\nround  accuracy  cumulative-uploads  mean-k  energy(J)")
    for r, a, u, k, e in zip(res.history["round"], res.history["eval"],
                             res.history["uploads"], res.history["k_mean"],
                             res.history["energy"]):
        print(f"{r:5d}  {a:8.4f}  {u:18.0f}  {k:6.0f}  {e:9.1f}")
    print(f"\nfinal accuracy: {res.final_eval:.4f} "
          f"(params={model.num_params():,}, sparsifier adapts k per contact)")
    return res


if __name__ == "__main__":
    main()
