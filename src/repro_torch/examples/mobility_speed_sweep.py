"""Paper Fig. 5 / Corollary 1: the two-sided effect of device speed,
swept across the scenario engine's mobility models.

For the exponential renewal model the speed coupling is analytic
(c = C/v, lambda = L/v); for the trace models (random waypoint,
Gauss-Markov, Manhattan grid, hotspot clusters) contacts AND channel
gains emerge from the simulated motion via ``ScenarioProvider``.
Accuracy should peak at moderate speed while the Corollary-1 bound dips.
The twin of the reference's ``examples/mobility_speed_sweep.py``; runs
on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.mobility_speed_sweep \
        [--models rwp,...] [--rounds 30] [--device cpu]
"""
import argparse

from repro_torch.configs import FLConfig, get_config
from repro_torch.core import theory as T
from repro_torch.core.runner import run_afl
from repro_torch.data import DeviceLoader, SyntheticCifar, dirichlet_partition
from repro_torch.mobility.waypoint import measure_contact_stats
from repro_torch.models.registry import build_model
from repro_torch.scenarios import ScenarioProvider, model_from_config

SPEEDS = [1.0, 4.0, 16.0, 48.0]
MODELS = ["exponential", "rwp", "gauss_markov", "manhattan", "hotspot"]
C_CONST, L_CONST = 40.0, 300.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(MODELS),
                    help="comma-separated subset of: " + ",".join(MODELS))
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("resnet9-cifar10").replace(d_model=8)
    model = build_model(cfg)
    ds = SyntheticCifar(noise=0.3)
    imgs, labels = ds.make_split(800, seed=1)
    parts = dirichlet_partition(labels, 8, rho=100.0, seed=1)
    dev = [{"images": imgs[p], "labels": labels[p]} for p in parts]
    ev = dict(zip(("images", "labels"), ds.make_split(256, seed=2)))

    print(f"{'model':>12s} {'speed':>6s} {'contact':>8s} {'intercont':>10s} "
          f"{'uploads':>8s} {'acc':>7s} {'bound':>10s}")
    rows = []
    for name in args.models.split(","):
        for v in SPEEDS:
            fl = FLConfig(
                num_devices=8, rounds=args.rounds, batch_size=16,
                learning_rate=0.02, speed=v, contact_const=C_CONST,
                intercontact_const=L_CONST, energy_budget=(40.0, 80.0),
                mobility_model=name, area=600.0,
            )
            loader = DeviceLoader(dev, fl.batch_size)
            prov = ScenarioProvider.from_config(fl, device=args.device)
            res = run_afl(model, cfg, fl, "afl-spar", loader, ev,
                          rounds=args.rounds, eval_every=args.rounds,
                          schedule=prov, device=args.device)
            # realised contact statistics: analytic for the renewal model,
            # measured on a long kinematic trace for the trace models
            if name == "exponential":
                c_emp, gaps = C_CONST / v, L_CONST / v
            else:
                mdl = model_from_config(fl)
                trace = mdl.trace(4000.0, fl.mobility_dt)
                c_emp, gaps = measure_contact_stats(
                    trace.in_range(fl.comm_range), fl.mobility_dt
                )
            bound = T.corollary1_bound(
                v, f0_gap=1.0, big_l=1.0, sigma=1.0, g2=1.0, n=8,
                rounds=args.rounds, rate=1e6, contact_const=C_CONST,
                intercontact_const=L_CONST, delta=10.0,
                s=model.num_params(), gamma_mode="model",
            )
            print(f"{name:>12s} {v:6.1f} {c_emp:8.1f} {gaps:10.1f} "
                  f"{res.history['uploads'][-1]:8.0f} {res.final_eval:7.4f} "
                  f"{bound:10.3f}", flush=True)
            rows.append(dict(model=name, speed=v, contact=c_emp,
                             intercontact=gaps,
                             uploads=res.history["uploads"][-1],
                             acc=res.final_eval, bound=bound))
    return rows


if __name__ == "__main__":
    main()
