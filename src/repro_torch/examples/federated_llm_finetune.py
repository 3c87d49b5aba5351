"""Federated LLM fine-tuning with MADS sparsification: the paper's
technique applied to an assigned architecture (reduced InternLM2).  The
twin of the reference's ``examples/federated_llm_finetune.py``; runs on
the card unless ``--device cpu``.

8 mobile devices hold disjoint synthetic token streams; cumulative
gradients are top-k-sparsified per contact (sampled-quantile
thresholding) under the MADS energy controller.

    PYTHONPATH=src python -m repro_torch.examples.federated_llm_finetune [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import FLConfig, get_config
from repro_torch.core.runner import run_afl
from repro_torch.data import DeviceLoader, SyntheticTokens
from repro_torch.models.registry import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args(argv)

    cfg = get_config("internlm2-1.8b").reduced()
    model = build_model(cfg)
    print(f"arch={cfg.name} (reduced) params={model.num_params():,}")
    fl = FLConfig(
        num_devices=8, rounds=args.rounds, batch_size=8, learning_rate=0.05,
        mean_contact=4.0, mean_intercontact=30.0,
        energy_budget=(40.0, 80.0), sparsifier="sampled",
    )
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seed=3)
    data = ds.make_split(400, 32, seed=4)
    order = np.random.default_rng(0).permutation(400)
    chunks = np.array_split(order, fl.num_devices)
    loader = DeviceLoader(
        [{k: v[c] for k, v in data.items()} for c in chunks], fl.batch_size
    )
    ev = ds.make_split(64, 32, seed=5)

    res = run_afl(model, cfg, fl, "mads", loader, ev, rounds=fl.rounds,
                  eval_every=min(10, fl.rounds), log_progress=True,
                  device=args.device)
    print("\nround  eval-loss  mean-k(of %d)" % model.num_params())
    for r, l, k in zip(res.history["round"], res.history["eval"],
                       res.history["k_mean"]):
        print(f"{r:5d}  {l:9.4f}  {k:10.0f}")
    drop = res.history["eval"][0] - res.history["eval"][-1]
    print(f"\nloss improvement over federation: {drop:.4f}")
    return res


if __name__ == "__main__":
    main()
