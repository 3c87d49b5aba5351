"""Batched serving of assigned architectures (reduced variants): prefill a
batch of prompts, then greedy-decode.  The twin of the reference's
``examples/serve_batched.py``; runs on the card unless ``--device cpu``.
On the card the dense and MoE decodes go through the ``decode_attn``
kernel and the ssm prefill through ``ssd_scan``.  Attention archs run
the sliding-window ring-cache path (``--window``), where the KV cache
stays at the window size no matter how far decode runs past it.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --gen 24 --window 40
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models.registry import build_model
from repro_torch.utils.device import resolve_device

ARCHS = ["llama3.2-3b", "mamba2-2.7b", "qwen3-moe-30b-a3b"]


def run_arch(name: str, *, batch: int, prompt_len: int, gen: int,
             window: int = 0, seed: int = 0, device="cuda"):
    """Serve one reduced arch; returns (tokens, stats)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    ).to(device)
    use_window = window if cfg.family in ("dense", "moe", "vlm") else 0
    toks, stats = serve(cfg, model, params, prompts, gen=gen, window=use_window)
    label = f"window={use_window}" if use_window else "full-cache"
    print(f"{name:20s} family={cfg.family:6s} {label:12s} "
          f"params={model.num_params():>9,} "
          f"prefill={stats['prefill_s']:.2f}s decode={stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s) tokens={toks[0].tolist()}")
    return toks, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--window", type=int, default=36,
                    help="ring-cache window for the sliding-window pass "
                         "(0 skips it; must be >= prompt-len, and < "
                         "prompt-len + gen to actually wrap)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out = {}
    for name in ARCHS:
        out[name] = run_arch(name, batch=args.batch, prompt_len=args.prompt_len,
                             gen=args.gen, seed=args.seed, device=device)
    if args.window:
        # the ring-cache path: window < prompt + gen forces cache wrap
        # (prefill still needs the whole prompt resident)
        if args.window < args.prompt_len:
            raise SystemExit("--window must be >= --prompt-len")
        for name in ARCHS:
            if get_config(name).family in ("dense", "moe", "vlm"):
                out[f"{name} window"] = run_arch(
                    name, batch=args.batch, prompt_len=args.prompt_len,
                    gen=args.gen, window=args.window, seed=args.seed,
                    device=device)
    return out


if __name__ == "__main__":
    main()
