"""Batched serving CLI: prefill a batch of prompts, decode new tokens.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --reduced --batch 4 --prompt-len 64 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --batch 4 --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --reduced --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen2-vl-72b --model 4 --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch whisper-large-v3 --model 4 --batch 8 --prompt-len 64 --gen 32

Serves every LLM family: dense, MoE, ssm, hybrid, audio (enc-dec) and VLM
(text-only prompts).  Runs on the card by default (``--device cuda``,
which raises when CUDA is absent): the dense, MoE and VLM decodes and the
audio decoder's cross-attention go through the ``decode_attn`` kernel,
and the ssm and hybrid prefills through the ``ssd_scan`` kernel when the
prompt is a multiple of the SSD chunk.  ``--device cpu`` runs the same
path on the kernels' plain versions.  Weights are random, drawn from
``--seed`` by a ``torch.Generator`` on the run's device; prompts (and the
audio family's stub encoder frames) are the reference's numpy draws.
Sampling is greedy.  ``--model M`` serves every family over a model
axis of M cards (``sharding/rules.py``'s ``RULES_SERVE``: each rank draws
and keeps its blocks of the weights; its KV cache, the audio decoder's
cross-attention cache among them, holds its kv heads, or where they do
not divide and the rules cut the cache's ``head_dim``, every kv head over
its block of the slots (``sharding/rules.py::model_slots``), its
recurrent cache its SSD heads), under ``torchrun`` with ``WORLD_SIZE`` M;
rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.serve")

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, model, params, prompts, gen: int, window: int = 0,
          frames=None, model_axis=None):
    """Greedy generation: returns (tokens (B, gen) int32, stats dict).

    ``frames``: the encoder features of the audio family, passed through
    to ``model.prefill``.  ``model_axis``: the rank's model axis
    (``params`` then its blocks; every rank gets the same tokens).  stats: ``prefill_s`` and ``decode_s`` (host
    clock around work that ends in a synchronise on the card),
    ``tok_per_s`` (B * gen / decode_s) and ``prefill_logits`` (B, vocab),
    the logits of each prompt's last token.
    """
    if window and cfg.family in ("dense", "moe", "vlm"):
        cfg = cfg.replace(sliding_window=window)
    b, plen = prompts.shape
    max_seq = window or (plen + gen)
    fkw = {} if frames is None else {"frames": frames}
    mkw = {} if model_axis is None else {"model_axis": model_axis}
    fkw.update(mkw)
    device = prompts.device
    _sync(device)
    t0 = time.perf_counter()
    if cfg.family == "ssm":
        last, cache = model.prefill(params, cfg, prompts, **fkw)
    else:
        last, cache = model.prefill(params, cfg, prompts, max_seq=max_seq,
                                    **fkw)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        logits, cache = model.decode_step(params, cfg, cache, tok, plen + i,
                                          **mkw)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return torch.stack(out, 1), {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": b * gen / max(t_decode, 1e-9),
        "prefill_logits": last,
    }


def main(argv=None):
    """Returns (cfg, tokens, stats) of the run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0, help="sliding window (ring cache)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--model", type=int, default=1,
                    help="the model axis: cards under torchrun")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("vision", "trajectory"):
        raise SystemExit("serve is for autoregressive archs")
    model = build_model(cfg)
    mesh = blocks = axis = None
    if args.model > 1:
        from repro_torch.launch.mesh import make_client_mesh
        from repro_torch.sharding.rules import RULES_SERVE

        mesh = make_client_mesh(1, device=args.device, model=args.model,
                                family=cfg.family)
        if mesh.data_size != 1:
            mesh.close()
            raise SystemExit(f"--model {args.model} serves on {args.model} "
                             f"ranks, not {mesh.world_size}")
        device, axis = mesh.device, mesh.model_axis()
        blocks = model.blocks(RULES_SERVE, mesh.axis_sizes, mesh.coords)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed),
                        device, blocks=blocks)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    log.info("arch=%s params=%d batch=%d prompt=%d gen=%d device=%s",
             cfg.name, model.num_params(), args.batch, args.prompt_len,
             args.gen, device)
    frames = None
    if cfg.family == "audio":  # the stub encoder features, drawn after the prompts
        frames = torch.from_numpy(rng.normal(
            0, 0.02, (args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        ).to(device)
    try:
        toks, stats = serve(cfg, model, params, prompts, args.gen,
                            args.window, frames=frames, model_axis=axis)
    finally:
        if mesh is not None:
            mesh.close()
    if mesh is None or mesh.rank == 0:
        log.info("generated %s tokens; prefill=%.2fs decode=%.2fs (%.1f "
                 "tok/s)", tuple(toks.shape), stats["prefill_s"],
                 stats["decode_s"], stats["tok_per_s"])
        print(toks[:2].cpu().numpy())
    return cfg, toks, stats


if __name__ == "__main__":
    main()
