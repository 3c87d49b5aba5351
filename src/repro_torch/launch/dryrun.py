"""The dry-run plan of every (arch x input shape) on NVIDIA H100 cards,
and its execution (the port of ``src/repro/launch/dryrun.py``).

Usage:
  python -m repro_torch.launch.dryrun --all               # plan, no card
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --world 4     # four cards
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k \\
      --execute                                          # run it on the card

The reference lowers and compiles each step for a TPU mesh and reads XLA's
``memory_analysis``.  Here the plan builds each step (``launch/steps.py``)
on the ``meta`` device, with no card: the arguments' bytes per card at a
world of ``--world`` cards and whether they fit one card's 80 GB, the
calculator's FLOPs and HBM bytes (``launch/calculator.py``, at
``model_parallel=1``: the port has no ``model`` axis), the H100 roofline
terms and bottleneck (``launch/roofline.py``) and ``model_flops``.  A
train step's card holds its rank's clients (one a card) and the global
batch; a serve step runs whole on one card at the global batch, whatever
the world.  ``--execute`` (the counterpart of compile +
``memory_analysis``) runs each planned step whose arguments fit, once, on
``--device`` (the card by default; a missing card raises) from random
arguments (``steps.materialize``, seeded by ``--seed``) and adds the
step's seconds, the peak GiB, the temporaries (peak - arguments) and the
roofline bound over the measured seconds.  Each pair is one JSON line
appended to ``--out``, with the reference's ``status`` values (``ok``,
``skipped``, ``error``).

The reference's ``XLA_FLAGS`` header (512 simulated host devices) and its
production meshes (``--multi-pod``, ``--both-meshes``) and ``--dump-hlo``
shape or dump one XLA program and have no counterpart here.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch.calculator import step_analytics
from repro_torch.launch.mesh import ClientMesh
from repro_torch.launch.steps import (arg_bytes, build_step, materialize,
                                      supported)
from repro_torch.utils.device import resolve_device


def active_params(cfg, model) -> int:
    """Approximate activated parameters per token (MoE: routed top-k only)."""
    total = model.num_params()
    if not cfg.is_moe:
        return total
    f = cfg.moe_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * f
    routed_all = cfg.num_experts * per_expert
    routed_active = cfg.num_experts_per_tok * per_expert
    return total - cfg.num_layers * (routed_all - routed_active)


def plan_mesh(world: int) -> ClientMesh:
    """Rank 0's view of a ``world``-rank client mesh for planning: no
    process group, and its steps are only built, never run."""
    return ClientMesh(group=None, rank=0, world_size=world,
                      device=torch.device("meta"))


def plan(cfg0, shape, *, world: int = 1, variant: str = "default",
         dist_overrides: dict | None = None) -> tuple:
    """(record, built) of one supported pair: the step built on the meta
    device and its numbers (see the module's docstring)."""
    # world 1: one process, no group (the step that --execute runs)
    mesh = plan_mesh(world) if shape.kind == "train" and world > 1 else None
    built = build_step(cfg0, shape, mesh, dist_overrides=dist_overrides,
                       variant=variant)
    cfg, model = built["cfg"], built["model"]
    n_params = model.num_params()
    act = active_params(cfg, model)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = RL.model_flops(n_params, tokens, act, train=shape.kind == "train")
    analytic = step_analytics(cfg, shape, world, n_params, model_parallel=1)
    dcfg = built["system"]["dcfg"] if shape.kind == "train" else None
    coll = RL.step_collectives(
        shape.kind, n_params, world, dcfg.num_clients if dcfg else 0,
        dcfg.upload_dtype if dcfg else "float32")
    roof = RL.analyze(analytic, coll, model_flops_total=mf)
    args_b = arg_bytes(built["args"])
    rec = dict(status="ok", world=world, num_params=n_params,
               active_params=act,
               mem=dict(argument_gb=args_b / 1e9,
                        fits=args_b <= RL.CARD_BYTES),
               roofline=roof.as_dict())
    return rec, built


def execute(built: dict, shape, rec: dict, device, seed: int) -> None:
    """Run a planned step once on ``device`` from random arguments; adds
    its seconds, peak and temporaries, and the bound over the seconds."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    args = materialize(built, shape, gen, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        arg_gib = (torch.cuda.memory_allocated(dev) - base) / 2**30
    t0 = time.perf_counter()
    with torch.no_grad() if shape.kind != "train" else torch.enable_grad():
        out = built["step"](*args)
    if cuda:
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    rec["execute"] = dict(device=str(dev), seconds=secs,
                          bound_over_measured=rec["roofline"]["bound_s"] / secs)
    if cuda:
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        rec["execute"].update(card=torch.cuda.get_device_name(dev),
                              peak_gib=peak, argument_gib=arg_gib,
                              temp_gib=peak - arg_gib)
    del out, args


def run_one(arch: str, shape_name: str, *, out_path: str, world: int = 1,
            tag: str = "baseline", variant: str = "default",
            dist_overrides: dict | None = None,
            cfg_overrides: dict | None = None, run: bool = False,
            device: str = "cuda", seed: int = 0) -> dict:
    shape = INPUT_SHAPES[shape_name]
    cfg0 = get_config(arch)
    if cfg_overrides:
        cfg0 = cfg0.replace(**cfg_overrides)
    rec = {"arch": arch, "shape": shape_name, "world": world, "tag": tag,
           "variant": variant, "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    if not supported(cfg0, shape):
        rec.update(status="skipped",
                   reason="long_500k unsupported (the enc-dec audio family "
                          "has no sub-quadratic decode)")
        _append(out_path, rec)
        print(json.dumps(rec), flush=True)
        return rec
    try:
        planned, built = plan(cfg0, shape, world=world, variant=variant,
                              dist_overrides=dist_overrides)
        rec.update(planned)
        roof = rec["roofline"]
        if run:
            if not rec["mem"]["fits"]:
                rec["execute"] = dict(run=False, reason="arguments exceed "
                                      "one card's memory")
            else:
                execute(built, shape, rec, device, seed)
        del built
        print(f"[dryrun] {arch} x {shape_name} (world {world}, {tag}): OK "
              f"arg={rec['mem']['argument_gb']:.2f}GB "
              f"fits={rec['mem']['fits']} flops/dev={roof['flops']:.3e} "
              f"hbm/dev={roof['hbm_bytes']:.3e} "
              f"coll/dev={roof['coll_bytes']:.3e} "
              f"bottleneck={roof['bottleneck']}"
              + (f" execute={json.dumps(rec['execute'])}"
                 if "execute" in rec else ""), flush=True)
    except (RuntimeError, ValueError, TypeError, NotImplementedError) as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} x {shape_name}: FAIL {type(e).__name__}: {e}",
              flush=True)
    _append(out_path, rec)
    return rec


def _append(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (see configs)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="sweep all arch x shape")
    ap.add_argument("--world", type=int, default=1,
                    help="cards of the plan (train: one client a card)")
    ap.add_argument("--out", default="runs/dryrun.jsonl")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--variant", default="default", choices=["default", "dp_client"])
    ap.add_argument("--upload-dtype", default=None, help="e.g. bfloat16")
    ap.add_argument("--accum-dtype", default=None, help="e.g. bfloat16")
    ap.add_argument("--kv-cache-dtype", default=None, help="e.g. int8")
    ap.add_argument("--expert-dtype", default=None, help="e.g. int8")
    ap.add_argument("--remat", default=None, help="none|full|dots")
    ap.add_argument("--execute", action="store_true",
                    help="run each planned step that fits once on --device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.execute:
        if args.world != 1:
            ap.error("--execute runs on one card: --world must be 1")
        resolve_device(args.device)  # a card asked for and absent raises

    dist_overrides = {}
    if args.upload_dtype:
        dist_overrides["upload_dtype"] = args.upload_dtype
    if args.accum_dtype:
        dist_overrides["accum_dtype"] = args.accum_dtype
    cfg_overrides = {}
    if args.kv_cache_dtype:
        cfg_overrides["kv_cache_dtype"] = args.kv_cache_dtype
    if args.expert_dtype:
        cfg_overrides["expert_dtype"] = args.expert_dtype
    if args.remat:
        cfg_overrides["remat"] = args.remat

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    if args.all:
        archs, shapes = list(ASSIGNED_ARCHS), list(INPUT_SHAPES)
    return [run_one(a, s, out_path=args.out, world=args.world, tag=args.tag,
                    variant=args.variant,
                    dist_overrides=dist_overrides or None,
                    cfg_overrides=cfg_overrides or None, run=args.execute,
                    device=args.device, seed=args.seed)
            for a in archs for s in shapes]


if __name__ == "__main__":
    main()
