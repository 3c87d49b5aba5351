#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-tree DIR   # time another checkout's kernels

Phases, each of which raises on failure (a failed phase exits non-zero):

1. device: the card's name, power limit and multiprocessor count (which
   sets ``decode_attn``'s split);
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one nvcc per source, all started together; each library's build
   seconds and ptxas registers and spills;
3. kernels: each kernel against its plain PyTorch version on the card,
   with device times (``median_ms``: CUDA events around batches of calls
   run back to back) beside the plain version's, the bound and, where one
   PyTorch call computes the same function, that call's time; beside them
   the kernel's ``ms_per_call`` (``per_call_ms``: CUDA events around each
   single call, the ``ms`` of the kernels line before batching):
   - ``sparsify_ef`` / ``sparsify_quantize_ef`` at the training path's
     shape (N = 20 devices x s = 6,573,130 ResNet-9 parameters) in f32 and
     bf16 and at ragged shapes: uploads and counts bit-equal, errors within
     1e-6;
   - the segmented ``sparsify_quantize_ef`` (one threshold, step and
     levels per (device, leaf): the per-layer codec's call) at (20,
     6,573,130) with ResNet-9's 26 leaves and at (20, 247,100) with
     LaneGCN's 20, in f32 and bf16: uploads, errors and counts bit-equal
     to its plain version, and to the unsegmented kernel called leaf by
     leaf with base = the leaf's offset (a cross-check only);
   - ``decode_attn`` at the reference test's shapes and G = 8 at D = 64 in
     f32 (2e-5) and bf16 (3e-2), at the serve path's shape (B 8, S 2080,
     KV 8, D 128, G 3) and at a deep cache (S 32768), plus a masked-tail
     check; timed against ``scaled_dot_product_attention`` (the yardstick;
     the port never calls it): at the serve shape over a rotation of 4
     distinct caches (273 MB, cold in the 50 MB L2, as 28 layers' caches
     are in a decode step) and on one cache;
   - ``ssd_scan`` at the reference test's shapes, the serve path's (B 4,
     S 4096, H 80, P 64, N 128, chunk 256) and a ~ -0.4 a step at chunk
     256, at 2e-4 against its plain version evaluated in f64 on the same
     inputs (the f32 chunked formula is itself ~5e-4 off at chunk 256, so
     f32 against f32 would test the two roundings, not the kernel); the f32
     plain version is timed; its bound counts the 3xTF32 route's operations
     (3 per flop) at the TF32 rate, the f32 rate without tensor cores
     printed beside it;
4. training path, ResNet-9: ``repro_torch.launch.train`` in-process at
   full width, N = 20, batch 32, for policies ``mads`` (through
   ``sparsify_ef``) and ``mads-joint`` (through ``sparsify_quantize_ef``),
   and ``run_afl`` for ``mads-joint`` with ``FLConfig(per_layer_budget=
   True)`` (through the segmented kernel), each kernel's launch count read
   around each run (one sparsify launch per round); uploads > 0 and a
   finite eval;
5. training path, LaneGCN (the paper's Argoverse experiment): the same at
   full width (d_model 128, s = 247,100) for ``mads``, ``qsgd`` (through
   the unsegmented ``sparsify_quantize_ef``) and per-layer ``mads-joint``;
   eval ADE, uploads, launches per round, steady rounds/s;
6. training reference: the same training on CUDA and on the CPU (plain
   versions) from one seed agree: ResNet-9 at width 4 (``mads``) and
   LaneGCN at d_model 32 (``mads`` and ``qsgd``);
7. serve, dense: ``repro_torch.launch.serve`` in-process at full-width
   Llama-3.2-3B (bf16, random weights from a CUDA generator), batch 8,
   prompt 2048, gen 32: ``decode_attn`` launched 28 x 32 times, tokens in
   [0, vocab), finite logits; prefill and decode seconds and tok/s;
8. serve, ssm: the same at full-width Mamba2-2.7B, batch 4, prompt 4096:
   ``ssd_scan`` launched 64 times (once per layer of the prefill);
9. serve reference: reduced Llama and Mamba2 in float32 on the card and on
   the CPU from one seed, prompt 64 (a multiple of the reduced SSD chunk,
   32): the same greedy tokens, prefill logits within 1e-3;
10. scenarios, numpy: ``ScenarioProvider.from_config`` on the host for
   every trace model (rwp, gauss_markov, manhattan, hotspot, static) at
   N = 20, 60 rounds, area 500: contact rate, mean tau, host ms;
11. training under trace mobility: ``repro_torch.launch.train`` at full
   width, N = 20, batch 32, 8 rounds each, for ResNet-9 ``mads``
   (manhattan, 15 m/s, area 500), ResNet-9 ``mads-joint`` (rwp, area 500)
   and LaneGCN ``mads`` (gauss_markov on the device-resident backend with
   dropout 0.2, availability 0.8, compute mean 1 s, area 500): one sparsify
   launch a round, uploads > 0, a finite eval, steady rounds/s; ResNet-9
   ``mads`` under the Manhattan schedule at width 4 on CUDA and on the CPU
   (equal schedules and uploads, eval within 0.02); MADS's realised k on
   LaneGCN at 2 and 30 m/s (manhattan; printed, not asserted);
12. device-resident scenario engine: ``torch_schedule_from_model`` for the
   four models at N = 1e5, 20 rounds x 10 s (CUDA events around the whole
   build, median of 5; peak memory) beside the numpy backend's host time;
   Gauss-Markov at N = 1e6, 4 rounds x 5 s; the card's extraction equal to
   the numpy oracle on one card-built mask at N = 1e5; the card backend's
   contact rate and mean tau within 20 % of the numpy backend's at N = 512;
   ``gate_windows`` on the card equal to the reference on shared draws and
   ``torch_apply``'s P(available) within 0.02 of its stationary value;
13. telemetry: full-width ResNet-9 and LaneGCN ``mads`` (N = 20, batch
   32, 8 rounds) through the training CLI with telemetry off, with
   ``--telemetry`` and with ``--telemetry --perdevice --probes``, in turns
   (two runs each, six for LaneGCN; steady rounds/s), then once more with
   ``--profile-dir``:
   one sparsify_ef launch a round; the fetched snapshot consistent (8
   rounds, successes = uploads, bin totals = contacts or successes, the
   table's and the probes' counts = the counters); telemetry.jsonl read
   back and rendered; the Chrome trace holding the phase spans and the
   sparsify kernel.  The records of the registry, the table, the probes
   and the suite on card tensors under
   ``torch.cuda.set_sync_debug_mode("error")`` (host ms and kernels per
   record); a width-4 Manhattan + heterogeneity telemetry run on CUDA
   against the CPU (counters, bins and count fields equal); the quickstart
   and the speed sweep (exponential, manhattan) twins on the card;
14. profile: a ``torch.profiler`` pass over ``decode_attn`` and
   ``ssd_scan`` at their timed shapes, device time by kernel (the five
   launches of ``ssd_scan``), and over a few full-width training rounds
   of LaneGCN and ResNet-9 (``mads``): device-busy seconds per round
   against the host's wall clock, and the kernels that take the most; and
   over one N = 1e5 schedule build per model (device-busy ms against
   phase 12's time); last, so that the profiler's tracing cannot weigh on
   the host-bound decodes, rounds and builds timed before it.

The last three lines are the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), a JSON object with one entry per kernel (``bound_share`` is
bound_ms / ms; ``timing`` names the method of ``ms``), and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card and
outside a checkout of the repository.
"""
from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
# H100 SXM dense peaks by operand type ("tf32": the tensor cores' TF32 rate)
PEAK_OPS_PER_S = {torch.float32: FP32_OPS_PER_S, torch.bfloat16: 989e12,
                  "tf32": 495e12}
N_DEV, S_RESNET9, S_LANEGCN = 20, 6_573_130, 247_100
RESNET9, LANEGCN = "resnet9-cifar10", "lanegcn-argoverse"
ROUNDS = 4
GEN = 32
LLAMA_BATCH, LLAMA_PROMPT = 8, 2048
MAMBA_BATCH, MAMBA_PROMPT = 4, 4096
# decode_attn at the serve path's shape (Llama-3.2-3B: KV 8, G 3, D 128;
# cache of prompt + gen slots) and at a deep cache; (B, H, KV, S, D)
DECODE_MAIN = (LLAMA_BATCH, 24, 8, LLAMA_PROMPT + GEN, 128)
DECODE_DEEP = (8, 24, 8, 32768, 128)
CACHES = 4  # distinct serve-shape caches timed in rotation (> 2x the L2)
# ssd_scan at the serve path's shape (Mamba2-2.7B); (B, S, H, P, N, chunk)
SSD_MAIN = (MAMBA_BATCH, MAMBA_PROMPT, 80, 64, 128, 256)
T_ROW = [0.0, 0.7, 1.5, math.inf, math.nextafter(-math.inf, math.inf)]
TIMED_RUNS = 25
TIMING = ("ms: median of 25 batches of 10 back-to-back calls; ms_per_call: "
          "median of 25 single calls, each between two CUDA events")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, runs: int = TIMED_RUNS, batch: int = 10) -> float:
    """Device milliseconds of one call of fn: the median over ``runs``
    batches of ``batch`` calls, each batch enqueued behind a sleeping
    kernel (so that the host's dispatch of the calls is hidden and the
    calls run back to back) and timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # host time to enqueue one call
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int((2 * batch * enqueue_s + 1e-4) * 2e9)  # at <= 2 GHz
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    times.sort()
    return times[len(times) // 2]


def per_call_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Milliseconds of one call of fn between two CUDA events, the median
    over ``runs`` calls: the host's dispatch of the call counts where it
    outlasts the device's work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def rotation(fn, items):
    """A call of fn on the next of ``items`` in turn."""
    it = itertools.cycle(items)
    return lambda: fn(next(it))


def device_times(fn, runs: int = 5) -> dict:
    """Device milliseconds per call of fn by kernel name, from a
    torch.profiler trace of ``runs`` calls ({} if it shows none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            out[e.key[:60]] = us / runs / 1e3
    return out


def kernel_inputs(shape, dtype, seed: int):
    n, s = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    t = torch.tensor([T_ROW[i % len(T_ROW)] for i in range(n)], device="cuda")
    steps = torch.linspace(0.004, 0.05, n, device="cuda")
    levels = torch.tensor([[1.0, 7.0, 127.0, 32767.0][i % 4] for i in range(n)],
                          device="cuda")
    seeds = (torch.arange(n, device="cuda", dtype=torch.int32) * 7919 + 11)
    return x, t, steps, levels, seeds


def check_kernels(K, R, card: str):
    """Phase 3: compare each kernel with its plain version; time both."""
    err = {"sparsify_ef": 0.0, "sparsify_quantize_ef": 0.0}
    base = 12345
    for shape in [(N_DEV, S_RESNET9), (3, 7), (2, 300001)]:
        for dtype in (torch.float32, torch.bfloat16):
            x, t, steps, levels, seeds = kernel_inputs(shape, dtype, 0)
            got, want = K.sparsify_ef_cuda(x, t), R.sparsify_ef_plain(x, t)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
                fail(f"sparsify_ef upload/count differ at {shape} {dtype}")
            e = (got[1].float() - want[1].float()).abs().max().item()
            if e > 1e-6:
                fail(f"sparsify_ef error differs by {e} at {shape} {dtype}")
            err["sparsify_ef"] = max(err["sparsify_ef"], e)
            got = K.sparsify_quantize_ef_cuda(x, t, steps, levels, seeds, base)
            want = R.sparsify_quantize_ef_plain(x, t, steps, levels, seeds, base)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
                fail(f"sparsify_quantize_ef upload/count differ at {shape} {dtype}")
            e = (got[1].float() - want[1].float()).abs().max().item()
            if e > 1e-6:
                fail(f"sparsify_quantize_ef error differs by {e} at {shape} {dtype}")
            err["sparsify_quantize_ef"] = max(err["sparsify_quantize_ef"], e)
            print(f"kernels match plain at {shape} {dtype}: counts "
                  f"{got[2][:5].tolist()}", flush=True)
            del x, got, want

    # times at the main path's shape and type (f32, as ResNet-9 trains)
    x, t, steps, levels, seeds = kernel_inputs((N_DEV, S_RESNET9), torch.float32, 1)
    n_el = x.numel()
    def kernel_ef():
        return K.sparsify_ef_cuda(x, t)

    def kernel_qef():
        return K.sparsify_quantize_ef_cuda(x, t, steps, levels, seeds, base)

    times = {
        "sparsify_ef": (
            kernel_ef,
            median_ms(kernel_ef),
            median_ms(lambda: R.sparsify_ef_plain(x, t)),
            # x read, upload + error written; thresholds read, counts written
            3 * 4 * n_el + 2 * 4 * N_DEV,
            4 * n_el,  # |x|, compare, two selects per element
        ),
        "sparsify_quantize_ef": (
            kernel_qef,
            median_ms(kernel_qef),
            median_ms(lambda: R.sparsify_quantize_ef_plain(x, t, steps, levels,
                                                           seeds, base)),
            3 * 4 * n_el + 5 * 4 * N_DEV,
            22 * n_el,  # the hash (10), divide, add, floor, clamp, mul, sub, ...
        ),
    }
    out = {}
    for name, (fn, ms, plain_ms, nbytes, ops) in times.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        out[name] = dict(ms=ms, ms_per_call=per_call_ms(fn), plain_ms=plain_ms,
                         max_abs_err=err[name],
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        out[name]["bound_share"] = out[name]["bound_ms"] / ms
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']}) "
              f"at ({N_DEV}, {S_RESNET9}) f32 on {card}", flush=True)
    return out


def leaf_offsets(arch: str) -> tuple:
    """The L + 1 leaf boundaries of a full-width model's flat vector."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    layout = build_model(get_config(arch)).layout
    return layout.offsets + (layout.size,)


def segmented_inputs(offsets, dtype, seed: int):
    n, nl = N_DEV, len(offsets) - 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, offsets[-1]), generator=g, device="cuda").to(dtype)
    # per (device, leaf): thresholds that keep some, all or none
    t = torch.rand((n, nl), generator=g, device="cuda") * 2.0
    t[0, :] = 0.0
    t[1, :] = math.inf
    steps = torch.rand((n, nl), generator=g, device="cuda") * 0.05 + 0.004
    levels = torch.tensor([1.0, 7.0, 127.0, 32767.0], device="cuda")[
        torch.randint(0, 4, (n, nl), generator=g, device="cuda")]
    seeds = torch.arange(n, device="cuda", dtype=torch.int32) * 7919 + 11
    return x, t, steps, levels, seeds


def check_segmented(K, R, card: str) -> dict:
    """Phase 3 for the segmented sparsify_quantize_ef: bit-equal to its
    plain version and to the unsegmented kernel leaf by leaf, at both
    models' full-width layouts; timed at both in f32."""
    out = {}
    for arch in (RESNET9, LANEGCN):
        offsets = leaf_offsets(arch)
        for dtype in (torch.float32, torch.bfloat16):
            x, t, steps, levels, seeds = segmented_inputs(offsets, dtype, 2)
            got = K.sparsify_quantize_ef_segmented_cuda(x, t, steps, levels,
                                                        seeds, offsets)
            want = R.sparsify_quantize_ef_segmented_plain(x, t, steps, levels,
                                                          seeds, offsets)
            torch.cuda.synchronize()
            for name, a, b in zip(("upload", "error", "count"), got, want):
                if not torch.equal(a, b):
                    fail(f"segmented sparsify_quantize_ef {name} differs from "
                         f"plain at {tuple(x.shape)} {dtype} ({arch} leaves)")
            for i, (a, b) in enumerate(zip(offsets, offsets[1:])):
                u, e, c = K.sparsify_quantize_ef_cuda(
                    x[:, a:b].contiguous(), t[:, i].contiguous(),
                    steps[:, i].contiguous(), levels[:, i].contiguous(),
                    seeds, a)
                if not (torch.equal(got[0][:, a:b], u)
                        and torch.equal(got[1][:, a:b], e)
                        and torch.equal(got[2][:, i], c)):
                    fail(f"segmented kernel differs from the per-leaf kernel "
                         f"at leaf {i} of {arch} ({dtype})")
            print(f"segmented sparsify_quantize_ef matches plain and the "
                  f"per-leaf kernel at {tuple(x.shape)} {dtype} with {arch}'s "
                  f"{len(offsets) - 1} leaves: counts {got[2][2, :4].tolist()}",
                  flush=True)
            del x, got, want

        x, t, steps, levels, seeds = segmented_inputs(offsets, torch.float32, 3)
        n_el, nl = x.numel(), len(offsets) - 1
        ntiles = K.tiles(offsets, x.dtype, x.device).shape[0]

        def kernel():
            return K.sparsify_quantize_ef_segmented_cuda(x, t, steps, levels,
                                                         seeds, offsets)

        res = dict(
            ms=median_ms(kernel), ms_per_call=per_call_ms(kernel),
            plain_ms=median_ms(lambda: R.sparsify_quantize_ef_segmented_plain(
                x, t, steps, levels, seeds, offsets)),
            max_abs_err=0.0, library_ms=None, tiles=ntiles,
            # x read, upload + error written; the three (N, L) tables, the
            # seeds and the tile table read; the (N, L) counts written
            **bound(3 * 4 * n_el + 4 * 4 * N_DEV * nl + 4 * N_DEV + 24 * ntiles,
                    22 * n_el, torch.float32))
        res["bound_share"] = res["bound_ms"] / res["ms"]
        print(f"sparsify_quantize_ef_segmented ({arch}, {tuple(x.shape)}, {nl} "
              f"leaves, {ntiles} tiles, f32): {res['ms']:.4f} ms (plain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
              f"{res['bound_by']}, {100 * res['bound_share']:.1f} % of it) on "
              f"{card}; unrounded {json.dumps(res)}", flush=True)
        out[arch] = res
        del x
    return out


def train(argv):
    from repro_torch.launch import train as T

    with tempfile.TemporaryDirectory() as wd:
        return T.main(argv + ["--workdir", wd])


def train_per_layer(arch: str, rounds: int):
    """``mads-joint`` with ``FLConfig(per_layer_budget=True)`` through
    ``run_afl``, configured as the training CLI configures a run (the CLI
    has no per-layer switch, as the reference's has none)."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core.runner import run_afl
    from repro_torch.data import DeviceLoader
    from repro_torch.launch.train import build_device_data
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    fl = FLConfig(num_devices=N_DEV, rounds=rounds, batch_size=32,
                  mean_intercontact=20.0, seed=0, per_layer_budget=True,
                  sparsifier="exact" if model.num_params() < 2_000_000
                  else "sampled")
    dev, ev = build_device_data(cfg, fl, train_n=2000, seed=0)
    return run_afl(model, cfg, fl, "mads-joint", DeviceLoader(dev, 32, 0), ev,
                   rounds=rounds, eval_every=rounds, device="cuda")


def main_path(K, policy: str, arch: str = RESNET9, per_layer: bool = False,
              rounds: int = ROUNDS, scenario=("--intercontact", "20")):
    """Phases 4-5 and 11 for one (model, policy, scenario): the counts are
    set to 0 just before the run and read just after it.  ``scenario``:
    the training CLI's scenario flags (by default the exponential model
    with 20 s mean inter-contact).  Returns (launches, steady rounds/s,
    result)."""
    K.reset_launches()
    if per_layer:
        res = train_per_layer(arch, rounds)
    else:
        res = train(["--arch", arch, "--policy", policy, "--rounds",
                     str(rounds), "--devices", str(N_DEV), "--batch-size",
                     "32", "--train-n", "2000", "--eval-every", str(rounds),
                     "--device", "cuda", "--seed", "0", *scenario])
    launches = dict(K.LAUNCHES)
    hist = res.history
    name = f"{arch} {policy}{' per-layer' if per_layer else ''} {' '.join(scenario)}"
    if not hist["uploads"][-1] > 0:
        fail(f"{name}: no uploads in {rounds} rounds")
    if not all(math.isfinite(v) for v in hist["eval"]):
        fail(f"{name}: eval not finite: {hist['eval']}")
    if not torch.isfinite(res.state.w).all():
        fail(f"{name}: global model not finite")
    if sum(launches.values()) != rounds:
        fail(f"{name}: {sum(launches.values())} sparsify launches in {rounds} "
             f"rounds, not one per round: {launches}")
    steady = res.round_seconds[1:]
    rps = len(steady) / sum(steady)
    print(f"main path {name}: eval {hist['eval'][-1]:.4f}, uploads "
          f"{hist['uploads'][-1]:.0f}, k_mean {hist['k_mean'][-1]:.1f}, bits_mean "
          f"{hist['bits_mean'][-1]:.1f}, launches {launches} "
          f"({sum(launches.values()) / rounds:g} per round), round seconds "
          f"{res.round_seconds}, steady {rps} rounds/s", flush=True)
    return launches, rps, res


def check_against_cpu():
    """Phase 6: CUDA and CPU (plain versions) runs from one seed agree."""
    cases = [("resnet9 width 4", ["--policy", "mads", "--width", "4"], 0.02, 0.0)]
    cases += [(f"lanegcn d_model 32 {p}", ["--arch", LANEGCN, "--policy", p,
                                           "--width", "32"], 0.0, 1e-3)
              for p in ("mads", "qsgd")]
    for label, args, atol, rtol in cases:
        hists = {}
        for dev in ("cuda", "cpu"):
            argv = args + ["--devices", "4", "--rounds", "3", "--eval-every",
                           "1", "--batch-size", "8", "--train-n", "200",
                           "--intercontact", "20", "--device", dev]
            hists[dev] = train(argv).history
        a, b = hists["cuda"], hists["cpu"]
        if a["uploads"] != b["uploads"] or a["round"] != b["round"]:
            fail(f"{label}: cuda and cpu runs differ: {a} vs {b}")
        if any(abs(x - y) > atol + rtol * abs(y)
               for x, y in zip(a["eval"], b["eval"])):
            fail(f"{label}: cuda and cpu eval differ: {a['eval']} vs {b['eval']}")
        print(f"cuda run matches cpu run ({label}): eval {a['eval']} vs "
              f"{b['eval']}, uploads {a['uploads']}", flush=True)


TRACE_MODELS = ("rwp", "gauss_markov", "manhattan", "hotspot", "static")
DEVICE_MODELS = ("rwp", "gauss_markov", "manhattan", "hotspot")
# phase 11: full-width training under trace mobility (MES at the centre of
# the area, 100 m range: ~13 % of devices in range at any moment)
TRACE_RUNS = (
    (RESNET9, "mads", ("--mobility", "manhattan", "--speed", "15", "--area",
                       "500")),
    (RESNET9, "mads-joint", ("--mobility", "rwp", "--area", "500")),
    (LANEGCN, "mads", ("--mobility", "gauss_markov", "--scenario-backend",
                       "jax", "--dropout", "0.2", "--availability", "0.8",
                       "--compute-mean", "1", "--area", "500")),
)
TRACE_ROUNDS = 8
N_TIMED = 100_000  # phase 12's timed federation
N_MILLION = 1_000_000


def _schedule_stats(zeta, tau) -> tuple:
    """(contact rate, mean tau over contacts) of a numpy or card schedule."""
    z = torch.as_tensor(zeta).double()
    t = torch.as_tensor(tau).double()
    return z.mean().item(), (t.sum() / z.sum().clamp(min=1)).item()


def _check_schedule(label: str, zeta, tau, h2, shape) -> None:
    zeta, tau, h2 = (torch.as_tensor(x) for x in (zeta, tau, h2))
    if tuple(zeta.shape) != shape or tuple(h2.shape) != shape:
        fail(f"{label}: schedule shapes {tuple(zeta.shape)}, {tuple(h2.shape)}")
    if not torch.equal(tau > 0, zeta == 1):
        fail(f"{label}: tau > 0 where zeta != 1 or the other way round")
    if not (torch.isfinite(h2).all() and (h2 > 0).all()):
        fail(f"{label}: channel gains not finite and positive")


def scenarios_numpy(smi: str) -> dict:
    """Phase 10: the numpy scenario engine (host) for every trace model at
    N = 20, 60 rounds, area 500: contact rate and mean tau per model."""
    from repro_torch.configs import FLConfig
    from repro_torch.scenarios import ScenarioProvider

    out = {}
    for name in TRACE_MODELS:
        fl = FLConfig(num_devices=N_DEV, rounds=60, mobility_model=name,
                      area=500.0, seed=0)
        t0 = time.perf_counter()
        zeta, tau, h2 = ScenarioProvider.from_config(fl, device="cuda").schedule()
        host_ms = 1e3 * (time.perf_counter() - t0)
        if not isinstance(zeta, np.ndarray):
            fail(f"numpy backend {name}: schedule is not a host array")
        _check_schedule(f"numpy {name}", zeta, tau, h2, (60, N_DEV))
        rate, mean_tau = _schedule_stats(zeta, tau)
        if name != "static" and rate == 0:
            fail(f"numpy {name}: no contacts in 60 rounds")
        out[name] = dict(contact_rate=rate, mean_tau_s=mean_tau,
                         host_ms=host_ms)
    print(f"scenarios (numpy backend, host, N={N_DEV}, 60 rounds, area 500): "
          f"{json.dumps(out)}", flush=True)
    return out


def trace_training(K, smi: str) -> dict:
    """Phase 11: full-width training under trace mobility, through the
    training CLI (``main_path``: counts reset just before each run and read
    just after; one sparsify launch a round, uploads > 0, a finite eval),
    the numpy-backend run held against the CPU at width 4, and MADS's
    realised k at low and high speed."""
    out = {}
    for arch, policy, scenario in TRACE_RUNS:
        launches, rps, res = main_path(K, policy, arch, rounds=TRACE_ROUNDS,
                                       scenario=scenario)
        kernel = {"mads": "sparsify_ef", "mads-joint": "sparsify_quantize_ef"}[
            policy]
        if launches[kernel] != TRACE_ROUNDS:
            fail(f"{arch} {policy} {scenario}: {kernel} not launched once a "
                 f"round: {launches}")
        out[f"{arch} {policy} {scenario[1]}"] = dict(
            launches=launches, rps=rps, eval=res.history["eval"][-1],
            uploads=res.history["uploads"][-1], k_mean=res.history["k_mean"][-1])
        del res
        torch.cuda.empty_cache()
    print(f"rounds/s under trace mobility (steady, full width, N={N_DEV}, batch "
          f"32, {TRACE_ROUNDS} rounds) on {smi}: " + "; ".join(
              f"{k} {v['rps']} (eval {v['eval']}, uploads {v['uploads']:.0f})"
              for k, v in out.items()), flush=True)
    trace_against_cpu()
    speed_k = {}
    for speed in ("2", "30"):
        res = train(["--arch", LANEGCN, "--policy", "mads", "--rounds",
                     str(TRACE_ROUNDS), "--devices", str(N_DEV), "--batch-size",
                     "32", "--train-n", "2000", "--eval-every",
                     str(TRACE_ROUNDS), "--device", "cuda", "--seed", "0",
                     "--mobility", "manhattan", "--speed", speed, "--area",
                     "500"])
        speed_k[speed] = dict(k_mean=res.history["k_mean"][-1],
                              uploads=res.history["uploads"][-1],
                              ade=res.history["eval"][-1])
    print(f"MADS realised k (LaneGCN full width, manhattan, area 500, "
          f"{TRACE_ROUNDS} rounds; not asserted): speed 2 m/s {speed_k['2']}, "
          f"speed 30 m/s {speed_k['30']}", flush=True)
    return out


def trace_against_cpu() -> None:
    """Phase 11's CPU check: ResNet-9 ``mads`` at width 4 under the
    Manhattan schedule (numpy backend) on CUDA and on the CPU from one
    seed: equal schedules, equal uploads, eval within 0.02."""
    from repro_torch.configs import FLConfig
    from repro_torch.core.runner import build_provider

    args = ["--policy", "mads", "--width", "4", "--devices", "12", "--rounds",
            "6", "--eval-every", "3", "--batch-size", "8", "--train-n", "160",
            "--mobility", "manhattan", "--speed", "15", "--area", "400"]
    fl = FLConfig(num_devices=12, rounds=6, mobility_model="manhattan",
                  speed=15.0, area=400.0)
    sched = {d: build_provider(fl, "mads", None, 6, 0, d).schedule()
             for d in ("cuda", "cpu")}
    for name, a, b in zip(("zeta", "tau", "h2"), sched["cuda"], sched["cpu"]):
        if not np.array_equal(a, b):
            fail(f"manhattan schedule {name} differs between the cuda and "
                 "cpu runs")
    hists = {d: train(args + ["--device", d]).history for d in ("cuda", "cpu")}
    a, b = hists["cuda"], hists["cpu"]
    if a["uploads"] != b["uploads"] or not a["uploads"][-1] > 0:
        fail(f"manhattan width 4: uploads differ or none: {a} vs {b}")
    if any(abs(x - y) > 0.02 for x, y in zip(a["eval"], b["eval"])):
        fail(f"manhattan width 4: cuda and cpu eval differ: {a['eval']} vs "
             f"{b['eval']}")
    print(f"cuda run matches cpu run (resnet9 width 4, manhattan, numpy "
          f"backend): equal schedules, eval {a['eval']} vs {b['eval']}, "
          f"uploads {a['uploads']}", flush=True)


def device_engine(smi: str) -> dict:
    """Phase 12: the device-resident scenario engine on the card."""
    from repro_torch.configs import FLConfig
    from repro_torch.mobility import intervals_to_rounds
    from repro_torch.scenarios import (TORCH_MODELS, ScenarioProvider,
                                       contact_intervals, gate_windows,
                                       rounds_from_in_range,
                                       torch_schedule_from_model)
    from repro_torch.scenarios.heterogeneity import (HeterogeneityModel,
                                                     reference_apply,
                                                     torch_apply, torch_draws)

    out = {}
    # timing at N = 1e5: 20 rounds x 10 s at dt 1 (200 steps), the whole
    # build between two CUDA events; peak memory of one build
    for name in DEVICE_MODELS:
        model = TORCH_MODELS[name](num_devices=N_TIMED, area=2000.0, seed=0,
                                   device="cuda")
        build = lambda: torch_schedule_from_model(model, 20, 10.0)  # noqa: E731
        ms = per_call_ms(build, runs=5)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        zeta, tau, h2 = build()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**20
        _check_schedule(f"device {name}", zeta, tau, h2, (20, N_TIMED))
        rate, mean_tau = _schedule_stats(zeta, tau)
        out[name] = dict(ms=ms, host_ms=host_ms, peak_mib=peak,
                         contact_rate=rate, mean_tau_s=mean_tau)
        fl = FLConfig(num_devices=N_TIMED, rounds=20, mobility_model=name,
                      area=2000.0, seed=0)
        t0 = time.perf_counter()
        ScenarioProvider.from_config(fl).schedule()
        out[name]["numpy_host_ms"] = 1e3 * (time.perf_counter() - t0)
        print(f"device engine {name} (N={N_TIMED}, 20 rounds x 10 s, dt 1, "
              f"area 2000): {ms:.3f} ms between CUDA events (median of 5; host "
              f"{host_ms:.3f} ms), peak {peak:.1f} MiB; the numpy backend "
              f"{out[name]['numpy_host_ms']:.1f} ms on the host; on {smi}",
              flush=True)

    # the million-device point, short horizon
    torch.cuda.reset_peak_memory_stats()
    model = TORCH_MODELS["gauss_markov"](num_devices=N_MILLION, area=5000.0,
                                         seed=1, device="cuda")
    ms = per_call_ms(lambda: torch_schedule_from_model(model, 4, 5.0), runs=3)
    zeta, tau, h2 = torch_schedule_from_model(model, 4, 5.0)
    _check_schedule("device 1e6", zeta, tau, h2, (4, N_MILLION))
    rate = zeta.double().mean().item()
    if not 0 < rate < 1:
        fail(f"million-device schedule: contact rate {rate}")
    out["million"] = dict(ms=ms, contact_rate=rate,
                          peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    print(f"device engine gauss_markov N={N_MILLION} (4 rounds x 5 s): "
          f"{json.dumps(out['million'])} on {smi}", flush=True)
    del zeta, tau, h2

    # exact extraction on one card-built mask at N = 1e5, Gauss-Markov
    model = TORCH_MODELS["gauss_markov"](num_devices=N_TIMED, area=2000.0,
                                         seed=0, device="cuda")
    mask = model.trace(200.0, 1.0).in_range(100.0)
    host = mask.cpu().numpy()
    z_o, t_o = intervals_to_rounds(*contact_intervals(host, 1.0), N_TIMED, 20,
                                   10.0)
    z, t = rounds_from_in_range(mask, 1.0, 20, 10.0)
    zs, ts, _ = torch_schedule_from_model(model, 20, 10.0)
    for label, a, b in (("rounds_from_in_range zeta", z, z_o),
                        ("rounds_from_in_range tau", t, t_o),
                        ("schedule zeta", zs, z_o), ("schedule tau", ts, t_o)):
        if not np.array_equal(a.cpu().numpy(), b):
            fail(f"card extraction differs from the numpy oracle: {label}")
    print(f"device extraction at N={N_TIMED} equals the numpy oracle on the "
          f"shared mask ({int(z_o.sum())} contact cells)", flush=True)

    # statistical agreement with the numpy backend at N = 512, 60 rounds
    base = dict(num_devices=512, rounds=60, mobility_model="gauss_markov",
                speed=10.0, area=800.0, seed=4)
    np_stats = _schedule_stats(*ScenarioProvider.from_config(
        FLConfig(**base)).schedule()[:2])
    dev_stats = _schedule_stats(*ScenarioProvider.from_config(
        FLConfig(scenario_backend="jax", **base), device="cuda").schedule()[:2])
    for label, a, b in zip(("contact rate", "mean tau"), dev_stats, np_stats):
        if abs(a - b) > 0.2 * b:
            fail(f"N=512 {label}: card {a} vs numpy {b} (beyond 20 %)")
    out["n512"] = dict(card=dev_stats, numpy=np_stats)
    print(f"N=512 differential (gauss_markov, 60 rounds): card (rate, tau) "
          f"{dev_stats}, numpy {np_stats}", flush=True)

    # heterogeneity: gate_windows on the card on shared numpy draws, and
    # torch_apply's stationary availability at N = 1e5
    het = HeterogeneityModel(num_devices=N_TIMED, availability=0.8,
                             avail_persist=0.3, compute_mean=2.0, dropout=0.2,
                             seed=2)
    draws = het.draws(20)
    zeta, tau = zs, ts
    got = gate_windows(zeta, tau, *(torch.as_tensor(d, device="cuda")
                                    for d in draws))
    sl = slice(0, 10_000)  # the Python loop reference on a slice
    want = reference_apply(z_o[:, sl], t_o[:, sl], *(d[:, sl] for d in draws))
    full = gate_windows(z_o, t_o, *draws)
    for (label, a), b, c in zip((("zeta", got[0]), ("tau", got[1]),
                                 ("unavail", got[2]["unavail"]),
                                 ("dropout", got[2]["dropout"])),
                                (want[0], want[1], want[2]["unavail"],
                                 want[2]["dropout"]),
                                (full[0], full[1], full[2]["unavail"],
                                 full[2]["dropout"])):
        a = a.cpu().numpy()
        if not (np.array_equal(a[:, sl], b) and np.array_equal(a, c)):
            fail(f"gate_windows on the card differs from the reference on "
                 f"shared draws: {label}")
    ms = per_call_ms(lambda: torch_apply(het, zeta, tau), runs=5)
    z_h, _, aux = torch_apply(het, zeta, tau)
    p_avail = torch_draws(het, 20, "cuda")[0].double().mean().item()
    if abs(p_avail - het.availability) > 0.02:
        fail(f"torch_apply: P(available) {p_avail}, not within 0.02 of "
             f"{het.availability}")
    out["het"] = dict(ms=ms, p_available=p_avail,
                      kept=z_h.sum().item() / max(zeta.sum().item(), 1),
                      unavail=aux["unavail"].sum().item(),
                      dropout=aux["dropout"].sum().item())
    print(f"heterogeneity on the card: gate_windows equals the reference on "
          f"shared draws; torch_apply at N={N_TIMED}, 20 rounds "
          f"{json.dumps(out['het'])} on {smi}", flush=True)
    return out


# phase 13: telemetry on full-width training, N = 20, batch 32
TEL_ROUNDS = 8
TEL_MODES = {"off": [], "registry": ["--telemetry"],
             "suite": ["--telemetry", "--perdevice", "--probes"]}
# unprofiled runs in turns, so that each mode is read twice on one card
TEL_ORDER = ("off", "registry", "suite", "suite", "registry", "off")


def check_telemetry(name: str, res, rounds: int) -> None:
    """The fetched snapshot agrees with itself and with the run's history;
    fails the phase on a miss."""
    tel = res.telemetry
    snap = tel["metrics"] if "metrics" in tel else tel
    c, h = snap["counters"], snap["hist"]
    checks = {
        "rounds": c["rounds"] == rounds,
        "successes = uploads": c["successes"] == res.history["uploads"][-1],
        "staleness, contact_tau bins = contacts": all(
            h[k].sum() == c["contacts"] for k in ("staleness", "contact_tau")),
        "k, bits, b bins = successes": all(
            h[k].sum() == c["successes"] for k in ("k", "bits", "b")),
    }
    if "device" in tel:
        checks["table successes = counter"] = \
            tel["device"]["successes"].sum() == c["successes"]
        checks["table rounds"] = tel["device"]["rounds"] == rounds
    if "probes" in tel:
        checks["probes contacts = counter"] = \
            tel["probes"]["contacts"] == c["contacts"]
    missed = [k for k, ok in checks.items() if not ok]
    if missed:
        fail(f"{name}: telemetry snapshot inconsistent ({missed}): {snap['counters']}")


def telemetry_run(K, arch: str, mode: str, profile: bool = False) -> dict:
    """One full-width ``mads`` run through the training CLI with the mode's
    flags (and ``--profile-dir``): one sparsify_ef launch a round, the
    snapshot's checks, telemetry.jsonl read back and rendered, and with a
    profile the span names and the sparsify kernel in its Chrome trace."""
    from repro_torch.launch import train as T
    from repro_torch.telemetry import read_jsonl, render_report

    name = f"{arch} mads telemetry {mode}{' + profile' if profile else ''}"
    with tempfile.TemporaryDirectory() as wd:
        argv = ["--arch", arch, "--policy", "mads", "--rounds", str(TEL_ROUNDS),
                "--devices", str(N_DEV), "--batch-size", "32", "--train-n",
                "2000", "--eval-every", str(TEL_ROUNDS), "--intercontact", "20",
                "--device", "cuda", "--seed", "0", "--workdir", wd,
                *TEL_MODES[mode]]
        if profile:
            argv += ["--profile-dir", f"{wd}/prof"]
        K.reset_launches()
        res = T.main(argv)
        launches = K.LAUNCHES["sparsify_ef"]
        events = read_jsonl(f"{wd}/telemetry.jsonl")
        trace = (json.loads(Path(f"{wd}/prof/trace.json").read_text())
                 if profile else None)
    if launches != TEL_ROUNDS or sum(K.LAUNCHES.values()) != TEL_ROUNDS:
        fail(f"{name}: sparsify_ef not launched once a round: {K.LAUNCHES}")
    kinds = [e["kind"] for e in events]
    spans = {e["name"] for e in events if e["kind"] == "span"}
    if spans != {"compile", "execute", "eval"}:
        fail(f"{name}: spans {spans}")
    if mode == "off":
        if res.telemetry is not None or "metrics" in kinds:
            fail(f"{name}: telemetry recorded with every knob off")
    else:
        check_telemetry(name, res, TEL_ROUNDS)
        want = "probe_report" if mode == "suite" else "metrics"
        if kinds[-1] != want or "## Federation counters" not in \
                render_report(events):
            fail(f"{name}: telemetry.jsonl records {kinds[-3:]}")
    if profile:
        names = [e.get("name", "") for e in trace["traceEvents"]]
        kernels = sum("row_pass" in n for n in names)
        if not {"compile", "execute", "eval"} <= set(names) or kernels < TEL_ROUNDS:
            fail(f"{name}: the Chrome trace lacks the spans or the sparsify "
                 f"kernel ({kernels} row_pass events)")
    steady = res.round_seconds[1:]
    out = dict(rps=len(steady) / sum(steady), launches=launches,
               eval=res.history["eval"][-1], uploads=res.history["uploads"][-1])
    print(f"telemetry run {name}: {json.dumps(out)}", flush=True)
    del res
    torch.cuda.empty_cache()
    return out


def telemetry_costs() -> dict:
    """Host ms per round of the records of the registry, the per-device
    table (with its heterogeneity update), the probes and the full suite
    on card tensors at N = 20 (mean over 200 records, no wait inside),
    with the card's sync debug mode set to raise on any synchronising
    call; and the kernels one record launches and their device ms (from a
    torch.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.telemetry import (AFL_REGISTRY, DeviceTable, TelemetrySuite,
                                       TheoryProbes, record_het, record_round)

    g = torch.Generator(device="cuda").manual_seed(0)
    okf = (torch.rand(N_DEV, generator=g, device="cuda") < 0.5).float()
    m = {"uploads": okf, "success": okf, "theta": torch.randint(
        1, 50, (N_DEV,), generator=g, device="cuda").float(),
         "k": okf * 1e5, "bits": okf * 4.7e6, "b": okf * 32,
         "energy": okf * 0.3, "x_norm2": okf + 1.0, "e_norm2": okf * 1e-3}
    tau = torch.rand(N_DEV, generator=g, device="cuda") * 10
    het = {"unavail": okf, "dropout": 1.0 - okf}
    table, probes = DeviceTable(N_DEV), TheoryProbes(s=S_RESNET9)
    # the suite, and each of its parts alone (which update costs what)
    suites = {"registry": AFL_REGISTRY,
              "table": TelemetrySuite(device=table),
              "probes": TelemetrySuite(probes=probes),
              "suite": TelemetrySuite(metrics=AFL_REGISTRY, device=table,
                                      probes=probes)}
    out = {}
    for label, tel in suites.items():
        def record(state):
            return record_het(tel, record_round(tel, state, m, tau), het)

        state = tel.init_state("cuda")
        for _ in range(3):
            state = record(state)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            for _ in range(200):
                state = record(state)
            host_ms = (time.perf_counter() - t0) / 200 * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            record(state)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            prof.export_chrome_trace(f"{d}/t.json")
            evs = json.loads(Path(f"{d}/t.json").read_text())["traceEvents"]
        kernels = [e for e in evs if e.get("cat") == "kernel"]
        out[label] = dict(host_ms_per_record=host_ms, kernels_per_record=len(
            kernels), device_ms_per_record=sum(e.get("dur", 0)
                                                for e in kernels) / 1e3)
    print(f"telemetry record cost (N={N_DEV}, card tensors, no sync under "
          f"set_sync_debug_mode('error')): {json.dumps(out)}", flush=True)
    return out


def telemetry_against_cpu() -> None:
    """The same telemetry run on the card and on the CPU from one seed:
    ResNet-9 width 4, ``mads``, 6 rounds, Manhattan schedule (numpy
    backend, the same arrays on both) with heterogeneity.  Counters, bins
    and the table's count fields equal; float fields within the CPU tests'
    whole-run tolerances (rtol 1e-4; e_norm2 rtol 0.5)."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core.runner import run_afl
    from repro_torch.data import DeviceLoader
    from repro_torch.launch.train import build_device_data
    from repro_torch.models.registry import build_model

    model = build_model(get_config(RESNET9).replace(d_model=4))
    fl = FLConfig(num_devices=12, rounds=6, batch_size=8,
                  mobility_model="manhattan", speed=15.0, area=400.0,
                  het_dropout=0.2, het_availability=0.8,
                  telemetry_perdevice=True, telemetry_probes=True)
    dev, ev = build_device_data(model.cfg, fl, train_n=160, seed=0)
    snaps = {d: run_afl(model, model.cfg, fl, "mads", DeviceLoader(dev, 8, 0),
                        ev, rounds=6, eval_every=3, device=d).telemetry
             for d in ("cuda", "cpu")}
    a, b = snaps["cuda"], snaps["cpu"]
    am, bm = a["metrics"], b["metrics"]
    miss = [k for k in ("rounds", "contacts", "successes")
            if am["counters"][k] != bm["counters"][k]]
    miss += [k for k in am["hist"] if not np.array_equal(am["hist"][k],
                                                         bm["hist"][k])]
    miss += [k for k in ("contacts", "successes", "failures", "last_contact",
                         "staleness_sum", "staleness_max", "unavail",
                         "dropouts")
             if not np.array_equal(a["device"][k], b["device"][k])]
    miss += [k for k in ("rounds", "contacts", "successes")
             if a["probes"][k] != b["probes"][k]]
    miss += [k for k in ("bits_total", "energy_total")
             if not np.isclose(am["counters"][k], bm["counters"][k], rtol=1e-4)]
    miss += [k for k in ("tau_sum", "bits_sum", "energy_sum")
             if not np.allclose(a["device"][k], b["device"][k], rtol=1e-4)]
    if not np.allclose(a["device"]["e_norm2"], b["device"]["e_norm2"],
                       rtol=0.5, atol=1e-9):
        miss.append("e_norm2")
    if miss or not am["counters"]["contacts"] > 0:
        fail(f"telemetry cuda vs cpu differ in {miss}: {am['counters']} vs "
             f"{bm['counters']}")
    print(f"telemetry cuda run matches cpu run (resnet9 width 4, manhattan + "
          f"heterogeneity): counters {am['counters']}, unavail "
          f"{a['device']['unavail'].sum()}, dropouts "
          f"{a['device']['dropouts'].sum()}", flush=True)


def examples_on_card() -> None:
    """The example twins on the card: the quickstart, and the speed sweep
    for the exponential and Manhattan models (30 rounds; the table is
    printed, the speed trend not asserted)."""
    from repro_torch.examples import mobility_speed_sweep, quickstart

    res = quickstart.main(["--device", "cuda"])
    if not (res.history["uploads"][-1] > 0 and math.isfinite(res.final_eval)):
        fail(f"quickstart: {res.history}")
    rows = mobility_speed_sweep.main(["--models", "exponential,manhattan",
                                      "--device", "cuda"])
    if len(rows) != 8 or not all(math.isfinite(r["acc"]) for r in rows):
        fail(f"speed sweep: {rows}")
    print(f"speed sweep (ResNet-9 width 8, N 8, 30 rounds, afl-spar): "
          f"{json.dumps(rows)}", flush=True)


def telemetry_phase(K, smi: str) -> dict:
    """Phase 13: full-width ResNet-9 and LaneGCN ``mads`` with telemetry
    off, with the registry and with the full suite (in turns: two reads
    each for ResNet-9, six for LaneGCN), the record costs, the card against the CPU, the examples, and
    last a profiled full-suite run per model.  Returns the sparsify_ef
    launch count of each run."""
    runs, launches = {}, {}
    # LaneGCN's host-bound rounds spread more: three passes of the turns
    for arch, passes in ((RESNET9, 1), (LANEGCN, 3)):
        for mode in TEL_ORDER * passes:
            out = telemetry_run(K, arch, mode)
            runs.setdefault((arch, mode), []).append(out["rps"])
            launches[f"{arch} {mode}"] = out["launches"]
    print(f"rounds/s with telemetry (steady, full width, mads, N={N_DEV}, "
          f"batch 32, {TEL_ROUNDS} rounds; in turns, ResNet-9 two runs each, "
          f"LaneGCN six) on {smi}: "
          + "; ".join(f"{arch} {mode} {rps}" for (arch, mode), rps in
                      runs.items()), flush=True)
    telemetry_costs()
    telemetry_against_cpu()
    examples_on_card()
    for arch in (RESNET9, LANEGCN):
        out = telemetry_run(K, arch, "suite", profile=True)
        launches[f"{arch} suite + profile"] = out["launches"]
        print(f"rounds/s with the full suite under --profile-dir ({arch}) on "
              f"{smi}: {out['rps']}", flush=True)
    return launches


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time for the work: bytes over the HBM rate or operations
    over the peak rate of their type (a key of PEAK_OPS_PER_S), whichever
    is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def build_kernels(mods: dict) -> None:
    """Phase 2: one nvcc per source, all started together."""
    from repro_torch.kernels import build

    def timed(lib):
        t0 = time.perf_counter()
        lib()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(mods)) as ex:
        secs = {name: ex.submit(timed, mod.library) for name, mod in mods.items()}
        secs = {name: f.result() for name, f in secs.items()}
    for name, t in secs.items():
        print(f"build: {build.library_path(name).name} in {t:.2f} s", flush=True)
        log = build.log_path(name)
        for line in log.read_text().splitlines() if log.exists() else ():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def _randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _max_excess(got, want, tol: float) -> tuple:
    """(max |got - want|, max of |got - want| - tol * (1 + |want|))."""
    g, w = got.double(), want.double()
    d = (g - w).abs()
    return d.max().item(), (d - tol * (1 + w.abs())).max().item()


def check_decode_attn(DA, R, card: str) -> dict:
    """Phase 3 for decode_attn: against its plain version, then timed."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    err = 0.0
    shapes = [(2, 8, 2, 1024, 64), (1, 4, 4, 512, 128), (2, 6, 2, 777, 64),
              (1, 16, 2, 2048, 128), (2, 16, 2, 1024, 64), DECODE_MAIN,
              DECODE_DEEP]
    for b, h, kv, s, d in shapes:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            q = _randn((b, h, d), gen, dtype)
            k = _randn((b, s, kv, d), gen, dtype)
            v = _randn((b, s, kv, d), gen, dtype)
            case_err = 0.0
            for length in sorted({1, 63, int(0.7 * s), s}):
                got = DA.decode_attn_cuda(q, k, v, length)
                want = R.decode_attn_plain(q, k, v, length)
                torch.cuda.synchronize()
                e, excess = _max_excess(got, want, tol)
                if excess > 0:
                    fail(f"decode_attn differs by {e} at {(b, h, kv, s, d)} "
                         f"{dtype} length {length}")
                case_err = max(case_err, e)
            err = max(err, case_err)
            print(f"decode_attn matches plain at (B, H, KV, S, D) = "
                  f"{(b, h, kv, s, d)} {dtype}: max abs err {case_err:.3g}",
                  flush=True)
            del q, k, v, got, want
    # positions at and beyond length never count
    q = _randn((1, 4, 64), gen)
    k, v = _randn((1, 512, 2, 64), gen), _randn((1, 512, 2, 64), gen)
    out1 = DA.decode_attn_cuda(q, k, v, 100)
    k[:, 100:], v[:, 100:] = 1e4, -1e4
    if not torch.equal(out1, DA.decode_attn_cuda(q, k, v, 100)):
        fail("decode_attn reads the masked tail")
    print("decode_attn ignores the masked tail", flush=True)

    out = {}
    dt = torch.bfloat16
    for label, (b, h, kv, s, d) in (("main", DECODE_MAIN), ("deep", DECODE_DEEP)):
        q = _randn((b, h, d), gen, dt)
        caches = [(_randn((b, s, kv, d), gen, dt), _randn((b, s, kv, d), gen, dt))
                  for _ in range(CACHES if label == "main" else 1)]
        k, v = caches[0]
        mask = torch.ones((1, 1, 1, s), dtype=torch.bool, device="cuda")

        def sdpa(kv_):
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kv_[0].transpose(1, 2), kv_[1].transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        def kernel(kv_):
            return DA.decode_attn_cuda(q, kv_[0], kv_[1], s)

        lib_err = (sdpa(caches[0])[:, :, 0].float()
                   - R.decode_attn_plain(q, k, v, s).float()).abs().max().item()
        res = dict(
            ms=median_ms(rotation(kernel, caches)),
            # one call at a time on one cache: the kernels line's earlier ms
            ms_per_call=per_call_ms(lambda: kernel(caches[0])),
            plain_ms=median_ms(lambda: R.decode_attn_plain(q, k, v, s)),
            library_ms=median_ms(rotation(sdpa, caches)), max_abs_err=err,
            # K and V rows read once, q read and the output written once
            **bound(2 * b * s * kv * d * 2 + 2 * b * h * d * 2,
                    4 * b * h * s * d, dt))
        res["bound_share"] = res["bound_ms"] / res["ms"]
        if label == "main":
            res.update(
                ms_one_cache=median_ms(lambda: kernel(caches[0])),
                library_ms_one_cache=median_ms(lambda: sdpa(caches[0])))
        print(f"decode_attn ({label}, (B, H, KV, S, D) = {(b, h, kv, s, d)}, "
              f"bf16, length {s}, {len(caches)} cache(s) in rotation): "
              f"{res['ms']:.4f} ms (plain {res['plain_ms']:.4f} ms, SDPA "
              f"{res['library_ms']:.4f} ms [max abs diff to plain "
              f"{lib_err:.3g}], bound {res['bound_ms']:.4f} ms by "
              f"{res['bound_by']}, {100 * res['bound_share']:.1f} % of it) on "
              f"{card}; unrounded {json.dumps(res)}", flush=True)
        out[label] = res
        del q, k, v, caches
    return out


def ssd_causal_flops(b, s, h, p, n, q) -> float:
    """Operations the chunked SSD needs: per (batch, chunk) the lower
    triangle of C B^T (N each; b and c have no head axis, so every head
    shares it), and per (batch, head, chunk) the lower triangle of
    (C B^T * L) X (P each), the carried state's contribution to y and the
    chunk's new state (2QNP each)."""
    tri = q * (q + 1) // 2
    chunks = b * (s // q)
    return chunks * (2 * tri * n + h * (2 * tri * p + 4 * q * n * p))


def check_ssd_scan(SSD, R, card: str) -> dict:
    """Phase 3 for ssd_scan: against its plain version, then timed."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    err = 0.0
    for b, s, h, p, n, q in [(2, 256, 4, 64, 32, 64), (1, 128, 2, 32, 16, 32),
                             (1, 512, 8, 64, 64, 128), (1, 1024, 4, 64, 128, 256),
                             SSD_MAIN]:
        x = _randn((b, s, h, p), gen)
        if s == 1024:  # ~ -0.4 a step: in-chunk cumsums reach |100|
            a = -0.4 + 0.05 * _randn((b, s, h), gen)
        else:
            a = -_randn((b, s, h), gen).abs() * 0.5
        bb, cc = _randn((b, s, n), gen), _randn((b, s, n), gen)
        y, st = SSD.ssd_scan_cuda(x, a, bb, cc, q)
        # the plain version in f64 on the same (exactly upcast) inputs: the
        # f32 chunked formula carries ~5e-4 of its own rounding at chunk 256
        yr, sr = R.ssd_scan_plain(*(t.double() for t in (x, a, bb, cc)), q)
        torch.cuda.synchronize()
        case_err = 0.0
        for name, got, want in (("y", y, yr), ("state", st, sr)):
            e, excess = _max_excess(got.double(), want, 2e-4)
            if excess > 0:
                fail(f"ssd_scan {name} differs by {e} at {(b, s, h, p, n, q)}")
            case_err = max(case_err, e)
        err = max(err, case_err)
        y32 = R.ssd_scan_plain(x, a, bb, cc, q)[0]
        print(f"ssd_scan matches plain (f64) at (B, S, H, P, N, chunk) = "
              f"{(b, s, h, p, n, q)}: max abs err {case_err:.3g}; the f32 "
              f"plain version is {(y32.double() - yr).abs().max().item():.3g} "
              f"from it, the kernel {(y.double() - y32.double()).abs().max().item():.3g} "
              f"from the f32 plain", flush=True)
        del yr, sr, y32
    # x, a, b, c read once; y and the final state written once
    nbytes = 4 * (2 * x.numel() + a.numel() + 2 * bb.numel() + st.numel())
    flops = ssd_causal_flops(b, s, h, p, n, q)
    res = dict(
        ms=median_ms(lambda: SSD.ssd_scan_cuda(x, a, bb, cc, q)),
        ms_per_call=per_call_ms(lambda: SSD.ssd_scan_cuda(x, a, bb, cc, q)),
        plain_ms=median_ms(lambda: R.ssd_scan_plain(x, a, bb, cc, q)),
        library_ms=None, max_abs_err=err,
        # 3xTF32: three tensor-core products per f32-accurate product
        **bound(nbytes, 3 * flops, "tf32"))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["bound_ms_f32_simt"] = bound(nbytes, flops, torch.float32)["bound_ms"]
    print(f"ssd_scan (main, {SSD_MAIN}, f32): {res['ms']:.4f} ms (plain "
          f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']} at the TF32 rate x 3, {100 * res['bound_share']:.1f} "
          f"% of it; {res['bound_ms_f32_simt']:.4f} ms at the f32 rate without "
          f"tensor cores) on {card}; unrounded {json.dumps(res)}", flush=True)
    return res


def llm_kernel_calls(DA, SSD) -> dict:
    """Calls of ``decode_attn`` at its timed shapes (the serve shape over
    CACHES caches in rotation) and of ``ssd_scan`` at the serve shape, on
    fresh inputs, by label."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    dt = torch.bfloat16
    calls = {}
    for label, (b, h, kv, s, d) in (("main", DECODE_MAIN), ("deep", DECODE_DEEP)):
        q = _randn((b, h, d), gen, dt)
        caches = [(_randn((b, s, kv, d), gen, dt), _randn((b, s, kv, d), gen, dt))
                  for _ in range(CACHES if label == "main" else 1)]
        calls[f"decode_attn_{label}"] = rotation(
            lambda c, q=q, s=s: DA.decode_attn_cuda(q, c[0], c[1], s), caches)
    b, s, h, p, n, q = SSD_MAIN
    x, a = _randn((b, s, h, p), gen), -_randn((b, s, h), gen).abs() * 0.5
    bb, cc = _randn((b, s, n), gen), _randn((b, s, n), gen)
    calls["ssd_scan"] = lambda: SSD.ssd_scan_cuda(x, a, bb, cc, q)
    return calls


def profile_kernels(DA, SSD) -> None:
    """Device time by kernel (``device_times``) of the LLM kernels' calls.
    Run last, so that the profiler's tracing cannot weigh on the
    host-bound decodes of phases 7-8."""
    for label, fn in llm_kernel_calls(DA, SSD).items():
        print(f"{label} device time by kernel: {json.dumps(device_times(fn))}",
              flush=True)


def profile_rounds(arch: str, policy: str = "mads", rounds: int = 6) -> dict:
    """Phase 14 for training: a full-width run of ``rounds`` rounds (one
    eval, at the end) under ``torch.profiler``; the device-busy time per
    round (every kernel of the run, model set-up and the eval included,
    divided by the rounds) against the steady rounds' wall clock, and the
    kernels that take the most device time per round."""
    from torch.profiler import ProfilerActivity, profile

    argv = ["--arch", arch, "--policy", policy, "--rounds", str(rounds),
            "--devices", str(N_DEV), "--batch-size", "32", "--train-n", "2000",
            "--intercontact", "20", "--eval-every", str(rounds), "--device",
            "cuda", "--seed", "0"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = train(argv)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            by_kernel[e.key[:60]] = us / rounds / 1e3
    busy_ms = sum(by_kernel.values())
    steady = res.round_seconds[1:]
    wall_ms = 1e3 * sum(steady) / len(steady)
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    out = dict(arch=arch, policy=policy, rounds=rounds,
               device_busy_ms_per_round=busy_ms, wall_ms_per_round=wall_ms,
               busy_share=busy_ms / wall_ms, kernels=len(by_kernel),
               top_device_ms_per_round=top)
    print(f"profile {arch} {policy} (profiled, full width): {json.dumps(out)}",
          flush=True)
    return out


def profile_schedules(engine: dict) -> None:
    """Phase 14 for the device-resident scenario engine: device-busy ms of
    one N = 1e5 schedule build per model (every kernel of the build, by
    ``device_times``) against phase 12's ms between CUDA events, and the
    kernels that take the most."""
    from repro_torch.scenarios import TORCH_MODELS, torch_schedule_from_model

    for name in DEVICE_MODELS:
        model = TORCH_MODELS[name](num_devices=N_TIMED, area=2000.0, seed=0,
                                   device="cuda")
        by_kernel = device_times(
            lambda: torch_schedule_from_model(model, 20, 10.0), runs=3)
        busy = sum(by_kernel.values())
        top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4])
        out = dict(model=name, device_busy_ms=busy,
                   event_ms=engine[name]["ms"],
                   busy_share=busy / engine[name]["ms"], kernels=len(by_kernel),
                   top_device_ms=top)
        print(f"profile device engine (N={N_TIMED}, 20 rounds x 10 s): "
              f"{json.dumps(out)}", flush=True)


def serve_full(mods, arch: str, batch: int, prompt: int):
    """Phases 7-8: the full-width serve path, counts read around it."""
    from repro_torch.launch import serve as S

    for mod in mods.values():
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    cfg, toks, stats = S.main(["--arch", arch, "--batch", str(batch),
                               "--prompt-len", str(prompt), "--gen", str(GEN),
                               "--device", "cuda", "--seed", "0"])
    launches = {k: v for mod in mods.values() for k, v in mod.LAUNCHES.items()}
    if tuple(toks.shape) != (batch, GEN):
        fail(f"{arch}: tokens {tuple(toks.shape)}")
    if not (int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size):
        fail(f"{arch}: tokens outside [0, {cfg.vocab_size})")
    if not torch.isfinite(stats["prefill_logits"].float()).all():
        fail(f"{arch}: prefill logits not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve {arch} (full width, batch {batch}, prompt {prompt}, gen "
          f"{GEN}): prefill_s {stats['prefill_s']}, decode_s "
          f"{stats['decode_s']}, tok/s {stats['tok_per_s']}, peak "
          f"{peak:.2f} GiB, launches {launches}", flush=True)
    del toks, stats
    torch.cuda.empty_cache()
    return cfg, launches


def serve_against_cpu():
    """Phase 9: reduced float32 serves on the card and on the CPU agree."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model

    for arch in ("llama3.2-3b", "mamba2-2.7b"):
        cfg = get_config(arch).reduced().replace(dtype="float32",
                                                 param_dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))
        out = {}
        for dev in ("cuda", "cpu"):
            p = model.layout.unflatten(model.layout.flatten(params).to(dev))
            out[dev] = serve(cfg, model, p, prompts.to(dev), gen=8)
        (tg, sg), (tc, sc) = out["cuda"], out["cpu"]
        e = (sg["prefill_logits"].cpu() - sc["prefill_logits"]).abs().max().item()
        if not torch.equal(tg.cpu(), tc) or e > 1e-3:
            fail(f"{arch}: card and CPU serves differ: tokens {tg.tolist()} vs "
                 f"{tc.tolist()}, prefill logits by {e}")
        print(f"serve {arch} (reduced, f32) on the card matches the CPU: "
              f"tokens {tc[0].tolist()}, prefill logits within {e:.3g}",
              flush=True)


def time_tree(tree: str) -> None:
    """``--time-tree DIR``: device times of the LLM kernels from the port
    in DIR/src (another checkout, say a parent commit's), by this script's
    method, as one JSON line; so that two commits' kernels are timed alike
    in one call."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import decode_attn as DA
    from repro_torch.kernels import ssd_scan as SSD

    calls = llm_kernel_calls(DA, SSD)
    out = {"tree": tree, "card": torch.cuda.get_device_name(0)}
    out.update({f"{label}_ms": median_ms(fn) for label, fn in calls.items()})
    out["ssd_scan_device_ms_by_kernel"] = device_times(calls["ssd_scan"])
    print(json.dumps(out), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if sys.argv[1:2] == ["--time-tree"]:
        return time_tree(sys.argv[2])
    from repro_torch.kernels import decode_attn as DA
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import sparsify_ef as K
    from repro_torch.kernels import ssd_scan as SSD

    mods = {"sparsify_ef": K, "decode_attn": DA, "ssd_scan": SSD}
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {kind} ({smi}), {sms} SMs; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # 2. build
    build_kernels(mods)

    # 3. kernels against their plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timing = check_kernels(K, R, smi)
    segmented = check_segmented(K, R, smi)
    decode = check_decode_attn(DA, R, smi)
    ssd = check_ssd_scan(SSD, R, smi)
    torch.cuda.empty_cache()

    # 4. training path, ResNet-9; counts read around each run
    # (results dropped at once: ResNet-9's (N, s) state holds ~1.6 GB,
    # which would count in the serve phases' peak memory)
    launches_mads, rps_mads = main_path(K, "mads")[:2]
    if launches_mads["sparsify_ef"] != ROUNDS:
        fail(f"mads did not launch sparsify_ef once a round: {launches_mads}")
    launches_joint, rps_joint = main_path(K, "mads-joint")[:2]
    if launches_joint["sparsify_quantize_ef"] != ROUNDS:
        fail(f"mads-joint did not launch sparsify_quantize_ef once a round: "
             f"{launches_joint}")
    launches_pl, rps_pl = main_path(K, "mads-joint", per_layer=True)[:2]
    if launches_pl["sparsify_quantize_ef_segmented"] != ROUNDS:
        fail(f"per-layer mads-joint did not launch the segmented kernel once "
             f"a round: {launches_pl}")
    print(f"rounds/s (steady, full-width ResNet-9, N={N_DEV}, batch 32) on "
          f"{smi}: mads {rps_mads}, mads-joint {rps_joint}, mads-joint "
          f"per-layer {rps_pl}", flush=True)

    # 5. training path, LaneGCN (the paper's Argoverse experiment)
    lanegcn = {}
    for policy, per_layer, kernel in (
            ("mads", False, "sparsify_ef"),
            ("qsgd", False, "sparsify_quantize_ef"),
            ("mads-joint", True, "sparsify_quantize_ef_segmented")):
        launches, rps, res = main_path(K, policy, LANEGCN, per_layer)
        if launches[kernel] != ROUNDS:
            fail(f"lanegcn {policy}: {kernel} not launched once a round: "
                 f"{launches}")
        lanegcn[policy] = dict(launches=launches, rps=rps,
                               ade=res.history["eval"][-1])
        del res
    print(f"rounds/s (steady, full-width LaneGCN, N={N_DEV}, batch 32) on "
          f"{smi}: " + ", ".join(f"{p} {v['rps']} (eval ADE {v['ade']})"
                                 for p, v in lanegcn.items()), flush=True)

    # 6. against the CPU path at a small size
    check_against_cpu()
    torch.cuda.empty_cache()

    # 7-8. serve path at full width, counts read around each model's run
    cfg, launches_dense = serve_full(mods, "llama3.2-3b", LLAMA_BATCH, LLAMA_PROMPT)
    if launches_dense["decode_attn"] != cfg.num_layers * GEN:
        fail(f"dense serve launched decode_attn {launches_dense['decode_attn']} "
             f"times, not {cfg.num_layers} x {GEN}")
    cfg, launches_ssm = serve_full(mods, "mamba2-2.7b", MAMBA_BATCH, MAMBA_PROMPT)
    if launches_ssm["ssd_scan"] != cfg.num_layers:
        fail(f"ssm serve launched ssd_scan {launches_ssm['ssd_scan']} times, "
             f"not {cfg.num_layers}")

    # 9. serve against the CPU path at reduced size
    serve_against_cpu()
    torch.cuda.empty_cache()

    # 10-12. the scenario engine: numpy on the host, full-width training
    # under trace mobility, the device-resident engine on the card
    scenarios_numpy(smi)
    trace = trace_training(K, smi)
    engine = device_engine(smi)
    torch.cuda.empty_cache()

    # 13. telemetry on the training path
    tel_launches = telemetry_phase(K, smi)
    torch.cuda.empty_cache()

    # 14. device time by kernel, last (the profiler slows later launches)
    profile_kernels(DA, SSD)
    for arch in (LANEGCN, RESNET9):
        profile_rounds(arch)
    profile_schedules(engine)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name="sparsify_ef", route="cuda", source=src + "sparsify_ef.cu",
             replaces="src/repro/kernels/sparsify_ef.py:60",
             launches=launches_mads["sparsify_ef"], library_ms=None,
             launches_lanegcn_mads=lanegcn["mads"]["launches"]["sparsify_ef"],
             launches_resnet9_mads_manhattan=trace[f"{RESNET9} mads manhattan"][
                 "launches"]["sparsify_ef"],
             launches_lanegcn_mads_gauss_markov_device_het=trace[
                 f"{LANEGCN} mads gauss_markov"]["launches"]["sparsify_ef"],
             launches_telemetry=tel_launches,
             **timing["sparsify_ef"]),
        dict(name="sparsify_quantize_ef", route="cuda",
             source=src + "sparsify_ef.cu",
             replaces="src/repro/kernels/sparsify_ef.py:124",
             launches=launches_joint["sparsify_quantize_ef"], library_ms=None,
             launches_lanegcn_qsgd=lanegcn["qsgd"]["launches"][
                 "sparsify_quantize_ef"],
             launches_resnet9_mads_joint_rwp=trace[f"{RESNET9} mads-joint rwp"][
                 "launches"]["sparsify_quantize_ef"],
             **timing["sparsify_quantize_ef"]),
        # the per-layer codec's route to the same TPU kernel: launches and
        # times at ResNet-9's (20, 6,573,130), *_lanegcn at (20, 247,100)
        dict(name="sparsify_quantize_ef_segmented", route="cuda",
             source=src + "sparsify_ef.cu",
             replaces="src/repro/kernels/sparsify_ef.py:124",
             launches=launches_pl["sparsify_quantize_ef_segmented"],
             launches_lanegcn=lanegcn["mads-joint"]["launches"][
                 "sparsify_quantize_ef_segmented"],
             **segmented[RESNET9],
             **{f"{key}_lanegcn": segmented[LANEGCN][key] for key in
                ("ms", "ms_per_call", "plain_ms", "bound_ms", "bound_share",
                 "tiles")}),
        dict(name="decode_attn", route="cuda", source=src + "decode_attn.cu",
             replaces="src/repro/kernels/decode_attn.py:64",
             launches=launches_dense["decode_attn"], **decode["main"],
             **{f"{key}_32k": decode["deep"][key] for key in
                ("ms", "ms_per_call", "plain_ms", "library_ms", "bound_ms",
                 "bound_share")}),
        dict(name="ssd_scan", route="cuda", source=src + "ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:60",
             launches=launches_ssm["ssd_scan"], **ssd),
    ]
    for entry in kernels:
        entry["timing"] = TIMING
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
