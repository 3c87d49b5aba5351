#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-tree DIR   # time another checkout's kernels
    python3 chip_smoke.py --only 19,20      # phases 1, 2 and those named
                                            # (of 3c, 19, 20, 21) alone
    python3 chip_smoke.py --mesh 4          # the round over 4 cards

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
   - (3c) both sparsify kernels on one bf16 row of 2^31 + 2^20 columns:
     ``sparsify_ef`` at t = 0 (the count passes 2^31) and 1.5,
     ``sparsify_quantize_ef`` at base 0 and at a base whose dither
     columns cross 2^32, each held against its plain version in column
     blocks (uploads and the exact count bit-equal, errors within 1e-6),
     then both timed with their bytes bound;
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
9. serve reference: reduced Llama, Mamba2, Qwen3-MoE, Zamba2, Whisper
   (with its stub frames) and Qwen2-VL in float32 on the card and on the
   CPU from one seed, prompt 64 (a multiple of the reduced SSD chunk, 32):
   the same greedy tokens, prefill logits within 1e-3;
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
14. the whole-run engine (``experiments/``), full width, N = 20, batch
   32, exponential contacts: ``run_afl_scanned`` (the round captured once
   as a CUDA graph and replayed) against ``run_afl(engine="loop")`` on the
   same prestacked draws for ResNet-9 ``mads``, LaneGCN ``mads`` and
   LaneGCN per-layer ``mads-joint``, 8 rounds under cuDNN's deterministic
   algorithms (uploads equal, histories within rtol 2e-4 / atol 1e-5,
   bit-equal states printed, one sparsify launch a round; the engine
   replays under ``set_sync_debug_mode("error")``); steady rounds/s of
   both engines in turns, 20 rounds, evals and peak memory apart;
   ``run_seed_batch`` (S = 3 LaneGCN, S = 2 ResNet-9) against each seed's
   own run, and its rounds/s against the S single runs; the sweep CLI at
   full-width LaneGCN (8 cells, a resumed second call, ``report.md``);
   the ``cifar_mads_vs_baselines`` twin;
15. ingest (``serve/``, ``launch/soak.py``), every fused ingest under
   ``torch.cuda.set_sync_debug_mode("error")``: full-width ResNet-9, N =
   20, batch 32, exponential contacts, 4 rounds of each codec policy
   (``mads-topk``, ``mads-joint``, ``qsgd``, ``fixed-kb``) through
   ``afl_round`` with ``expose_uploads``, every round's uploads encoded to
   the wire and ingested by an ``IngestServer`` at batch = N, max_k = s:
   the server's weights against ``afl_round``'s after each round (bit
   equality printed, rtol 1e-6 asserted); the soak CLI's points at s
   = 6,573,130 (``topk`` and ``joint``: batch 64, max_k 65,536, 1,024
   uploads in chunks of 64) and s = 247,100 (``topk``: batch 256, max_k
   4,096, 10,000 uploads; ``topk32``: 2,048), each set of payloads made
   once by ``make_payloads`` (one sparsify launch per chunk; each chunk
   shape's kernel call held against its plain version) and driven
   through ``ingest_soak`` in the parity and scatter modes in turns and
   with ``hinge`` staleness once: fused and loop uploads/s, host ms per
   pack, device ms per ingest (CUDA events), the device-busy share of a
   step, peak memory; the snapshot's counters add up;
16. federated LM fine-tuning: the training CLI with ``--reduced`` for
   ``internlm2-1.8b`` (dense) and ``mamba2-2.7b`` (ssm), ``mads``, N = 20,
   batch 32, seq 64, 8 rounds, loop and captured engines in turns: one
   ``sparsify_ef`` launch a round, one ``ssd_scan`` launch a Mamba2
   layer at each eval, uploads > 0, a finite loss, w moved, steady
   rounds/s; the first loop run's kernel calls (``sparsify_ef`` at (20,
   s), ``ssd_scan`` at the eval's shape) held against their plain
   versions; each round of a float32 run (N = 4) on the card from the
   CPU run's state against the CPU's round in f32 and f64 (successes
   equal, k within 2, the update and the sparsifier's input no further
   from f64 than 3x the CPU's, the eval of the CPU's weights within
   1e-4); the CUDA ``ssd_scan`` refusing inputs that require a gradient;
   the ``federated_llm_finetune`` twin;
17. serve, other families: ``repro_torch.launch.serve`` in-process, bf16,
   random weights from a CUDA generator, gen 32, at full width:
   Qwen3-MoE-30B-A3B (48 layers, batch 4, prompt 2048: ``decode_attn``
   48 x 32 times at G 8, D 128), Qwen2-MoE-A2.7B (24 layers, batch 8,
   prompt 2048: 24 x 32 at G 1), Zamba2-7B (81 layers, batch 4, prompt
   4096: ``ssd_scan`` once per Mamba2 layer of the prefill, 81, at 112
   heads and N 64; its shared attention's decode is the plain
   ``window_pos`` path, as the reference's), Whisper-large-v3 (32 + 32
   layers, batch 8, prompt 64, frames (8, 1500, 1280): ``decode_attn`` 32
   x 32 times for the cross-attention over 1,500 encoder positions) and
   Qwen2-VL-72B at full width cut to 8 of its 80 layers (135.4 GiB of
   bf16 at full depth do not fit one card; batch 4, prompt 2048: 8 x 32),
   each model freed before the next; launch counts read around each run,
   tokens in [0, vocab), finite logits, prefill and decode seconds,
   tok/s, peak GiB; each model's first kernel call at each new shape held
   against its plain version (phase 3's tolerances);
18. profile: a ``torch.profiler`` pass over ``decode_attn`` and
   ``ssd_scan`` at their timed shapes, device time by kernel (the five
   launches of ``ssd_scan``), and over a few full-width training rounds
   of LaneGCN and ResNet-9 (``mads``), eager and captured: device-busy
   seconds per round against the wall clock, the kernels that take the
   most, and the sparsify kernels the card ran in the captured run; and
   over one N = 1e5 schedule build per model (device-busy ms against
   phase 12's time); and over 4 decode steps of full-width Qwen3-MoE and
   of the 8-layer Qwen2-VL (device-busy ms a step against phase 17's
   wall ms a step: whether the host paces the decode); last, so that the
   profiler's tracing cannot weigh on the host-bound decodes, rounds and
   builds timed before it;
19. the distributed AFL round (``core/distributed.py``), run before 18:
   ``make_afl_train_system`` on a single-rank NCCL client mesh
   (``launch/mesh.py``) at full-width InternLM2-1.8B (s = 1,889,110,016,
   bf16 weights and client states), N = 2, global batch 4, seq 512,
   ``donate=True``, 4 rounds through ``run_afl_rounds`` of ``mads``
   (``sparsify_ef`` at (2, s) bf16, once a round) and of sampled
   ``mads-joint`` (``sparsify_quantize_ef``, once a round), both clients
   in contact in round 2: launch counts, uploads > 0, a finite loss, w
   moved, round seconds, peak GiB (under 75), each kernel call held as it
   returns against its plain version on its own inputs, 2^26 columns at a
   time (uploads and counts bit-equal, errors within 1e-6); both kernels
   timed at that shape; reduced InternLM2 in f32 (N = 4, 3 rounds) on the
   card against the CPU from the CPU's state each round (phase 16's
   standard), and the same rounds through the single-rank group
   bit-equal to the rounds without one;
20. the seed and ingest meshes on a single-rank NCCL group (run after
   19): ``run_seed_batch(mesh=)`` at full-width ResNet-9 (N = 20, batch
   32, S = 2, 6 rounds of ``mads``, deterministic cuDNN) bit-equal to
   ``mesh=None`` (histories and states); phase 15's parity ingest of
   ``mads-topk`` and ``mads-joint`` through ``IngestServer(mesh=)`` at s =
   6,573,130, bit-equal to the server without a mesh every round and held
   to ``afl_round`` as phase 15 holds it; a soak point through
   ``run_soak(mesh=)`` (256 ``topk`` uploads, batch 64, one sparsify
   launch a chunk of 64, the counters adding up);
21. remat (``ModelConfig.remat``) at phase 19's configuration (full-width
   InternLM2-1.8B, N = 2 bf16 clients on a single-rank mesh, batch 4,
   seq 512, 4 ``mads`` rounds, ``donate=True``): first the allocator's
   history over the vmapped gradient under ``none``, its live blocks at
   the peak grouped by the port's allocating frame and by block size;
   then for ``none``, ``full`` and ``dots`` the gradient's peak over the
   state, the round's peak, steady round seconds and one sparsify launch
   a round; reduced InternLM2 in f32 on the card, each policy's vmapped
   gradient against ``none``'s (bit equality printed, beyond 1e-6 of the
   largest entry fails).

``--mesh P`` runs, on each of P cards (one process a card, a file
store): world 1 against world P for six policies at ResNet-9 width 4;
full-width InternLM2 with one bf16 client a card; the seed mesh at
full-width ResNet-9 (S = 4, one seed a card; on rank 0 each seed alone
and the four batched on its card: every history bit-equal, seed-rounds/s
of both); the ingest mesh at s = 6,573,130, batch 64, 1,024 ``topk``
uploads (w bit-equal on every rank; on rank 0 one card's server: counts
and bins equal, w within 1e-6 of its largest entry at 97 % of the
coordinates and 1e-4 everywhere; uploads/s of both).

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
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
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
# phase 17: (arch, batch, prompt, layers: 0 = the config's depth)
OTHER_SERVES = (("qwen3-moe-30b-a3b", 4, 2048, 0), ("qwen2-moe-a2.7b", 8, 2048, 0),
                ("zamba2-7b", 4, 4096, 0), ("whisper-large-v3", 8, 64, 0),
                ("qwen2-vl-72b", 4, 2048, 8))
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
        # the loop engine, whose numbers PERF.md keeps (the CLI's default
        # is the captured engine, phase 14)
        return T.main(["--engine", "loop"] + argv + ["--workdir", wd])


def train_per_layer(arch: str, rounds: int):
    """``mads-joint`` with ``FLConfig(per_layer_budget=True)`` through
    ``run_afl``, configured as the training CLI configures a run (the CLI
    has no per-layer switch, as the reference's has none)."""
    from repro_torch.core.runner import run_afl
    from repro_torch.data import DeviceLoader

    model, cfg, fl, dev, ev = engine_setup(arch, True, rounds)
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
                "--engine", "loop", *TEL_MODES[mode]]
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


# phase 14: the whole-run engine (a CUDA-graph-captured round), seed
# batching and the sweep CLI, full width, N = 20, batch 32
ENGINE_CASES = ((RESNET9, "mads", False), (LANEGCN, "mads", False),
                (LANEGCN, "mads-joint", True))
ENGINE_ROUNDS, ENGINE_TIMED_ROUNDS, ENGINE_EVERY = 8, 20, 4
HIST_RTOL, HIST_ATOL = 2e-4, 1e-5  # the reference's cross-engine tolerance
KERNEL_OF = {"mads": "sparsify_ef",
             "mads-joint": "sparsify_quantize_ef_segmented"}
# the device function each entry launches, as the profiler names it
KERNEL_SYMBOL = {"sparsify_ef": "row_pass",
                 "sparsify_quantize_ef_segmented": "segmented_pass"}


def engine_setup(arch: str, per_layer: bool, rounds: int):
    """(model, cfg, fl, device data, eval batch) of a full-width run,
    configured as the training CLI configures one (exponential contacts,
    mean inter-contact 20 s)."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.launch.train import build_device_data
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    fl = FLConfig(num_devices=N_DEV, rounds=rounds, batch_size=32,
                  mean_intercontact=20.0, seed=0, per_layer_budget=per_layer,
                  sparsifier="exact" if model.num_params() < 2_000_000
                  else "sampled")
    dev, ev = build_device_data(cfg, fl, train_n=2000, seed=0)
    return model, cfg, fl, dev, ev


def hist_close(a: dict, b: dict) -> bool:
    return a["round"] == b["round"] and all(
        abs(x - y) <= HIST_ATOL + HIST_RTOL * abs(y)
        for k in a if k != "round" for x, y in zip(a[k], b[k]))


def state_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("w", "w_n", "g_n", "e_n", "kappa", "q", "energy"))


def steady_rate(res) -> tuple:
    """(steady rounds/s, mean eval seconds) of a run: round 0 (which
    carries the warm-up, and the capture) left out."""
    steady = res.round_seconds[1:]
    ev = res.eval_seconds or [0.0]
    return len(steady) / sum(steady), sum(ev) / len(ev)


def captured_against_eager(K) -> dict:
    """Phase 14a: ``run_afl_scanned`` (captured round, replayed) against
    ``run_afl(engine="loop")`` on the same prestacked DeviceLoader draws,
    same seed, for each case.  Under ``torch.backends.cudnn.deterministic``
    (cuDNN's default weight-gradient algorithms add in another order from
    run to run, and LaneGCN's eval then drifts by ~1e-4 between two eager
    runs): uploads equal, histories within the reference's cross-engine
    tolerance, and whether the final states are bit-equal.  One sparsify
    launch a round (the counts reset just before the captured run, read
    just after); the engine runs its replays and evals under
    ``torch.cuda.set_sync_debug_mode("error")``.  A ``torch.profiler``
    pass over captured runs (phase 18, ``profile_captured``) counts the
    sparsify kernels the card ran, and the kernels line holds the two
    counts against each other (``captured_launches``)."""
    from repro_torch.core.runner import run_afl
    from repro_torch.data import DeviceLoader
    from repro_torch.experiments import prestack_batches, run_afl_scanned

    out = {"eager noise": eager_noise()}
    torch.backends.cudnn.deterministic = True
    try:
        for arch, policy, per_layer in ENGINE_CASES:
            name = f"{arch} {policy}{' per-layer' if per_layer else ''}"
            model, cfg, fl, dev, ev = engine_setup(arch, per_layer,
                                                   ENGINE_ROUNDS)
            kw = dict(rounds=ENGINE_ROUNDS, eval_every=ENGINE_EVERY,
                      device="cuda")
            loop = run_afl(model, cfg, fl, policy, DeviceLoader(dev, 32, 0),
                           ev, engine="loop", **kw)
            pre = prestack_batches(DeviceLoader(dev, 32, 0), ENGINE_ROUNDS)
            K.reset_launches()
            scan = run_afl_scanned(model, cfg, fl, policy, pre, ev, **kw)
            launches = dict(K.LAUNCHES)
            a, b = scan.history, loop.history
            if a["uploads"] != b["uploads"] or not hist_close(a, b):
                fail(f"{name}: captured and eager runs differ: {a} vs {b}")
            if launches[KERNEL_OF[policy]] != ENGINE_ROUNDS or \
                    sum(launches.values()) != ENGINE_ROUNDS:
                fail(f"{name}: {launches} sparsify launches in "
                     f"{ENGINE_ROUNDS} captured rounds, not one a round")
            bit_equal = state_equal(scan.state, loop.state)
            out[name] = dict(launches=launches, bit_equal_state=bit_equal,
                             uploads=a["uploads"], eval_captured=a["eval"],
                             eval_eager=b["eval"])
            print(f"captured matches eager ({name}, {ENGINE_ROUNDS} rounds, "
                  f"cudnn deterministic): {json.dumps(out[name])}", flush=True)
            del loop, scan, pre
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def eager_noise() -> dict:
    """Two eager LaneGCN ``mads`` runs of the loop engine, same seed and
    draws, cuDNN's default algorithms: how far apart run-to-run ordering
    alone puts them (why phase 14a compares under the deterministic
    ones)."""
    from repro_torch.core.runner import run_afl
    from repro_torch.data import DeviceLoader

    model, cfg, fl, dev, ev = engine_setup(LANEGCN, False, ENGINE_ROUNDS)
    a, b = (run_afl(model, cfg, fl, "mads", DeviceLoader(dev, 32, 0), ev,
                    rounds=ENGINE_ROUNDS, eval_every=ENGINE_EVERY,
                    device="cuda") for _ in range(2))
    out = dict(bit_equal_state=state_equal(a.state, b.state),
               eval_rel_diff=max(abs(x - y) / abs(y) for x, y in
                                 zip(a.history["eval"], b.history["eval"])),
               uploads_equal=a.history["uploads"] == b.history["uploads"])
    print(f"two eager LaneGCN mads runs, default cuDNN ({ENGINE_ROUNDS} "
          f"rounds): {json.dumps(out)}", flush=True)
    return out


def device_timeline(prof) -> tuple:
    """(ms in which at least one device activity runs, the streams they ran
    on) of a ``torch.profiler`` run: the union of the activities'
    intervals, which a plain sum overstates when activities overlap."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    streams = {e.device_resource_id for e in prof.events()
               if e.device_type == DeviceType.CUDA}
    return busy_us / 1e3, len(streams)


def profile_captured(K, arch: str, policy: str, per_layer: bool = False,
                     short: int = 2, long: int = ENGINE_ROUNDS) -> dict:
    """Phase 18 for the captured engine: two runs of ``short`` and ``long``
    rounds (one eval each, at the end) under ``torch.profiler``; their
    difference is ``long - short`` steady replays, set-up, round 0 and the
    eval cancelling: device-busy ms per replay (the kernels' summed times,
    and the union of their intervals, which overlapping kernels do not
    double) against the replays' wall ms (CUDA events), the streams the
    kernels ran on, the kernels that take the most (device ms and
    launches a replay), and the sparsify kernels the card ran (one a
    round: the profiler sees the graph's kernels), held against the
    ``LAUNCHES`` count of the same run (round 0, plus the capture's count
    once a replay) and per replay."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiments import DataShard, run_afl_scanned

    kernel = KERNEL_OF[policy]
    runs = {}
    for rounds in (short, long):
        model, cfg, fl, dev, ev = engine_setup(arch, per_layer, rounds)
        shard = DataShard(dev, 32, 0)
        K.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = run_afl_scanned(model, cfg, fl, policy, shard, ev,
                                  rounds=rounds, eval_every=rounds,
                                  device="cuda")
            torch.cuda.synchronize()
        counted = dict(K.LAUNCHES)
        by_kernel, calls = {}, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0:
                by_kernel[e.key[:60]] = (us / 1e3, e.count)
            if KERNEL_SYMBOL[kernel] in e.key:
                calls += e.count
        if calls != rounds or counted[kernel] != calls or \
                sum(counted.values()) != calls:
            fail(f"{arch} {policy} captured: the profiler saw {calls} "
                 f"{KERNEL_SYMBOL[kernel]} kernels in {rounds} rounds, "
                 f"LAUNCHES counted {counted}")
        runs[rounds] = (by_kernel, calls, res.round_seconds[1:],
                        device_timeline(prof))
    steps = long - short
    (k_short, c_short, _, (u_short, _)), \
        (k_long, calls, steady, (u_long, streams)) = runs[short], runs[long]
    per_replay = (calls - c_short) / steps
    if per_replay != 1:
        fail(f"{arch} {policy} captured: {per_replay} {kernel} kernels a "
             f"replay")
    # (device ms, launches) per replay, kernel by kernel
    per_round = {k: [(v - k_short.get(k, (0.0, 0))[0]) / steps,
                     (n - k_short.get(k, (0.0, 0))[1]) / steps]
                 for k, (v, n) in k_long.items()}
    busy_ms = sum(v[0] for v in per_round.values())
    wall_ms = 1e3 * sum(steady) / len(steady)
    top = dict(sorted(per_round.items(), key=lambda kv: -kv[1][0])[:6])
    union_ms = (u_long - u_short) / steps
    out = dict(arch=arch, policy=policy, per_layer=per_layer,
               rounds=[short, long], kernel=kernel,
               sparsify_kernels_profiled=calls,
               sparsify_kernels_profiled_per_replay=per_replay,
               device_busy_ms_per_round=busy_ms, wall_ms_per_round=wall_ms,
               busy_share=busy_ms / wall_ms,
               device_busy_union_ms_per_round=union_ms,
               busy_share_union=union_ms / wall_ms, streams=streams,
               kernels=len(k_long), top_device_ms_per_round=top)
    print(f"profile {arch} {policy}{' per-layer' if per_layer else ''} "
          f"captured (full width): {json.dumps(out)}", flush=True)
    return out


def engine_run(arch: str, policy: str, per_layer: bool, engine: str,
               rounds: int):
    """One timed run: ``scan`` (the captured round) and ``loop-shard``
    (the loop engine) sample on the card from a DataShard, ``loop`` draws
    DeviceLoader batches on the host as the training CLI's loop does.
    Steady rounds/s, round 0 (with the warm-up and the capture for
    ``scan``) and the whole run's wall seconds (set-up from the model on),
    peak memory beside them."""
    from repro_torch.core.runner import run_afl
    from repro_torch.data import DeviceLoader
    from repro_torch.experiments import DataShard

    model, cfg, fl, dev, ev = engine_setup(arch, per_layer, rounds)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loader = (DeviceLoader(dev, 32, 0) if engine == "loop"
              else DataShard(dev, 32, 0))
    res = run_afl(model, cfg, fl, policy, loader, ev, rounds=rounds,
                  eval_every=ENGINE_EVERY, engine=engine.split("-")[0],
                  device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rps, eval_s = steady_rate(res)
    return dict(rps=rps, eval_s=eval_s if engine == "scan" else None,
                round0_s=res.round_seconds[0], wall_s=wall_s,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                uploads=res.history["uploads"][-1])


ENGINES = ("loop", "loop-shard", "scan")


def engine_rates(smi: str) -> dict:
    """Phase 14b: steady rounds/s of the engines, read in turns (loop,
    loop-shard, scan, scan, loop-shard, loop), ENGINE_TIMED_ROUNDS rounds;
    the captured engine's replays between CUDA events, its evals apart.
    ``loop-shard`` against ``loop`` is the sampler's share, ``scan``
    against ``loop-shard`` the capture's."""
    out = {}
    for arch, policy, per_layer in ENGINE_CASES:
        name = f"{arch} {policy}{' per-layer' if per_layer else ''}"
        runs = {engine: [] for engine in ENGINES}
        for engine in ENGINES + ENGINES[::-1]:
            runs[engine].append(engine_run(arch, policy, per_layer, engine,
                                           ENGINE_TIMED_ROUNDS))
            torch.cuda.empty_cache()
        out[name] = runs
        print(f"rounds/s by engine ({name}, full width, N={N_DEV}, batch 32, "
              f"{ENGINE_TIMED_ROUNDS} rounds, in turns) on {smi}: "
              f"{json.dumps(runs)}", flush=True)
    return out


def seed_batches(smi: str) -> dict:
    """Phase 14c: ``run_seed_batch`` (S = 3 LaneGCN, S = 2 ResNet-9, the
    seed axis folded into the rows) against an independent
    ``run_afl_scanned`` of each seed on the same DataShard: 8 rounds under
    cuDNN's deterministic algorithms, uploads equal and histories within
    the cross-engine tolerance (bit-equal states printed); then 20 rounds
    in default mode timed as the batch against the S single runs."""
    from repro_torch.experiments import (DataShard, run_afl_scanned,
                                         run_seed_batch)

    out = {}
    for arch, seeds in ((LANEGCN, 3), (RESNET9, 2)):
        model, cfg, fl, dev, ev = engine_setup(arch, False, ENGINE_ROUNDS)
        shard = DataShard(dev, 32, 0)
        kw = dict(rounds=ENGINE_ROUNDS, eval_every=ENGINE_EVERY, device="cuda")
        torch.backends.cudnn.deterministic = True
        try:
            batch = run_seed_batch(model, cfg, fl, "mads", shard, ev,
                                   seeds=list(range(seeds)), **kw)
            equal = []
            for sd, res in enumerate(batch):
                ind = run_afl_scanned(model, cfg, fl, "mads", shard, ev,
                                      seed=sd, **kw)
                a, b = res.history, ind.history
                if a["uploads"] != b["uploads"] or not hist_close(a, b):
                    fail(f"{arch} seed batch: seed {sd} differs from its own "
                         f"run: {a} vs {b}")
                equal.append(state_equal(res.state, ind.state))
                del ind
            if len({tuple(r.history["uploads"]) for r in batch}) != seeds:
                fail(f"{arch} seed batch: seeds gave equal uploads")
        finally:
            torch.backends.cudnn.deterministic = False
        del batch
        torch.cuda.empty_cache()
        kw["rounds"] = ENGINE_TIMED_ROUNDS
        torch.cuda.reset_peak_memory_stats()
        batch = run_seed_batch(model, cfg, fl, "mads", shard, ev,
                               seeds=list(range(seeds)), **kw)
        rps, _ = steady_rate(batch[0])
        peak = torch.cuda.max_memory_allocated() / 2**30
        del batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        single = [steady_rate(run_afl_scanned(
            model, cfg, fl, "mads", shard, ev, seed=sd, **kw))[0]
            for sd in range(seeds)]
        out[arch] = dict(seeds=seeds, bit_equal_states=equal,
                         batch_rounds_per_s=rps,
                         batch_seed_rounds_per_s=rps * seeds,
                         batch_peak_gib=peak, single_rounds_per_s=single,
                         single_peak_gib=torch.cuda.max_memory_allocated()
                         / 2**30)
        print(f"seed batch ({arch} mads, S={seeds}, full width, N={N_DEV}) "
              f"matches independent runs; {ENGINE_TIMED_ROUNDS} rounds on "
              f"{smi}: {json.dumps(out[arch])}", flush=True)
        torch.cuda.empty_cache()
    return out


def sweep_on_card(K) -> dict:
    """Phase 14d: the sweep CLI in-process at full-width LaneGCN (policies
    mads and afl-spar, speeds 5 and 20 m/s, 2 seeds, 20 rounds, N = 20,
    batch 32): the table, 8 cells in results.jsonl, a second call that
    skips every cell, and report.md from --report."""
    from repro_torch.launch import sweep

    with tempfile.TemporaryDirectory() as out:
        argv = ["--arch", LANEGCN, "--policies", "mads,afl-spar", "--speeds",
                "5,20", "--seeds", "2", "--rounds", "20", "--eval-every", "10",
                "--devices", str(N_DEV), "--batch-size", "32", "--train-n",
                "2000", "--report", "--device", "cuda", "--out", out]
        K.reset_launches()
        t0 = time.perf_counter()
        table = sweep.main(argv)
        first_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        cells = Path(out, "results.jsonl").read_text().splitlines()
        report = Path(out, "report.md").read_text()
        t0 = time.perf_counter()
        again = sweep.main(argv)
        second_s = time.perf_counter() - t0
        cells_after = Path(out, "results.jsonl").read_text().splitlines()
    # 4 groups of 2 seeds, 20 rounds each: one sparsify_ef launch a round
    # of each group (mads and afl-spar both go through sparsify_ef)
    if len(cells) != 8 or cells_after != cells or again != table:
        fail(f"sweep: {len(cells)} cells, then {len(cells_after)}")
    if launches["sparsify_ef"] != 4 * 20:
        fail(f"sweep: sparsify launches {launches}, not one a group round")
    if "## Per-group results" not in report:
        fail("sweep: report.md lacks its per-group section")
    out = dict(cells=len(cells), first_s=first_s, resumed_s=second_s,
               launches=launches)
    print(f"sweep CLI (LaneGCN full width, mads,afl-spar x v 5,20 x 2 seeds, "
          f"20 rounds):\n{table}\n{json.dumps(out)}", flush=True)
    return out


def captured_launches(whole_run: dict, profiled: dict, name: str) -> dict:
    """A captured case's launches for the kernels line: ``LAUNCHES``'s
    count over phase 14a's ENGINE_ROUNDS rounds beside the kernels the
    profiler saw the card run in phase 18's run of as many rounds, and
    per replay; the two counts must agree."""
    p = profiled[name]
    counted = whole_run["captured"][name]["launches"][p["kernel"]]
    if counted != p["sparsify_kernels_profiled"]:
        fail(f"{name}: LAUNCHES counted {counted} captured launches, the "
             f"profiler saw {p['sparsify_kernels_profiled']}")
    return dict(rounds=ENGINE_ROUNDS, counted=counted,
                profiled=p["sparsify_kernels_profiled"],
                profiled_per_replay=p["sparsify_kernels_profiled_per_replay"])


def engine_phase(K, smi: str) -> dict:
    """Phase 14: the whole-run engine, seed batching, the sweep CLI and the
    comparison example twin on the card."""
    from repro_torch.examples import cifar_mads_vs_baselines

    out = dict(captured=captured_against_eager(K), rates=engine_rates(smi),
               seed_batch=seed_batches(smi), sweep=sweep_on_card(K))
    rows = cifar_mads_vs_baselines.main(["--device", "cuda"])
    if len(rows) != 9 or not all(math.isfinite(r["acc"]) for r in rows):
        fail(f"cifar_mads_vs_baselines: {rows}")
    print(f"cifar_mads_vs_baselines (ResNet-9 width 8, N 8, 40 rounds, 3 "
          f"seeds a policy, seed-batched): {json.dumps(rows)}", flush=True)
    return out


# phase 15: the streaming ingest server (serve/), full width
INGEST_POLICIES = ("mads-topk", "mads-joint", "qsgd", "fixed-kb")
# soak generations: (label, s, codec, uploads, batch, max_k, chunk); each
# set of payloads is ingested in the modes of SOAK_RUNS, in turns
SOAK_POINTS = (
    ("resnet9 topk", S_RESNET9, "topk", 1024, 64, 65_536, 64),
    ("resnet9 joint", S_RESNET9, "joint", 1024, 64, 65_536, 64),
    ("lanegcn topk", S_LANEGCN, "topk", 10_000, 256, 4096, 512),
    ("lanegcn topk32", S_LANEGCN, "topk32", 2048, 256, 4096, 512),
)
SOAK_RUNS = {"lanegcn topk": (("parity", "constant"), ("scatter", "constant"),
                              ("scatter", "constant"), ("parity", "constant"),
                              ("parity", "hinge")),
             "lanegcn topk32": (("parity", "constant"),)}
SOAK_TURNS = (("parity", "constant"), ("scatter", "constant"),
              ("scatter", "constant"), ("parity", "constant"))


@contextmanager
def no_sync_ingests():
    """Every fused ingest built inside the block runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in it raises."""
    import repro_torch.serve.server as S

    made = S.make_fused_ingest

    def make(*args, **kw):
        fn = made(*args, **kw)

        def ingest(*a):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        return ingest

    S.make_fused_ingest = make
    try:
        yield
    finally:
        S.make_fused_ingest = made


def ingest_device_ms(srv, runs: int = 10) -> float:
    """Median device ms of one fused ingest of the server's last packed
    batch (the work does not depend on how full it is), between CUDA
    events; the result is discarded."""
    times = []
    for _ in range(runs + 2):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        srv._ingest(srv.w, srv.packed, srv.tstate)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[2:]))


def ingest_against_afl_round(smi: str, policies=INGEST_POLICIES,
                             mesh=None) -> dict:
    """Phase 15a: full-width ResNet-9, N = 20, batch 32, exponential
    contacts, ROUNDS rounds of each codec policy through ``afl_round`` with
    ``expose_uploads``; every round's 20 uploads encoded to the wire and
    driven through an ``IngestServer`` at batch = N, max_k = s.  The
    server's weights against ``afl_round``'s after every round: whether
    they are bit-equal is printed; beyond rtol 1e-6 fails.  With ``mesh``
    (phase 20b) the same uploads also go through ``IngestServer(mesh=)``,
    whose weights must equal the server's without a mesh bit for bit."""
    import dataclasses

    from repro_torch.compression.wire import encode_upload
    from repro_torch.core import baselines as BL
    from repro_torch.core.afl import afl_init, afl_round
    from repro_torch.core.runner import build_provider, sample_budgets
    from repro_torch.data import DeviceLoader
    from repro_torch.serve import IngestServer

    model, _, fl, dev, _ = engine_setup(RESNET9, False, ROUNDS)
    s = model.num_params()
    out = {}
    for name in policies:
        policy = dataclasses.replace(BL.ALL[name](s, fl), expose_uploads=True)
        provider = build_provider(fl, name, None, ROUNDS, 0, "cuda")
        budgets = torch.as_tensor(sample_budgets(fl, 0)).cuda()
        state = afl_init(model, fl, 0, "cuda")
        loader = DeviceLoader(dev, 32, 0)
        srv = IngestServer(state.w.clone(), num_devices=N_DEV, batch=N_DEV,
                           max_k=s, queue_capacity=N_DEV)
        msrv = None if mesh is None else IngestServer(
            state.w.clone(), num_devices=N_DEV, batch=N_DEV, max_k=s,
            queue_capacity=N_DEV, mesh=mesh)
        bitwise, shipped, worst, encode_s = [], 0.0, 0.0, 0.0
        for r in range(ROUNDS):
            batch = {k: torch.as_tensor(v).cuda()
                     for k, v in loader.sample_all().items()}
            z, t, h2 = provider.round(r)
            state, m = afl_round(
                state, batch, torch.as_tensor(z).cuda(),
                torch.as_tensor(t, dtype=torch.float32).cuda(),
                torch.as_tensor(h2, dtype=torch.float32).cuda(), budgets,
                model=model, fl=fl, policy=policy)
            b, step, okf = torch.stack(
                [m["b"], m["upload_step"], m["uploads"]]).double().cpu().numpy()
            t0 = time.perf_counter()
            for i in range(N_DEV):
                p = encode_upload(m["upload"][i], b=b[i] if b[i] > 0 else 32.0,
                                  step=float(step[i]), device=i, ok=float(okf[i]))
                if not srv.submit(p):
                    fail(f"ingest {name}: upload {i} of round {r} refused")
                if msrv is not None and not msrv.submit(p):
                    fail(f"ingest {name}: the mesh refused upload {i}")
                shipped += p.k * okf[i]
            encode_s += time.perf_counter() - t0
            if srv.step() != N_DEV:
                fail(f"ingest {name}: round {r} did not ingest {N_DEV} uploads")
            if msrv is not None and (msrv.step() != N_DEV
                                     or not torch.equal(msrv.w, srv.w)):
                fail(f"ingest {name}: round {r} through the mesh differs "
                     f"from the server without one")
            bitwise.append(bool(torch.equal(srv.w, state.w)))
            diff = (srv.w - state.w).abs().max().item()
            worst = max(worst, diff / state.w.abs().max().item())
            if diff > 1e-6 * state.w.abs().max().item():
                fail(f"ingest {name}: round {r} server weights {diff} from "
                     f"afl_round's")
        if shipped <= 0:
            fail(f"ingest {name}: no coordinate shipped in {ROUNDS} rounds")
        res = dict(policy=name, rounds=ROUNDS, bitwise_each_round=bitwise,
                   mesh_world=None if mesh is None else mesh.world_size,
                   max_rel_diff=worst, coords_shipped=shipped,
                   device_ms_per_ingest=ingest_device_ms(srv),
                   encode_ms_per_upload=1e3 * encode_s / (ROUNDS * N_DEV))
        print(f"ingest against afl_round (full-width ResNet-9, N={N_DEV}, "
              f"batch = N, max_k = s{'' if mesh is None else ', and through '
              'a single-rank mesh: equal to the server without one'}) "
              f"{name}: bit-equal every round: "
              f"{all(bitwise)}; {json.dumps(res)} on {smi}", flush=True)
        out[name] = res
        del srv, msrv, state, m
        torch.cuda.empty_cache()
    return out


# main-path calls of phases 15-16, held against the plain versions: one
# entry per (kernel, tag, shape), read into the kernels line
HELD = []


def _call_shape(name: str, args) -> tuple:
    """A kernel call's shape: ``decode_attn``'s (B, H, KV, S, D), the
    first argument's for the others."""
    if name == "decode_attn":
        (b, h, d), (_, s, kv, _) = args[0].shape, args[1].shape
        return (b, h, kv, s, d)
    return tuple(args[0].shape)


@contextmanager
def recording_calls():
    """Record (cloned) the first CUDA call at each shape that the code in
    the block makes through ``kernels/ops.py`` to ``sparsify_ef``,
    ``sparsify_quantize_ef``, ``ssd_scan`` or ``decode_attn``; yields the
    record, which ``hold_recorded`` holds against the plain versions once
    the launch counts are read.  Not around a captured run (a clone inside
    a CUDA graph capture would be captured too)."""
    from repro_torch.kernels import ops

    names = ("sparsify_ef", "sparsify_quantize_ef", "ssd_scan", "decode_attn")
    real = {n: getattr(ops, n) for n in names}
    calls = {}

    def spy(name):
        def call(*args, **kw):
            key = (name, _call_shape(name, args))
            if args[0].is_cuda and key not in calls:
                calls[key] = ([a.clone() if isinstance(a, torch.Tensor) else a
                               for a in args], kw)
            return real[name](*args, **kw)

        return call

    for n in names:
        setattr(ops, n, spy(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(ops, n, real[n])


def hold_recorded(tag: str, calls: dict) -> None:
    """Each recorded call through the CUDA kernel and its plain version on
    the same inputs, with phase 3's tolerances: the sparsify pair's
    uploads and counts bit-equal and errors within 1e-6; ``ssd_scan``
    within 2e-4 (1 + |want|) of the plain version in f64; ``decode_attn``
    within 2e-5 (f32) or 3e-2 (bf16) (1 + |want|) at the call's own
    length.  These launches come after the main path's counts were read."""
    from repro_torch.kernels import decode_attn as DA
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import sparsify_ef as K
    from repro_torch.kernels import ssd_scan as SSD

    for (name, shape), (args, kw) in calls.items():
        if name == "decode_attn":
            got = DA.decode_attn_cuda(*args)
            want = R.decode_attn_plain(*args)
            tol = 2e-5 if args[0].dtype == torch.float32 else 3e-2
            err, excess = _max_excess(got, want, tol)
            if excess > 0:
                fail(f"{tag}: decode_attn at {shape} length {args[3]} differs "
                     f"by {err} from its plain version")
        elif name == "ssd_scan":
            x, a, b, c = (t.float() for t in args[:4])
            got = SSD.ssd_scan_cuda(x, a, b, c, args[4])
            want = R.ssd_scan_plain(*(t.double() for t in (x, a, b, c)),
                                    args[4])
            err = 0.0
            for g, w in zip(got, want):
                e, excess = _max_excess(g, w, 2e-4)
                if excess > 0:
                    fail(f"{tag}: ssd_scan at {shape} differs by {e} from "
                         f"its plain version")
                err = max(err, e)
        else:
            if name == "sparsify_ef":
                got = K.sparsify_ef_cuda(*args)
                want = R.sparsify_ef_plain(*args)
            else:
                got = K.sparsify_quantize_ef_cuda(*args, kw.get("base", 0))
                want = R.sparsify_quantize_ef_plain(*args, kw.get("base", 0))
            err = (got[1].float() - want[1].float()).abs().max().item()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
                    and err <= 1e-6):
                fail(f"{tag}: {name} at {shape} differs from its plain "
                     f"version (error off by {err})")
        held = dict(name=name, tag=tag, shape=list(shape),
                    dtype=str(args[0].dtype).replace("torch.", ""),
                    max_abs_err=err)
        if name == "decode_attn":
            held["length"] = int(args[3])
        HELD.append(held)
        print(f"{tag}: {name} matches its plain version on the main path's "
              f"inputs at {shape} {args[0].dtype}"
              + (f" length {args[3]}" if name == "decode_attn" else "")
              + f": max abs err {err}", flush=True)
        del got, want
    calls.clear()
    torch.cuda.empty_cache()


def soak_on_card(K, smi: str) -> dict:
    """Phase 15b: ``launch/soak.py``'s points on the card, each set of
    payloads made once (one sparsify launch per chunk, counted; each chunk
    shape's kernel call held against its plain version) and ingested by
    ``ingest_soak`` in turns: fused and loop uploads/s, host ms per pack,
    device ms per ingest, the device-busy share of a step, peak memory;
    the snapshot's counters must add up."""
    from repro_torch.launch import soak
    from repro_torch.telemetry.tracing import PhaseTracer

    out = {}
    for label, s, codec, uploads, batch, max_k, chunk in SOAK_POINTS:
        K.reset_launches()
        t0 = time.perf_counter()
        with recording_calls() as calls:
            payloads = soak.make_payloads(uploads, s, max_k, codec=codec,
                                          chunk=chunk, device="cuda")
        gen_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        chunks = -(-uploads // chunk)
        if sum(launches.values()) != chunks:
            fail(f"soak {label}: {launches} sparsify launches for {chunks} "
                 f"chunks")
        hold_recorded(f"soak {label}", calls)
        runs = []
        for mode, staleness in SOAK_RUNS.get(label, SOAK_TURNS):
            tracer = PhaseTracer()
            torch.cuda.reset_peak_memory_stats()
            res = soak.ingest_soak(payloads, s=s, max_k=max_k, batch=batch,
                                   staleness_family=staleness, mode=mode,
                                   tracer=tracer, device="cuda")
            srv = res.pop("server")
            c = res.pop("snapshot")["counters"]
            if not (c["accepted"] == c["ingested"] == uploads and c["received"]
                    == c["accepted"] + c["rejected"] + c["deferred"]):
                fail(f"soak {label} {mode}: counters do not add up: {c}")
            packs = [sp.duration for sp in tracer.spans
                     if sp.name == "serve.pack" and sp.parent == "soak.fused"]
            steps = srv.rnd
            dev_ms = ingest_device_ms(srv)
            step_ms = 1e3 * res["fused_wall_s"] / steps
            runs.append(dict(
                mode=mode, staleness=staleness,
                fused_per_s=res["fused_per_s"], loop_per_s=res["loop_per_s"],
                speedup_vs_loop=res["speedup_vs_loop"], steps=steps,
                host_ms_per_pack=1e3 * sum(packs) / len(packs),
                device_ms_per_ingest=dev_ms, ms_per_step=step_ms,
                device_busy_share=dev_ms / step_ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                deferred=c["deferred"]))
            del srv
        point = dict(s=s, codec=codec, uploads=uploads, batch=batch,
                     max_k=max_k, chunk=chunk, generate_s=gen_s,
                     launches=launches, runs=runs)
        print(f"soak {label} (s={s}, {uploads} uploads, batch {batch}, max_k "
              f"{max_k}) on {smi}: " + "; ".join(
                  f"{r['mode']}/{r['staleness']} {r['fused_per_s']:.0f} "
                  f"uploads/s (loop {r['loop_per_s']:.0f}, "
                  f"{r['speedup_vs_loop']:.1f}x)" for r in runs)
              + f"; unrounded {json.dumps(point)}", flush=True)
        out[label] = point
        del payloads
        torch.cuda.empty_cache()
    return out


def ingest_phase(K, smi: str) -> dict:
    """Phase 15: the ingest server at full width, every ingest under the
    sync debug mode "error"."""
    t0 = time.perf_counter()
    with no_sync_ingests():
        out = dict(parity=ingest_against_afl_round(smi),
                   soak=soak_on_card(K, smi))
    print(f"ingest phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# phase 16: federated LM fine-tuning, reduced (the token generator's V x V
# table and N devices' (N, s) state do not fit at full width)
LM_ARCHS = ("internlm2-1.8b", "mamba2-2.7b")
LM_ROUNDS, LM_EVERY = 8, 2
F32 = dict(dtype="float32", param_dtype="float32")


def lm_run(K, SSD, arch: str, engine: str, record: bool) -> dict:
    """The training CLI with ``--reduced``: N = 20, batch 32, 8 rounds, seq
    64 (a multiple of Mamba2's reduced chunk, 32), train-n 4000 (1000
    sequences, 50 a device), the CLI's lr.  One sparsify_ef launch a
    round; for Mamba2 one ssd_scan launch a layer at each eval (the eval
    forward runs without gradients), none for the dense model; uploads >
    0; a finite loss; w moved off its initial value.  With ``record`` (a
    loop-engine run) the run's first call of each kernel is held against
    its plain version once the counts are read."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core.afl import afl_init
    from repro_torch.models.registry import build_model

    K.reset_launches()
    SSD.reset_launches()
    with recording_calls() if record else nullcontext({}) as calls:
        res = train(["--arch", arch, "--reduced", "--policy", "mads",
                     "--devices", str(N_DEV), "--rounds", str(LM_ROUNDS),
                     "--batch-size", "32", "--train-n", "4000",
                     "--seq-len", "64", "--eval-every", str(LM_EVERY),
                     "--intercontact", "20", "--engine", engine,
                     "--device", "cuda", "--seed", "0"])
    launches = dict(K.LAUNCHES, ssd_scan=SSD.LAUNCHES["ssd_scan"])
    hist = res.history
    name = f"{arch} reduced {engine}"
    cfg = get_config(arch).reduced()
    want_ssd = cfg.num_layers * len(hist["eval"]) if cfg.family == "ssm" else 0
    if (launches["sparsify_ef"] != LM_ROUNDS or launches["ssd_scan"] != want_ssd
            or sum(launches.values()) != LM_ROUNDS + want_ssd):
        fail(f"{name}: not one sparsify_ef launch a round and {want_ssd} "
             f"ssd_scan launches: {launches}")
    hold_recorded(f"lm {name}", calls)
    if not hist["uploads"][-1] > 0:
        fail(f"{name}: no uploads")
    if not all(math.isfinite(v) for v in hist["eval"]):
        fail(f"{name}: loss not finite: {hist['eval']}")
    w0 = afl_init(build_model(cfg), FLConfig(num_devices=N_DEV), 0, "cuda").w
    moved = (res.state.w != w0).float().mean().item()
    if not moved > 0:
        fail(f"{name}: w never moved off its initial value")
    rps = steady_rate(res)[0]
    out = dict(launches=launches, rps=rps, eval=hist["eval"],
               share_of_w_moved=moved, uploads=hist["uploads"][-1],
               k_mean=hist["k_mean"][-1], round0_s=res.round_seconds[0])
    print(f"lm {name}: {json.dumps(out)}", flush=True)
    return out


def _on(state, device, dtype=None):
    """``state`` with its tensors on ``device``; with ``dtype``, the model
    and device vectors (w, w_n, g_n, e_n) cast to it."""
    import dataclasses

    moved = {}
    for f in ("w", "w_n", "g_n", "e_n", "kappa", "q", "energy", "rnd"):
        v = getattr(state, f)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
            if dtype is not None and f in ("w", "w_n", "g_n", "e_n"):
                v = v.to(dtype)
        moved[f] = v
    return dataclasses.replace(state, **moved)


def lm_against_cpu() -> None:
    """Phase 16b: each round of a reduced float32 run (N = 4, batch 4, seq
    64, exponential contacts, the CPU run's trajectory) on the card from
    the CPU's state, against the same round on the CPU in f32 and in f64.
    Held: the same successes; k within 2; the update of w and each
    device's x = e_n + g_n + upload after the round (the sparsifier's
    input, whichever side of the threshold a coordinate fell) no further
    from the f64 round's, relative to its largest entry, than three times
    the CPU's f32 round is (the reduced InternLM2's f32 gradient is only
    good to ~1e-3 of that entry, on either device, and the card's sums in
    another order: up to 1.9x the CPU's distance seen); the eval loss of
    the CPU's weights on the card within 1e-4 of the CPU's (Mamba2's
    through the CUDA ssd_scan).  Whole runs are not compared: local steps on
    InternLM2's small-init embedding amplify that 1e-3 until, by round 3,
    the card's and the CPU's w are apart by a whole update."""
    import dataclasses

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import baselines as BL
    from repro_torch.core.afl import afl_init, afl_round
    from repro_torch.core.runner import build_provider, evaluate, sample_budgets
    from repro_torch.data import DeviceLoader
    from repro_torch.launch.train import build_device_data
    from repro_torch.models.registry import build_model

    for arch in LM_ARCHS:
        cfg = get_config(arch).reduced().replace(**F32)
        model = build_model(cfg)
        model64 = build_model(cfg.replace(dtype=torch.float64,
                                          param_dtype=torch.float64))
        fl = FLConfig(num_devices=4, rounds=4, batch_size=4,
                      mean_intercontact=20.0, seed=0)
        dev, ev = build_device_data(cfg, fl, train_n=200, eval_n=64,
                                    seq_len=64, seed=0)
        policy = dataclasses.replace(BL.ALL["mads"](model.num_params(), fl),
                                     expose_uploads=True)
        provider = build_provider(fl, "mads", None, fl.rounds, 0, "cpu")
        budgets = torch.as_tensor(sample_budgets(fl, 0))
        loader = DeviceLoader(dev, 4, 0)
        evs = {d: {k: torch.as_tensor(v).to(d) for k, v in ev.items()}
               for d in ("cpu", "cuda")}
        state = afl_init(model, fl, 0, "cpu")
        dists, eval_gap, uploads = [], 0.0, 0.0
        for r in range(fl.rounds):
            batch = {k: torch.as_tensor(v) for k, v in loader.sample_all().items()}
            z, t, h2 = provider.round(r)
            ins = (torch.as_tensor(z), torch.as_tensor(t, dtype=torch.float32),
                   torch.as_tensor(h2, dtype=torch.float32), budgets)
            out = {}
            for label, mdl, d, dt in (("cuda", model, "cuda", None),
                                      ("cpu", model, "cpu", None),
                                      ("f64", model64, "cpu", torch.float64)):
                new, m = afl_round(
                    _on(state, d, dt), {k: v.to(d) for k, v in batch.items()},
                    *(v.to(d) for v in ins), model=mdl, fl=fl, policy=policy)
                out[label] = dict(
                    new=new, success=m["success"].cpu(), k=m["k"].cpu(),
                    update=new.w.double().cpu() - state.w.double(),
                    x=(new.e_n + new.g_n + m["upload"]).double().cpu())
            a, c, e = out["cuda"], out["cpu"], out["f64"]
            if not (torch.equal(a["success"], c["success"])
                    and torch.equal(c["success"], e["success"])):
                fail(f"lm {arch} f32 round {r}: successes differ: "
                     f"{[o['success'].tolist() for o in (a, c, e)]}")
            if (a["k"] - c["k"]).abs().max().item() > 2:
                fail(f"lm {arch} f32 round {r}: k {a['k'].tolist()} on the "
                     f"card, {c['k'].tolist()} on the cpu")
            for q in ("update", "x"):
                peak = max(e[q].abs().max().item(), 1e-30)
                d_card = (a[q] - e[q]).abs().max().item() / peak
                d_cpu = (c[q] - e[q]).abs().max().item() / peak
                if d_card > 3 * d_cpu + 1e-6:
                    fail(f"lm {arch} f32 round {r}: the card's {q} is "
                         f"{d_card} of its largest entry from the f64 "
                         f"round's, the cpu's {d_cpu}")
                dists.append([r, q, d_card, d_cpu])
            state = c["new"]
            uploads += c["success"].sum().item()
            gap = abs(evaluate(model, cfg, state.w.cuda(), evs["cuda"])
                      - evaluate(model, cfg, state.w, evs["cpu"]))
            if gap > 1e-4:
                fail(f"lm {arch} f32 round {r}: eval of the cpu's weights "
                     f"{gap} apart on the card and on the cpu")
            eval_gap = max(eval_gap, gap)
        if not uploads > 0:
            fail(f"lm {arch} f32: no uploads in {fl.rounds} rounds")
        print(f"lm {arch} reduced f32, each round on the card against the "
              f"cpu from its state: successes equal, k within 2 ({uploads:.0f} "
              f"uploads); [round, quantity, card's, cpu's distance from the "
              f"f64 round / its largest entry] {json.dumps(dists)}; eval of "
              f"the cpu's weights within {eval_gap}",
              flush=True)


def ssd_scan_refuses_gradients(SSD) -> None:
    """Phase 16c: the CUDA ``ssd_scan`` has no backward; with inputs that
    require a gradient it raises, called directly and from a Mamba2
    forward under ``torch.func.grad``, and launches nothing."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = _randn((1, 64, 2, 64), gen).requires_grad_()
    a = -_randn((1, 64, 2), gen).abs()
    b, c = _randn((1, 64, 16), gen), _randn((1, 64, 16), gen)
    cfg = get_config("mamba2-2.7b").reduced().replace(**F32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    tokens = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    SSD.reset_launches()
    for label, call in (
            ("direct", lambda: ops.ssd_scan(x, a, b, c, 32)),
            ("forward under grad", lambda: torch.func.grad(
                lambda p: model.forward(p, cfg, tokens)[0].sum())(params))):
        try:
            call()
        except NotImplementedError as e:
            print(f"ssd_scan with gradients ({label}) refused: {e}", flush=True)
        else:
            fail(f"ssd_scan with gradients ({label}) was not refused")
    if SSD.LAUNCHES["ssd_scan"]:
        fail(f"a refused ssd_scan launched: {SSD.LAUNCHES}")


def lm_phase(K, SSD, smi: str) -> dict:
    """Phase 16: federated LM fine-tuning on the card."""
    from repro_torch.examples import federated_llm_finetune

    t0 = time.perf_counter()
    out = {}
    for arch in LM_ARCHS:
        for i, engine in enumerate(("loop", "scan", "scan", "loop")):
            out.setdefault(f"{arch} {engine}", []).append(
                lm_run(K, SSD, arch, engine, record=i == 0))
    print(f"lm rounds/s (reduced, N={N_DEV}, batch 32, seq 64, {LM_ROUNDS} "
          f"rounds) on {smi}: "
          + ", ".join(f"{k} {[r['rps'] for r in v]}" for k, v in out.items()),
          flush=True)
    lm_against_cpu()
    ssd_scan_refuses_gradients(SSD)
    res = federated_llm_finetune.main(["--device", "cuda"])
    if not (res.history["uploads"][-1] > 0 and math.isfinite(res.final_eval)):
        fail(f"federated_llm_finetune: {res.history}")
    print(f"lm phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return {k: v[0]["launches"] for k, v in out.items()}


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
    host-bound decodes of phases 7-8 and 17."""
    for label, fn in llm_kernel_calls(DA, SSD).items():
        print(f"{label} device time by kernel: {json.dumps(device_times(fn))}",
              flush=True)


def profile_rounds(arch: str, policy: str = "mads", rounds: int = 6) -> dict:
    """Phase 18 for training: a full-width run of ``rounds`` rounds (one
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
    by_kernel, launches = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            by_kernel[e.key[:60]] = us / rounds / 1e3
            launches[e.key[:60]] = e.count / rounds
    busy_ms = sum(by_kernel.values())
    steady = res.round_seconds[1:]
    wall_ms = 1e3 * sum(steady) / len(steady)
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    out = dict(arch=arch, policy=policy, rounds=rounds,
               device_busy_ms_per_round=busy_ms, wall_ms_per_round=wall_ms,
               busy_share=busy_ms / wall_ms, kernels=len(by_kernel),
               top_device_ms_per_round=top,
               top_launches_per_round={k: launches[k] for k in top})
    print(f"profile {arch} {policy} (profiled, full width): {json.dumps(out)}",
          flush=True)
    return out


PROFILED_DECODES = ("qwen3-moe-30b-a3b", "qwen2-vl-72b")  # phase 18


def profile_decode(arch: str, batch: int, prompt: int, layers: int,
                   wall_ms: float, steps: int = 4) -> dict:
    """Phase 18 for serving: one full-width model (phase 17's batch,
    prompt and depth), its prefill, one warm decode step, then ``steps``
    decode steps under ``torch.profiler``: the device-busy ms a step (every
    kernel, divided by the steps) against ``wall_ms``, phase 17's
    unprofiled decode seconds a step, and the kernels that take the most.
    A busy share well under 1 means the host paces the decode."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).cuda()
    last, cache = model.prefill(params, cfg, prompts,
                                max_seq=prompt + steps + 1)
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    del last
    logits, cache = model.decode_step(params, cfg, cache, tok, prompt)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            logits, cache = model.decode_step(params, cfg, cache, tok,
                                              prompt + 1 + i)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
    by_kernel, launches = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            by_kernel[e.key[:60]] = us / steps / 1e3
            launches[e.key[:60]] = e.count / steps
    busy = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])
    out = dict(arch=arch, layers=cfg.num_layers, batch=batch,
               device_busy_ms_per_step=busy, wall_ms_per_step=wall_ms,
               busy_share=busy / wall_ms,
               kernel_launches_per_step=sum(launches.values()),
               top_device_ms_per_step=top)
    print(f"profile decode {arch} (full width, {cfg.num_layers} layers, "
          f"batch {batch}): {json.dumps(out)}", flush=True)
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def profile_schedules(engine: dict) -> None:
    """Phase 18 for the device-resident scenario engine: device-busy ms of
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


def serve_full(mods, arch: str, batch: int, prompt: int, layers: int = 0):
    """Phases 7-8 and 17: the full-width serve path, through the CLI, or
    cut to ``layers`` layers when given, through ``serve`` on the CLI's
    draws; counts read around it; returns (cfg, launches, the run's
    numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models.registry import build_model

    for mod in mods.values():
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    if layers:
        cfg = get_config(arch).replace(num_layers=layers)
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            torch.device("cuda"))
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).cuda()
        toks, stats = S.serve(cfg, model, params, prompts, GEN)
        del model, params, prompts
    else:
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
    run = dict(prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
               tok_per_s=stats["tok_per_s"], peak_gib=peak)
    depth = f"{cfg.num_layers} layers" + (" (cut)" if layers else "")
    print(f"serve {arch} (full width, {depth}, batch {batch}, prompt {prompt}, "
          f"gen {GEN}): prefill_s {stats['prefill_s']}, decode_s "
          f"{stats['decode_s']}, tok/s {stats['tok_per_s']}, peak "
          f"{peak:.2f} GiB, launches {launches}", flush=True)
    del toks, stats
    torch.cuda.empty_cache()
    return cfg, launches, run


def serve_other_families(mods, smi: str) -> dict:
    """Phase 17: the MoE, hybrid, audio and VLM families served at full
    width (``OTHER_SERVES``), one model at a time; ``decode_attn``
    launched once a layer a token (Zamba2: never; its shared block's
    decode is the plain ``window_pos`` path, as the reference's) and
    ``ssd_scan`` once a Mamba2 layer of Zamba2's prefill; each model's
    first kernel call at each shape held against its plain version once
    its counts are read and its weights freed.  Returns {arch: (launches,
    the run's numbers)}."""
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2**30
    out = {}
    for arch, batch, prompt, layers in OTHER_SERVES:
        with recording_calls() as calls:
            cfg, launches, run = serve_full(mods, arch, batch, prompt, layers)
        if cfg.family == "hybrid":
            want = {"decode_attn": 0, "ssd_scan": cfg.num_layers}
        else:
            want = {"decode_attn": cfg.num_layers * GEN, "ssd_scan": 0}
        got = {k: launches[k] for k in want}
        if got != want:
            fail(f"{arch} serve launched {got}, not {want}")
        hold_recorded(f"serve {arch}", calls)
        left = torch.cuda.memory_allocated() / 2**30
        if left > base + 1:  # the next model needs the card to itself
            fail(f"{arch}: {left - base:.2f} GiB still allocated after its serve")
        out[arch] = (launches, dict(run, layers=cfg.num_layers, batch=batch,
                                    prompt=prompt))
    print(f"serve, other families (full width, gen {GEN}) on {smi}: "
          f"{json.dumps({a: r for a, (_, r) in out.items()})}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def serve_against_cpu():
    """Phase 9: reduced float32 serves on the card and on the CPU agree."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model

    for arch in ("llama3.2-3b", "mamba2-2.7b", "qwen3-moe-30b-a3b",
                 "zamba2-7b", "whisper-large-v3", "qwen2-vl-72b"):
        cfg = get_config(arch).reduced().replace(dtype="float32",
                                                 param_dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))
        frames = None
        if cfg.family == "audio":
            frames = torch.from_numpy(rng.normal(
                0, 0.02, (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        out = {}
        for dev in ("cuda", "cpu"):
            p = model.layout.unflatten(model.layout.flatten(params).to(dev))
            out[dev] = serve(cfg, model, p, prompts.to(dev), gen=8,
                             frames=None if frames is None else frames.to(dev))
        (tg, sg), (tc, sc) = out["cuda"], out["cpu"]
        e = (sg["prefill_logits"].cpu() - sc["prefill_logits"]).abs().max().item()
        if not torch.equal(tg.cpu(), tc) or e > 1e-3:
            fail(f"{arch}: card and CPU serves differ: tokens {tg.tolist()} vs "
                 f"{tc.tolist()}, prefill logits by {e}")
        print(f"serve {arch} (reduced, f32) on the card matches the CPU: "
              f"tokens {tc[0].tolist()}, prefill logits within {e:.3g}",
              flush=True)


# ---------------------------------------------------------------------------
# Phase 19: the distributed AFL round at full-width InternLM2-1.8B
# ---------------------------------------------------------------------------

DIST_ARCH = "internlm2-1.8b"
DIST_N, DIST_BATCH, DIST_SEQ, DIST_ROUNDS = 2, 4, 512, 4
DIST_FORCED = 1  # the (0-based) round in which both clients meet the MES
DIST_RUNS = (("mads", "sparsify_ef"), ("mads-joint", "sparsify_quantize_ef"))
HOLD_BLOCK = 1 << 26  # columns of a row held against the plain version at once


def dist_provider(fl, policy_name: str, rounds: int):
    """The exponential contacts, with every client in contact in round
    ``DIST_FORCED`` for at least the mean contact time."""
    from repro_torch.core.runner import build_provider
    from repro_torch.scenarios import ScenarioProvider

    zeta, tau, h2 = (np.array(a, copy=True) for a in build_provider(
        fl, policy_name, None, rounds, 0, "cpu").schedule())
    zeta[DIST_FORCED] = 1
    tau[DIST_FORCED] = np.maximum(tau[DIST_FORCED], fl.mean_contact)
    return ScenarioProvider.from_arrays(zeta, tau, h2=h2)


def hold_in_blocks(name: str, x, args, kw, out, tag: str) -> float:
    """A sparsify kernel's output on x (N, s) against its plain version on
    the same inputs, ``HOLD_BLOCK`` columns at a time (the plain version is
    elementwise along a row and the dither counter is base + column, so a
    block's result is the whole call's; the count is the exact int total
    of the plain version's mask, as one unblocked call gives it): uploads
    and counts bit-equal, errors within 1e-6 (phase 3's tolerances).
    Returns the largest error difference."""
    from repro_torch.kernels import ref as R

    up, err, cnt = out
    total = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    worst = 0.0
    for c0 in range(0, x.shape[1], HOLD_BLOCK):
        cols = slice(c0, min(c0 + HOLD_BLOCK, x.shape[1]))
        xb = x[:, cols]
        if name == "sparsify_ef":
            want = R.sparsify_ef_plain(xb, args[0])
        else:
            t, steps, levels, seeds = args[:4]
            base = kw.get("base", args[4] if len(args) > 4 else 0)
            want = R.sparsify_quantize_ef_plain(xb, t, steps, levels, seeds,
                                                base + c0)
        if not torch.equal(up[:, cols], want[0]):
            fail(f"{tag}: {name} upload differs from its plain version in "
                 f"columns {cols}")
        worst = max(worst, (err[:, cols].float() - want[1].float())
                    .abs().max().item())
        total += (xb.float().abs() >= args[0][:, None]).sum(dim=1)
        del want
    if not torch.equal(cnt, total.to(torch.float32)) or worst > 1e-6:
        fail(f"{tag}: {name} counts {cnt.tolist()} (plain {total.tolist()}) "
             f"or errors (off by {worst}) differ from its plain version")
    return worst


@contextmanager
def holding_in_run(tag: str, stats: dict):
    """Hold every CUDA call the block makes through ``kernels/ops.py`` to
    ``sparsify_ef`` / ``sparsify_quantize_ef`` against its plain version as
    it returns, on the run's own inputs and outputs (``hold_in_blocks``;
    no kernel is launched for it).  Its host seconds go to
    ``stats["hold_s"]``; ``stats["peak"]`` keeps the run's peak memory
    without the holding's temporaries (the peak counter is read before and
    reset after each hold)."""
    from repro_torch.kernels import ops

    names = ("sparsify_ef", "sparsify_quantize_ef")
    real = {n: getattr(ops, n) for n in names}

    def spy(name):
        def call(x, *args, **kw):
            out = real[name](x, *args, **kw)
            if not x.is_cuda:
                return out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats["peak"] = max(stats["peak"], torch.cuda.max_memory_allocated())
            err = hold_in_blocks(name, x, args, kw, out, tag)
            HELD.append(dict(name=name, tag=tag, shape=list(x.shape),
                             dtype=str(x.dtype).replace("torch.", ""),
                             max_abs_err=err))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats["hold_s"] += time.perf_counter() - t0
            stats["held"] += 1
            return out

        return call

    for n in names:
        setattr(ops, n, spy(n))
    try:
        yield
    finally:
        for n in names:
            setattr(ops, n, real[n])


def dist_full_width(K, mesh, policy_name: str, kernel: str, smi: str) -> dict:
    """Phase 19a: ``make_afl_train_system`` on the single-rank NCCL mesh at
    full-width InternLM2-1.8B (bf16 weights and client states), N = 2,
    global batch 4 (2 a client), seq 512, 4 rounds through
    ``run_afl_rounds`` with ``donate=True``; both clients in contact in
    round 2.  Held: exactly one ``kernel`` launch a round and no other,
    each held against its plain version as it returns; uploads > 0; a
    finite loss before and after; w moved; peak under 75 GiB.  Steady
    round seconds leave the holding out."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import baselines as BL
    from repro_torch.core import mads as M
    from repro_torch.core.afl import device_grads
    from repro_torch.core.distributed import (DistConfig,
                                              make_afl_train_system,
                                              run_afl_rounds)
    from repro_torch.core.runner import evaluate, sample_budgets
    from repro_torch.models.registry import build_model, demo_batch

    cfg = get_config(DIST_ARCH)
    model = build_model(cfg)
    s = model.num_params()
    fl = FLConfig(num_devices=DIST_N, rounds=DIST_ROUNDS,
                  mean_intercontact=20.0, sparsifier="sampled", seed=0)
    policy = BL.ALL[policy_name](s, fl)
    dcfg = DistConfig(num_clients=DIST_N, learning_rate=fl.learning_rate,
                      rounds=DIST_ROUNDS, sample_size=fl.sample_size)
    rng = np.random.default_rng(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in
                demo_batch(cfg, DIST_BATCH, DIST_SEQ, rng).items()}
               for _ in range(DIST_ROUNDS + 1)]
    stats = dict(peak=0, hold_s=0.0, held=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system = make_afl_train_system(
        model, cfg, mesh, dcfg=dcfg, controller=policy.controller,
        compressor=policy.compressor, staleness=policy.staleness, donate=True)
    state = system["init_state"](0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if state.w_n.dtype != torch.bfloat16 or tuple(state.w_n.shape) != (DIST_N, s):
        fail(f"dist {policy_name}: client state {state.w_n.dtype} "
             f"{tuple(state.w_n.shape)}")
    if policy_name == "mads":  # the vmapped gradient's own peak, once
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = device_grads(model, state.w_n, {
            k: v.reshape(DIST_N, -1, *v.shape[1:]) for k, v in batches[0].items()})
        stats["grad_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        stats["grad_peak_over_state_gib"] = (
            torch.cuda.max_memory_allocated() - before) / 2**30
        del grads
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    probe = torch.arange(0, s, 997, device="cuda")
    w0 = state.w[probe].clone()
    loss0 = evaluate(model, cfg, state.w, batches[-1])
    marks = []

    def batch_fn(r):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), stats["hold_s"]))
        return batches[r]

    provider = dist_provider(fl, policy_name, DIST_ROUNDS)
    K.reset_launches()
    with holding_in_run(f"dist {policy_name}", stats):
        state, hist = run_afl_rounds(system["step"], state, provider,
                                     batch_fn, sample_budgets(fl, 0))
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), stats["hold_s"]))
    launches = dict(K.LAUNCHES)
    stats["peak"] = max(stats["peak"], torch.cuda.max_memory_allocated())
    want = {k: (DIST_ROUNDS if k == kernel else 0) for k in launches}
    if launches != want:
        fail(f"dist {policy_name}: launches {launches}, not {want}")
    if stats["held"] != DIST_ROUNDS:
        fail(f"dist {policy_name}: {stats['held']} kernel calls held, not "
             f"{DIST_ROUNDS}")
    round_s = [(t1 - t0) - (h1 - h0)
               for (t0, h0), (t1, h1) in zip(marks, marks[1:])]
    uploads = sum(float(m["success"].sum()) for m in hist)
    ctl = policy.controller
    budget = [(torch.as_tensor(tau).cuda() * M.rate_bps(
        m["power"], torch.as_tensor(h2).cuda(), ctl.bandwidth, ctl.noise_w_hz)
        * m["uploads"]).tolist() for m, (_, tau, h2) in zip(hist, provider)]
    loss = evaluate(model, cfg, state.w, batches[-1])
    moved = (state.w[probe] != w0).float().mean().item()
    peak = stats["peak"] / 2**30
    out = dict(
        launches=launches, uploads=uploads, loss_before=loss0, loss=loss,
        share_of_w_moved=moved, peak_gib=peak, init_s=init_s,
        round_s=round_s, steady_round_s=sorted(round_s[1:])[len(round_s[1:]) // 2],
        held_s=stats["hold_s"], budget_bits=budget,
        **{k: v for k, v in stats.items() if k.startswith("grad_peak")},
        k=[m["k"].tolist() for m in hist], bits=[m["bits"].tolist() for m in hist],
        b=[m["b"].tolist() for m in hist])
    if not uploads > 0:
        fail(f"dist {policy_name}: no uploads: {out}")
    if not (math.isfinite(loss) and math.isfinite(loss0)):
        fail(f"dist {policy_name}: loss not finite: {out}")
    if not moved > 0:
        fail(f"dist {policy_name}: w never moved: {out}")
    if not peak < 75:
        fail(f"dist {policy_name}: peak {peak:.2f} GiB, not under 75")
    print(f"dist {DIST_ARCH} (full width, s = {s:,}, bf16 states, N = "
          f"{DIST_N}, batch {DIST_BATCH}, seq {DIST_SEQ}) {policy_name} on "
          f"{smi}: {json.dumps(out)}", flush=True)
    del state, hist, system, batches, w0, probe, model
    torch.cuda.empty_cache()
    return out


def dist_kernel_times(K, s: int, card: str) -> dict:
    """Phase 19b: both sparsify kernels timed at the run's shape, (2,
    1,889,110,016) bf16, on random rows (thresholds keeping ~1 % and ~13 %
    of a row); bound: bytes over the HBM rate (x read, upload and error
    written) against phase 3's operation counts at the f32 rate."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.empty((DIST_N, s), dtype=torch.bfloat16, device="cuda")
    for c0 in range(0, s, HOLD_BLOCK):
        c1 = min(c0 + HOLD_BLOCK, s)
        x[:, c0:c1] = torch.randn((DIST_N, c1 - c0), generator=g, device="cuda")
    t = torch.tensor([2.5, 1.5], device="cuda")
    steps = torch.tensor([0.01, 0.02], device="cuda")
    levels = torch.tensor([7.0, 2047.0], device="cuda")
    seeds = torch.tensor([11, 7930], dtype=torch.int32, device="cuda")
    n_el = x.numel()
    calls = {
        "sparsify_ef": (lambda: K.sparsify_ef_cuda(x, t), 4 * n_el),
        "sparsify_quantize_ef": (lambda: K.sparsify_quantize_ef_cuda(
            x, t, steps, levels, seeds, 0), 22 * n_el),
    }
    out = {}
    for name, (fn, ops) in calls.items():
        ms = median_ms(fn, runs=9, batch=3)
        b = bound(3 * 2 * n_el + 5 * 4 * DIST_N, ops, torch.float32)
        out[name] = dict(ms=ms, shape=[DIST_N, s], dtype="bfloat16", **b,
                         bound_share=b["bound_ms"] / ms)
        print(f"{name}: {ms:.4f} ms at ({DIST_N}, {s}) bf16 (bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']}) on {card}",
              flush=True)
    del x
    torch.cuda.empty_cache()
    return out


def _dist_on(state, device, dtype=None):
    """A distributed state with its tensors on ``device``; with ``dtype``,
    w and the client buffers cast to it."""
    import dataclasses

    moved = {}
    for f in ("w", "w_n", "g_n", "e_n", "kappa", "q", "energy"):
        v = getattr(state, f).to(device)
        if dtype is not None and f in ("w", "w_n", "g_n", "e_n"):
            v = v.to(dtype)
        moved[f] = v
    return dataclasses.replace(state, **moved)


def dist_reduced(mesh) -> None:
    """Phase 19c: reduced InternLM2 in float32 (N = 4, batch 16, seq 64, 3
    rounds, every client's contact forced in round 2, a threshold sample
    of every coordinate), the ``mads`` step
    on the card against the CPU from the CPU's state each round (successes
    equal, k within 2, the update of w and of w_n no further from the f64
    step's, relative to its largest entry, than 3x the CPU's f32 step:
    phase 16's standard); and the same rounds on the card through the
    single-rank NCCL mesh against the step without a group, for ``mads``
    and ``mads-joint``: metrics and states bit-equal."""
    import dataclasses

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import baselines as BL
    from repro_torch.core import distributed as D
    from repro_torch.core.runner import sample_budgets
    from repro_torch.models.registry import build_model, demo_batch

    cfg = get_config(DIST_ARCH).reduced().replace(**F32)
    cfg64 = cfg.replace(dtype=torch.float64, param_dtype=torch.float64)
    model, model64 = build_model(cfg), build_model(cfg64)
    rounds, n = 3, 4
    fl = FLConfig(num_devices=n, rounds=rounds, mean_intercontact=20.0,
                  sparsifier="sampled", seed=0)
    provider = dist_provider(fl, "mads", rounds)
    budgets = torch.as_tensor(sample_budgets(fl, 0))
    rng = np.random.default_rng(1)
    batches = [{k: torch.as_tensor(v) for k, v in
                demo_batch(cfg, 4 * n, 64, rng).items()} for _ in range(rounds)]
    # a sample of 2^21 >= s takes every coordinate, so the fixed-u
    # threshold is the exact order statistic and k is held within 2, as
    # phase 16 holds it; at the default 65,536 a swap of two samples of
    # near-equal |x| moves k by ~s/m = 26 coordinates a swap
    dc = D.DistConfig(num_clients=n, learning_rate=fl.learning_rate,
                      rounds=rounds, state_dtype="float32",
                      sample_size=1 << 21)
    dc64 = dataclasses.replace(dc, state_dtype=torch.float64,
                               upload_dtype=torch.float64,
                               accum_dtype=torch.float64)
    pol = BL.ALL["mads"](model.num_params(), fl)
    step = D.make_afl_train_step(model, cfg, dc, pol.controller)
    step64 = D.make_afl_train_step(model64, cfg64, dc64, pol.controller)
    state = D.init_state(model, dc, 0, device="cpu")
    dists, uploads = [], 0.0
    for r in range(rounds):
        z, t, h2 = provider.round(r)
        ins = [torch.as_tensor(v, dtype=torch.float32) for v in (z, t, h2)]
        out = {}
        for label, stp, d, dt in (("cuda", step, "cuda", None),
                                  ("cpu", step, "cpu", None),
                                  ("f64", step64, "cpu", torch.float64)):
            new, m = stp(_dist_on(state, d, dt),
                         {k: v.to(d) for k, v in batches[r].items()},
                         *(v.to(d) for v in ins), budgets.to(d))
            out[label] = dict(new=new, success=m["success"].cpu(),
                              k=m["k"].cpu(),
                              w=new.w.double().cpu() - state.w.double(),
                              w_n=new.w_n.double().cpu() - state.w_n.double())
        a, c, e = out["cuda"], out["cpu"], out["f64"]
        if not (torch.equal(a["success"], c["success"])
                and torch.equal(c["success"], e["success"])):
            fail(f"dist reduced round {r}: successes differ: "
                 f"{[o['success'].tolist() for o in (a, c, e)]}")
        if (a["k"] - c["k"]).abs().max().item() > 2:
            fail(f"dist reduced round {r}: k {a['k'].tolist()} on the card, "
                 f"{c['k'].tolist()} on the cpu")
        for q in ("w", "w_n"):
            peak = max(e[q].abs().max().item(), 1e-30)
            d_card = (a[q] - e[q]).abs().max().item() / peak
            d_cpu = (c[q] - e[q]).abs().max().item() / peak
            if d_card > 3 * d_cpu + 1e-6:
                fail(f"dist reduced round {r}: the card's update of {q} is "
                     f"{d_card} of its largest entry from the f64 step's, "
                     f"the cpu's {d_cpu}")
            dists.append([r, q, d_card, d_cpu])
        uploads += c["success"].sum().item()
        state = c["new"]
    if not uploads > 0:
        fail("dist reduced: no uploads")
    print(f"dist {DIST_ARCH} reduced f32, each round on the card against "
          f"the cpu from its state: successes equal, k within 2 "
          f"({uploads:.0f} uploads); [round, quantity, card's, cpu's distance "
          f"from the f64 step / its largest entry] {json.dumps(dists)}",
          flush=True)

    # the embedding's gradient adds its rows in a run-dependent order
    # unless deterministic algorithms are asked for
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for policy_name in ("mads", "mads-joint"):
            group_equals_none(D, BL, model, cfg, dc, fl, mesh, policy_name,
                              provider, batches, budgets, rounds)
    finally:
        torch.use_deterministic_algorithms(False)


def group_equals_none(D, BL, model, cfg, dc, fl, mesh, policy_name, provider,
                      batches, budgets, rounds) -> None:
    """Phase 19c's second half for one policy: ``rounds`` rounds on the
    card through the single-rank mesh and without a group, bit-equal."""
    pol = BL.ALL[policy_name](model.num_params(), fl)
    kw = dict(compressor=pol.compressor, staleness=pol.staleness)
    with_group = D.make_afl_train_step(model, cfg, dc, pol.controller,
                                       mesh=mesh, **kw)
    without = D.make_afl_train_step(model, cfg, dc, pol.controller, **kw)
    sg = D.init_state(model, dc, 0, mesh=mesh)
    sn = D.init_state(model, dc, 0, device="cuda")
    for r in range(rounds):
        z, t, h2 = (torch.as_tensor(v, dtype=torch.float32).cuda()
                    for v in provider.round(r))
        b = {k: v.cuda() for k, v in batches[r].items()}
        sg, mg = with_group(sg, b, z, t, h2, budgets.cuda())
        sn, mn = without(sn, b, z, t, h2, budgets.cuda())
        same = all(torch.equal(mg[k], mn[k]) for k in mn) and all(
            torch.equal(getattr(sg, f), getattr(sn, f))
            for f in ("w", "w_n", "g_n", "e_n", "kappa", "q", "energy"))
        if not same:
            fail(f"dist reduced {policy_name} round {r}: the single-rank "
                 f"group's round differs from the round without one")
    print(f"dist reduced {policy_name}: {rounds} rounds through the "
          f"single-rank NCCL group bit-equal to the rounds without one "
          f"(uploads {float(mn['success'].sum())} in the last)",
          flush=True)


def dist_phase(K, smi: str) -> dict:
    """Phase 19: the distributed AFL round (``core/distributed.py``) on a
    single-rank NCCL client mesh."""
    from repro_torch.launch.mesh import make_client_mesh

    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2**30
    mesh = make_client_mesh(DIST_N)
    try:
        runs = {policy: dist_full_width(K, mesh, policy, kernel, smi)
                for policy, kernel in DIST_RUNS}
        left = torch.cuda.memory_allocated() / 2**30
        if left > base + 1:
            fail(f"dist: {left - base:.2f} GiB still allocated after the "
                 f"full-width runs")
        from repro_torch.configs import get_config
        from repro_torch.models.registry import build_model

        s = build_model(get_config(DIST_ARCH)).num_params()
        times = dist_kernel_times(K, s, smi)
        dist_reduced(mesh)
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    print(f"dist phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(runs=runs, times=times)


# ---------------------------------------------------------------------------
# Phase 3c: the sparsify kernels on a row of 2^31 columns and more
# ---------------------------------------------------------------------------

WIDE_S = 2**31 + 2**20  # columns of the one bf16 row
WIDE_BASE = 2**32 - 2**30  # a dither base whose columns cross 2^32


def check_wide_row(K, card: str) -> dict:
    """Phase 3c: both sparsify kernels on one bf16 row of WIDE_S columns
    (x, upload and error 4.3 GB each): ``sparsify_ef`` at t = 0 (every
    column kept: a count past 2^31) and at t = 1.5, ``sparsify_quantize_ef``
    at base 0 and at WIDE_BASE (the dither column wraps mod 2^32 at column
    2^30), each call held against its plain version in column blocks
    (``hold_in_blocks``: uploads and the exact count bit-equal, errors
    within 1e-6); both timed, with their bytes bound."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.empty((1, WIDE_S), dtype=torch.bfloat16, device="cuda")
    for c0 in range(0, WIDE_S, HOLD_BLOCK):
        c1 = min(c0 + HOLD_BLOCK, WIDE_S)
        x[:, c0:c1] = torch.randn((1, c1 - c0), generator=g, device="cuda")
    steps = torch.tensor([0.01], device="cuda")
    levels = torch.tensor([127.0], device="cuda")
    seeds = torch.tensor([11], dtype=torch.int32, device="cuda")
    out, worst = {}, {"sparsify_ef": 0.0, "sparsify_quantize_ef": 0.0}
    counts = []
    for name, t, base in (("sparsify_ef", 0.0, None),
                          ("sparsify_ef", 1.5, None),
                          ("sparsify_quantize_ef", 1.5, 0),
                          ("sparsify_quantize_ef", 0.7, WIDE_BASE)):
        tt = torch.tensor([t], device="cuda")
        if base is None:
            args, got = (tt,), K.sparsify_ef_cuda(x, tt)
        else:
            args = (tt, steps, levels, seeds, base)
            got = K.sparsify_quantize_ef_cuda(x, *args)
        torch.cuda.synchronize()
        worst[name] = max(worst[name], hold_in_blocks(
            name, x, args, {}, got, f"wide row t={t} base={base}"))
        counts.append(dict(name=name, t=t, base=base, count=float(got[2][0])))
        if t == 0.0 and float(got[2][0]) != float(WIDE_S):
            fail(f"wide row: sparsify_ef kept {float(got[2][0])} of {WIDE_S}")
        del got
    print(f"wide row (1, {WIDE_S}) bf16: both kernels held against their "
          f"plain versions, counts exact: {json.dumps(counts)}", flush=True)
    tt = torch.tensor([1.5], device="cuda")
    calls = {
        "sparsify_ef": (lambda: K.sparsify_ef_cuda(x, tt), 4 * WIDE_S),
        "sparsify_quantize_ef": (lambda: K.sparsify_quantize_ef_cuda(
            x, tt, steps, levels, seeds, WIDE_BASE), 22 * WIDE_S),
    }
    for name, (fn, ops) in calls.items():
        ms = median_ms(fn, runs=9, batch=3)
        b = bound(3 * 2 * WIDE_S + 5 * 4, ops, torch.float32)
        out[name] = dict(shape=[1, WIDE_S], dtype="bfloat16", ms=ms, **b,
                         bound_share=b["bound_ms"] / ms,
                         max_abs_err=worst[name],
                         base=0 if name == "sparsify_ef" else WIDE_BASE)
        print(f"{name}: {ms:.4f} ms at (1, {WIDE_S}) bf16 (bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']}, "
              f"{100 * b['bound_ms'] / ms:.1f} %) on {card}", flush=True)
    del x
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 20: the seed and ingest meshes on a single-rank NCCL group
# ---------------------------------------------------------------------------

MESH_SEED_ROUNDS, MESH_SEED_EVERY = 6, 3
MESH_SOAK = (S_RESNET9, "topk", 256, 64, 65_536, 64)  # s, codec, uploads,
# batch, max_k, chunk


def seed_mesh_run(mesh, seeds: list, smi: str, label: str) -> dict:
    """``run_seed_batch(mesh=)`` at full-width ResNet-9 (N = 20, batch 32,
    ``mads``) under deterministic cuDNN against the same seeds without a
    mesh (on one rank of a larger mesh: only this rank's seeds and the
    gathered histories).  Histories equal, and the states this rank holds
    bit-equal; the mesh run's wall seconds, steady seed-rounds/s and
    sparsify launches."""
    from repro_torch.experiments import DataShard, run_seed_batch
    from repro_torch.kernels import sparsify_ef as K

    model, cfg, fl, dev, ev = engine_setup(RESNET9, False, MESH_SEED_ROUNDS)
    shard = DataShard(dev, 32, 0, device=mesh.device)
    kw = dict(rounds=MESH_SEED_ROUNDS, eval_every=MESH_SEED_EVERY,
              device=mesh.device)
    torch.backends.cudnn.deterministic = True
    try:
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_seed_batch(model, cfg, fl, "mads", shard, ev, seeds=seeds,
                             mesh=mesh, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        mine = [sd for sd, r in zip(seeds, got) if r.state is not None]
        want = run_seed_batch(model, cfg, fl, "mads", shard, ev, seeds=mine,
                              **kw)
    finally:
        torch.backends.cudnn.deterministic = False
    here = {sd: r for sd, r in zip(seeds, got) if r.state is not None}
    for sd, w in zip(mine, want):
        if here[sd].history != w.history or not state_equal(here[sd].state,
                                                            w.state):
            fail(f"{label}: seed {sd} through the mesh differs from its run "
                 f"without one")
    steady = [len(r.round_seconds[1:]) / sum(r.round_seconds[1:]) for r in got]
    out = dict(seeds=seeds, held_here=mine, wall_s=wall,
               steady_rounds_per_s=steady, launches=launches,
               uploads=[r.history["uploads"][-1] for r in got])
    print(f"{label} (full-width ResNet-9 mads, N={N_DEV}, "
          f"{MESH_SEED_ROUNDS} rounds, world {mesh.world_size}) on {smi}: "
          f"histories and held states bit-equal to runs without a mesh; "
          f"{json.dumps(out)}", flush=True)
    del got, want
    torch.cuda.empty_cache()
    return out


def soak_mesh(mesh, smi: str) -> dict:
    """Phase 20c: a soak point through ``run_soak(mesh=)`` at s =
    6,573,130 (``topk``, batch 64, max_k 65,536, 256 uploads, parity,
    no loop baseline): every upload ingested, the counters adding up."""
    from repro_torch.kernels import sparsify_ef as K
    from repro_torch.launch import soak

    s, codec, uploads, batch, max_k, chunk = MESH_SOAK
    K.reset_launches()
    res = soak.run_soak(uploads=uploads, batch=batch, s=s, max_k=max_k,
                        codec=codec, mode="parity", baseline=False, mesh=mesh,
                        chunk=chunk)
    launches = dict(K.LAUNCHES)
    if launches["sparsify_quantize_ef"] != -(-uploads // chunk):
        fail(f"soak through the mesh: launches {launches}")
    c = res["snapshot"]["counters"]
    if not (c["accepted"] == c["ingested"] == uploads and c["received"]
            == c["accepted"] + c["rejected"] + c["deferred"]):
        fail(f"soak through the mesh: counters do not add up: {c}")
    out = dict(s=s, codec=codec, uploads=uploads, batch=batch,
               launches=launches,
               world_size=res["world_size"], fused_per_s=res["fused_per_s"],
               fused_wall_s=res["fused_wall_s"])
    print(f"soak through run_soak(mesh=) on {smi}: {json.dumps(out)}",
          flush=True)
    return out


def mesh_phase(smi: str) -> dict:
    """Phase 20: the seed mesh (``run_seed_batch(mesh=)``), the ingest
    mesh (``IngestServer(mesh=)``: the parity ingest bit-equal to the
    server without a mesh and held to ``afl_round`` as phase 15 holds it)
    and a soak point (``run_soak(mesh=)``) on a single-rank NCCL group, at
    full width."""
    from repro_torch.launch.mesh import make_client_mesh

    t0 = time.perf_counter()
    mesh = make_client_mesh(2)
    try:
        out = dict(
            seeds=seed_mesh_run(mesh, [0, 1], smi, "seed mesh"),
            parity=ingest_against_afl_round(
                smi, policies=("mads-topk", "mads-joint"), mesh=mesh),
            soak=soak_mesh(mesh, smi))
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 21: activation checkpointing (remat) at full-width InternLM2-1.8B
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "full", "dots")


def _peak_live(trace: list) -> tuple:
    """The live blocks at the peak of an allocator trace (alloc and
    free_completed events): (peak bytes over the trace's start, the live
    blocks then as (size, frames))."""
    cur = peak = 0
    at = -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif e["action"] == "free_completed":
            cur -= e["size"]
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames") or [])
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    return peak, list(live.values())


def _site(frames: list) -> str:
    """Where an allocation was made: the innermost frame of the port, else
    the backward node that made it (``...generated::XBackward0::apply``),
    else "other"."""
    for f in frames:
        if "repro_torch" in f.get("filename", ""):
            return (f"{f['filename'].split('repro_torch/')[-1]}:{f['line']} "
                    f"{f['name']}")
    for pattern in (r"(\w+Backward\d*)::apply", r"generated::details::(\w+)",
                    r"at::native::(\w+)"):
        for f in frames:
            m = re.search(pattern, f.get("name", ""))
            if m:
                return ("backward " if "native" not in pattern else "op ") + \
                    m.group(1)
    return "other"


def grad_memory_snapshot(model, w_n, batch, smi: str) -> dict:
    """Phase 21a: the allocator's history over one vmapped gradient of
    the clients (``device_grads``, remat "none"): the live blocks at its
    peak, over what was allocated before it, grouped by the frame of the
    port that allocated them and by block size."""
    from repro_torch.core.afl import device_grads

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="all", max_entries=2_000_000)
    try:
        grads = device_grads(model, w_n, batch)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak_over = (torch.cuda.max_memory_allocated() - before) / 2**30
    del grads
    trace = [e for dev in snap["device_traces"] for e in dev]
    peak, live = _peak_live(trace)
    sites, sizes = {}, {}
    for size, frames in live:
        site = _site(frames)
        sites[site] = sites.get(site, 0) + size
        sizes[size] = sizes.get(size, 0) + 1
    top = sorted(sites.items(), key=lambda kv: -kv[1])[:24]
    big = sorted(sizes.items(), key=lambda kv: -kv[0] * kv[1])[:10]
    out = dict(
        peak_over_state_gib=peak_over, traced_peak_gib=peak / 2**30,
        live_blocks=len(live), trace_events=len(trace),
        by_site_gib=[[site, b / 2**30] for site, b in top],
        by_block_size=[[size / 2**20, n, size * n / 2**30] for size, n in big])
    print(f"remat {model.cfg.remat}: the vmapped gradient's live memory at "
          f"its peak, "
          f"{peak / 2**30:.2f} GiB over the state ({len(live)} blocks) on "
          f"{smi}; by allocating frame (GiB):", flush=True)
    for site, gib in out["by_site_gib"]:
        print(f"  {gib:8.3f}  {site}", flush=True)
    print("  by block size (MiB, count, GiB): " + json.dumps(
        out["by_block_size"]), flush=True)
    for size, _ in big[:6]:  # the sites of the largest blocks
        where = {}
        for sz, frames in live:
            if sz == size:
                site = _site(frames)
                where[site] = where.get(site, 0) + 1
        print(f"  {size / 2**20:.1f} MiB blocks by site: " + json.dumps(where),
              flush=True)
    torch.cuda.empty_cache()
    return out


def remat_full_width(mesh, policy: str, smi: str, snapshot: bool) -> dict:
    """Phase 21b: phase 19's ``mads`` run (full-width InternLM2-1.8B, N = 2
    bf16 clients on the single-rank mesh, batch 4, seq 512, 4 rounds,
    ``donate=True``) with ``remat=policy``: the vmapped gradient's peak
    over the state, the round's peak, steady round seconds, launches; with
    ``snapshot``, first the allocator's history of the gradient."""
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import baselines as BL
    from repro_torch.core.afl import device_grads
    from repro_torch.core.distributed import (DistConfig,
                                              make_afl_train_system,
                                              run_afl_rounds)
    from repro_torch.core.runner import evaluate, sample_budgets
    from repro_torch.kernels import sparsify_ef as K
    from repro_torch.models.registry import build_model, demo_batch

    cfg = get_config(DIST_ARCH).replace(remat=policy)
    model = build_model(cfg)
    s = model.num_params()
    fl = FLConfig(num_devices=DIST_N, rounds=DIST_ROUNDS,
                  mean_intercontact=20.0, sparsifier="sampled", seed=0)
    pol = BL.ALL["mads"](s, fl)
    dcfg = DistConfig(num_clients=DIST_N, learning_rate=fl.learning_rate,
                      rounds=DIST_ROUNDS, sample_size=fl.sample_size)
    rng = np.random.default_rng(0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in
                demo_batch(cfg, DIST_BATCH, DIST_SEQ, rng).items()}
               for _ in range(DIST_ROUNDS + 1)]
    system = make_afl_train_system(model, cfg, mesh, dcfg=dcfg,
                                   controller=pol.controller,
                                   staleness=pol.staleness, donate=True)
    state = system["init_state"](0)
    split = {k: v.reshape(DIST_N, -1, *v.shape[1:])
             for k, v in batches[0].items()}
    out = dict(policy=policy)
    if snapshot:
        out["snapshot"] = grad_memory_snapshot(model, state.w_n, split, smi)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads = device_grads(model, state.w_n, split)
    torch.cuda.synchronize()
    out["grad_s"] = time.perf_counter() - t0
    out["grad_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["grad_peak_over_state_gib"] = (torch.cuda.max_memory_allocated()
                                       - before) / 2**30
    del grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks = []

    def batch_fn(r):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return batches[r]

    K.reset_launches()
    state, hist = run_afl_rounds(system["step"], state,
                                 dist_provider(fl, "mads", DIST_ROUNDS),
                                 batch_fn, sample_budgets(fl, 0))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    rounds = [b - a for a, b in zip(marks, marks[1:])]
    out.update(launches=dict(K.LAUNCHES),
               round_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               round_s=rounds,
               steady_round_s=sorted(rounds[1:])[len(rounds[1:]) // 2],
               uploads=sum(float(m["success"].sum()) for m in hist),
               loss=evaluate(model, cfg, state.w, batches[-1]))
    if out["launches"]["sparsify_ef"] != DIST_ROUNDS:
        fail(f"remat {policy}: launches {out['launches']}")
    if not (math.isfinite(out["loss"]) and out["uploads"] > 0):
        fail(f"remat {policy}: loss {out['loss']}, uploads {out['uploads']}")
    print(f"remat {policy} ({DIST_ARCH} full width, N = {DIST_N} bf16 "
          f"clients, batch {DIST_BATCH}, seq {DIST_SEQ}) on {smi}: "
          f"{json.dumps({k: v for k, v in out.items() if k != 'snapshot'})}",
          flush=True)
    del state, hist, system, batches, model, split
    torch.cuda.empty_cache()
    return out


def remat_reduced() -> dict:
    """Phase 21c: reduced InternLM2 in float32 on the card, two clients'
    vmapped gradient (``device_grads``) under each policy against
    ``none``'s, under deterministic algorithms: bit-equal printed; beyond
    1e-6 of the largest entry fails."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.afl import device_grads
    from repro_torch.models.registry import build_model, demo_batch

    cfg = get_config(DIST_ARCH).reduced().replace(**F32)
    model = build_model(cfg)
    w = model.layout.flatten(model.init(torch.Generator().manual_seed(0),
                                        "cuda"))
    w_n = torch.stack([w, w * 1.01])
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(v).cuda().reshape(2, -1, *v.shape[1:])
             for k, v in demo_batch(cfg, 4, 64, rng).items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = device_grads(model, w_n, batch)
        out = {}
        for policy in REMAT_POLICIES[1:]:
            got = device_grads(dataclasses.replace(
                model, cfg=cfg.replace(remat=policy)), w_n, batch)
            off = ((got - want).abs().max() / want.abs().max()).item()
            out[policy] = dict(bit_equal=bool(torch.equal(got, want)),
                               max_rel_diff=off)
            if off > 1e-6:
                fail(f"remat {policy}: the reduced f32 gradient is {off} of "
                     f"its largest entry from none's")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"remat reduced f32 gradients against none's: {json.dumps(out)}",
          flush=True)
    return out


def remat_phase(smi: str) -> dict:
    """Phase 21: remat at full-width InternLM2-1.8B (phase 19's
    configuration) and the reduced f32 check."""
    from repro_torch.launch.mesh import make_client_mesh

    t0 = time.perf_counter()
    mesh = make_client_mesh(DIST_N)
    try:
        runs = {p: remat_full_width(mesh, p, smi, snapshot=p != "dots")
                for p in REMAT_POLICIES}
        reduced = remat_reduced()
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    print(f"remat phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(runs=runs, reduced=reduced)


# ---------------------------------------------------------------------------
# --mesh P: the distributed round over P cards (one process a card)
# ---------------------------------------------------------------------------

MESH_CODECS = (("mads", False), ("mads-topk", False), ("mads-joint", False),
               ("mads-joint", True), ("qsgd", False), ("fixed-kb", False))
MESH_ROUNDS = 3


def mesh_parity(mesh) -> dict:
    """One rank's reduced rounds: ResNet-9 at width 4, N = 2 P clients
    (2 a rank), 3 rounds of each policy of ``MESH_CODECS`` from one seed,
    alone on this rank's card (no group, all N clients) and through the
    mesh (this rank's 2 rows), under deterministic cuDNN: whether the bits
    histories are equal, and how far the global model and the rank's rows
    of the client models are apart, relative to their largest entry (the
    largest, and the share of coordinates beyond 1e-6)."""
    import dataclasses

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import baselines as BL
    from repro_torch.core import distributed as D
    from repro_torch.core.runner import build_provider, sample_budgets
    from repro_torch.experiments import DataShard
    from repro_torch.launch.train import build_device_data
    from repro_torch.models.registry import build_model

    n = 2 * mesh.world_size
    cfg = get_config(RESNET9).replace(d_model=4)
    model = build_model(cfg)
    fl = FLConfig(num_devices=n, rounds=MESH_ROUNDS, batch_size=8,
                  learning_rate=0.02, mean_contact=6.0, mean_intercontact=30.0,
                  energy_budget=(40.0, 80.0))
    dev, _ = build_device_data(cfg, fl, train_n=80 * n, eval_n=32, seed=0)
    shard = DataShard(dev, fl.batch_size, seed=0, device=mesh.device)
    key = shard.seed_key(0)
    params = model.init(torch.Generator().manual_seed(0), mesh.device)
    rows = mesh.rows(n)
    out = {}
    for name, per_layer in MESH_CODECS:
        flv = dataclasses.replace(fl, per_layer_budget=per_layer)
        pol = BL.ALL[name](model.num_params(), flv)
        dc = D.DistConfig(num_clients=n, rounds=MESH_ROUNDS,
                          learning_rate=flv.learning_rate,
                          state_dtype="float32")
        res = {}
        for label, m in (("alone", None), ("mesh", mesh)):
            step = D.make_afl_train_step(model, cfg, dc, pol.controller,
                                         compressor=pol.compressor,
                                         staleness=pol.staleness, mesh=m)
            st = D.init_state(model, dc, 0, mesh=m, device=mesh.device,
                              params=params)
            st, hist = D.run_afl_rounds(
                step, st, build_provider(flv, name, None, MESH_ROUNDS, 0,
                                         "cpu"),
                lambda r: {k: v.flatten(0, 1)
                           for k, v in shard.traced_batch(key, r).items()},
                sample_budgets(flv, 0))
            res[label] = (st, torch.stack([h["bits"] for h in hist]))
        (sa, ba), (sm, bm) = res["alone"], res["mesh"]
        tag = name + ("+pl" if per_layer else "")
        out[tag] = dict(bits_equal=bool(torch.equal(ba, bm)),
                        bits_total=float(ba.sum()),
                        local_rows=int(sm.w_n.shape[0]))
        for f, a, b in (("w", sa.w, sm.w), ("w_n", sa.w_n[rows], sm.w_n)):
            off = (a - b).abs() / a.abs().max()
            out[tag][f"{f}_off"] = float(off.max())
            out[tag][f"{f}_far_share"] = float((off > 1e-6).float().mean())
    return out


def mesh_full_width(mesh) -> dict:
    """One rank's full-width rounds: InternLM2-1.8B in bf16, one client a
    card (N = P), global batch 2 P, seq 512, ``donate=True``, 4 rounds of
    ``mads`` with every client in contact in round 2: this rank's launch
    count, round seconds (each round ends at a barrier), peak GiB, and a
    probe of w that every rank must hold bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import baselines as BL
    from repro_torch.core.distributed import (DistConfig,
                                              make_afl_train_system,
                                              run_afl_rounds)
    from repro_torch.core.runner import evaluate, sample_budgets
    from repro_torch.kernels import sparsify_ef as K
    from repro_torch.models.registry import build_model, demo_batch

    n = mesh.world_size
    cfg = get_config(DIST_ARCH)
    model = build_model(cfg)
    s = model.num_params()
    fl = FLConfig(num_devices=n, rounds=DIST_ROUNDS, mean_intercontact=20.0,
                  sparsifier="sampled", seed=0)
    policy = BL.ALL["mads"](s, fl)
    dcfg = DistConfig(num_clients=n, learning_rate=fl.learning_rate,
                      rounds=DIST_ROUNDS, sample_size=fl.sample_size)
    rng = np.random.default_rng(0)
    batches = [{k: torch.as_tensor(v).to(mesh.device) for k, v in
                demo_batch(cfg, 2 * n, DIST_SEQ, rng).items()}
               for _ in range(DIST_ROUNDS + 1)]
    torch.cuda.reset_peak_memory_stats()
    system = make_afl_train_system(
        model, cfg, mesh, dcfg=dcfg, controller=policy.controller,
        staleness=policy.staleness, donate=True)
    state = system["init_state"](0)
    marks = []

    def batch_fn(r):
        torch.cuda.synchronize()
        dist.barrier()
        marks.append(time.perf_counter())
        return batches[r]

    K.reset_launches()
    state, hist = run_afl_rounds(system["step"], state,
                                 dist_provider(fl, "mads", DIST_ROUNDS),
                                 batch_fn, sample_budgets(fl, 0))
    torch.cuda.synchronize()
    dist.barrier()
    marks.append(time.perf_counter())
    probe = state.w[::997].float()
    probes = [torch.empty_like(probe) for _ in range(n)]
    dist.all_gather(probes, probe)
    out = dict(
        launches=dict(K.LAUNCHES),
        round_s=[b - a for a, b in zip(marks, marks[1:])],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        uploads=sum(float(m["success"].sum()) for m in hist),
        w_same_on_every_rank=all(torch.equal(p, probe) for p in probes),
        loss=evaluate(model, cfg, state.w, batches[-1]),
        k=[m["k"].tolist() for m in hist])
    del state, hist, system, batches, model
    torch.cuda.empty_cache()
    return out


MESH_SEEDS = 4  # one seed a card
MESH_INGEST = (S_RESNET9, "topk", 1024, 64, 65_536, 64)  # s, codec,
# uploads, batch, max_k, chunk


def mesh_seeds(mesh) -> dict:
    """One rank's seed mesh: full-width ResNet-9 ``mads`` (N = 20, batch
    32), S = 4 seeds over the P ranks (``make_seed_mesh``), deterministic
    cuDNN.  The run's wall seconds between barriers and each seed's steady
    rounds/s; on rank 0 also each seed alone and the S seeds batched on
    its one card: every gathered history equal to its single run (and
    whether it equals the one-card batch's, printed)."""
    import torch.distributed as dist

    from repro_torch.experiments import DataShard, run_seed_batch
    from repro_torch.launch.mesh import make_seed_mesh

    seed_mesh = make_seed_mesh(MESH_SEEDS)
    if seed_mesh is None or seed_mesh.world_size != mesh.world_size:
        fail(f"make_seed_mesh({MESH_SEEDS}) over {mesh.world_size} ranks: "
             f"{seed_mesh}")
    model, cfg, fl, dev, ev = engine_setup(RESNET9, False, MESH_SEED_ROUNDS)
    shard = DataShard(dev, 32, 0, device=mesh.device)
    kw = dict(rounds=MESH_SEED_ROUNDS, eval_every=MESH_SEED_EVERY,
              device=mesh.device)
    seeds = list(range(MESH_SEEDS))

    def timed(m, sds):
        torch.cuda.synchronize()
        if m is not None:
            dist.barrier()
        t0 = time.perf_counter()
        res = run_seed_batch(model, cfg, fl, "mads", shard, ev, seeds=sds,
                             mesh=m, **kw)
        torch.cuda.synchronize()
        if m is not None:
            dist.barrier()
        return res, time.perf_counter() - t0

    def steady(r):
        return len(r.round_seconds[1:]) / sum(r.round_seconds[1:])

    got, wall = timed(seed_mesh, seeds)
    out = dict(wall_s=wall, seed_rounds_per_s=len(seeds) * MESH_SEED_ROUNDS
               / wall, steady_rounds_per_s=[steady(r) for r in got],
               held_here=[sd for sd, r in zip(seeds, got)
                          if r.state is not None])
    if mesh.rank == 0:
        out["equal_to_single_runs"] = [
            timed(None, [sd])[0][0].history == got[sd].history for sd in seeds]
        one, one_wall = timed(None, seeds)
        out.update(one_card_wall_s=one_wall,
                   one_card_seed_rounds_per_s=len(seeds) * MESH_SEED_ROUNDS
                   / one_wall,
                   one_card_steady_seed_rounds_per_s=len(seeds)
                   * steady(one[0]),
                   equal_to_one_card=[a.history == b.history
                                      for a, b in zip(got, one)])
        del one
    del got
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def mesh_ingest(mesh) -> dict:
    """One rank's ingest mesh: the same payloads on every rank (soak's
    ``make_payloads``, s = 6,573,130, ``topk``, 1,024 uploads), each rank
    offering its 16 of each batch of 64 to ``IngestServer(mesh=)``
    (parity): uploads/s between barriers, and w gathered from every rank;
    on rank 0 also one card's server over all the payloads: w within 1e-6
    of its largest entry at 97 % of the coordinates and 1e-4 everywhere,
    the ingest's counters and bins equal."""
    import torch.distributed as dist

    from repro_torch.launch import soak
    from repro_torch.serve import IngestServer
    from repro_torch.telemetry.tracing import PhaseTracer

    s, codec, uploads, batch, max_k, chunk = MESH_INGEST
    payloads = soak.make_payloads(uploads, s, max_k, codec=codec, chunk=chunk,
                                  device=mesh.device)

    def drive(m):
        srv = IngestServer(torch.zeros(s, device=mesh.device),
                           num_devices=uploads, batch=batch, max_k=max_k,
                           mesh=m, queue_policy="defer")
        PhaseTracer.fence(srv._ingest(srv.w, srv.pack([]), srv.tstate))
        torch.cuda.synchronize()
        if m is not None:
            dist.barrier()
        t0 = time.perf_counter()
        soak.drain_all(srv, soak.rank_share(payloads, batch, m))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = srv.snapshot()
        return srv.w, snap, wall

    w, snap, wall = drive(mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.world_size)]
    dist.all_gather(parts, w)
    keys = ("batches", "ingested", "bits_ingested", "weight_sum")
    out = dict(uploads_per_s=snap["counters"]["ingested"] / wall, wall_s=wall,
               w_same_on_every_rank=all(torch.equal(p, w) for p in parts),
               counters={k: snap["counters"][k] for k in keys})
    if mesh.rank == 0:
        w1, snap1, wall1 = drive(None)
        off = (w - w1).abs() / w1.abs().max()
        out.update(
            one_card_uploads_per_s=snap1["counters"]["ingested"] / wall1,
            counts_equal=all(snap["counters"][k] == snap1["counters"][k]
                             for k in keys[:3])
            and all(np.array_equal(snap["hist"][k], snap1["hist"][k])
                    for k in snap1["hist"]),
            w_off=float(off.max()), w_far_share=float((off > 1e-6).float()
                                                      .mean()),
            w_bit_equal_to_one_card=bool(torch.equal(w, w1)))
    del payloads
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def mesh_rank(rank: int, world: int, store_path: str) -> None:
    """``--mesh-rank r P STORE``: one rank of ``--mesh P``, on card r."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh(2 * world, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        out = dict(rank=mesh.rank, card=str(mesh.device),
                   parity=mesh_parity(mesh), full=mesh_full_width(mesh),
                   seeds=mesh_seeds(mesh), ingest=mesh_ingest(mesh))
    finally:
        mesh.close()
    print("MESH_RANK " + json.dumps(out), flush=True)


def mesh_main(world: int) -> None:
    """``--mesh P``: the distributed round over P cards, one process a
    card on a file store.  Each rank runs ``mesh_parity`` (world 1 on its
    own card against world P: bits histories equal; w and its rows of
    w_n within 1e-6 of their largest entry at 97 % of the coordinates or
    more and within 1e-4 everywhere) and ``mesh_full_width`` (one sparsify_ef launch a
    round on every rank, uploads > 0, a finite loss, the same w on every
    rank, peak GiB, round seconds).  Prints one JSON line of every
    rank's results, then fails if any check does."""
    from repro_torch.kernels import sparsify_ef as K

    if torch.cuda.device_count() < world:
        fail(f"--mesh {world} needs {world} cards, found "
             f"{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"mesh of {world}: {smi.splitlines()}", flush=True)
    build_kernels({"sparsify_ef": K})
    store = Path(tempfile.mkdtemp(prefix="mesh_store_")) / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(r),
         str(world), str(store)], stdout=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            text = p.communicate(timeout=1200)[0]
            if p.returncode != 0:
                fail(f"a mesh rank exited with {p.returncode}")
            outs.append(json.loads([line for line in text.splitlines()
                                    if line.startswith("MESH_RANK ")][-1][10:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(json.dumps({"mesh": world, "card": smi.splitlines()[0],
                      "ranks": outs}), flush=True)
    for o in outs:
        for tag, p in o["parity"].items():
            # the all-reduce adds in another order than one rank's
            # contraction, and where a quantised code sits that close to a
            # dither step it moves by one: the standard the CPU tests hold
            # the reference's step to
            if not (p["bits_equal"] and p["bits_total"] > 0
                    and max(p["w_off"], p["w_n_off"]) <= 1e-4
                    and max(p["w_far_share"], p["w_n_far_share"]) <= 0.03):
                fail(f"mesh rank {o['rank']} {tag}: world {world} differs "
                     f"from world 1: {p}")
        f = o["full"]
        if not (f["launches"]["sparsify_ef"] == DIST_ROUNDS
                and sum(f["launches"].values()) == DIST_ROUNDS
                and f["uploads"] > 0 and math.isfinite(f["loss"])
                and f["w_same_on_every_rank"]):
            fail(f"mesh rank {o['rank']} full width: {f}")
        g = o["ingest"]
        if not g["w_same_on_every_rank"]:
            fail(f"mesh rank {o['rank']}: the ingest's w differs over ranks")
        if o["rank"] == 0:
            if not all(o["seeds"]["equal_to_single_runs"]):
                fail(f"seed mesh: a seed's history differs from its run on "
                     f"one card: {o['seeds']}")
            if not (g["counts_equal"] and g["w_off"] <= 1e-4
                    and g["w_far_share"] <= 0.03):
                fail(f"ingest mesh: world {world} differs from one card: {g}")
    print(f"mesh of {world}: every check passed", flush=True)


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


def dist_entry(dist: dict, policy: str, name: str) -> dict:
    """Phase 19's numbers for a kernel's entry of the kernels line."""
    times = dist["times"][name]
    return {"launches_internlm2_dist": dist["runs"][policy]["launches"][name],
            **{f"{k}_internlm2_dist": times[k]
               for k in ("shape", "ms", "bound_ms", "bound_share")}}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if sys.argv[1:2] == ["--time-tree"]:
        return time_tree(sys.argv[2])
    if sys.argv[1:2] == ["--mesh"]:
        return mesh_main(int(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    only = (set(sys.argv[2].split(",")) if sys.argv[1:2] == ["--only"]
            else None)
    if only is not None and not only <= {"3c", "19", "20", "21"}:
        fail(f"--only takes phases of 3c, 19, 20, 21, not {sys.argv[2]}")
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
    if only is not None:  # phases 1, 2 and the named ones; no kernels line
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        phases = {"3c": lambda: check_wide_row(K, smi),
                  "19": lambda: dist_phase(K, smi),
                  "20": lambda: mesh_phase(smi),
                  "21": lambda: remat_phase(smi)}
        done = {p: phases[p]() for p in ("3c", "19", "20", "21") if p in only}
        print(json.dumps(dict(phases=sorted(done), held=HELD), default=str))
        return

    # 3. kernels against their plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timing = check_kernels(K, R, smi)
    segmented = check_segmented(K, R, smi)
    wide = check_wide_row(K, smi)
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
    cfg, launches_dense, _ = serve_full(mods, "llama3.2-3b", LLAMA_BATCH,
                                        LLAMA_PROMPT)
    if launches_dense["decode_attn"] != cfg.num_layers * GEN:
        fail(f"dense serve launched decode_attn {launches_dense['decode_attn']} "
             f"times, not {cfg.num_layers} x {GEN}")
    cfg, launches_ssm, _ = serve_full(mods, "mamba2-2.7b", MAMBA_BATCH,
                                      MAMBA_PROMPT)
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

    # 14. the whole-run engine (the captured round), seed batching, the
    # sweep CLI
    whole_run = engine_phase(K, smi)
    torch.cuda.empty_cache()

    # 15. the streaming ingest server at full width
    ingest = ingest_phase(K, smi)
    torch.cuda.empty_cache()

    # 16. federated LM fine-tuning (reduced dense and ssm)
    lm_launches = lm_phase(K, SSD, smi)
    torch.cuda.empty_cache()

    # 17. serve, other families (MoE, hybrid, audio, VLM) at full width
    others = serve_other_families(mods, smi)
    torch.cuda.empty_cache()

    # 19. the distributed AFL round, full-width InternLM2-1.8B (before the
    # profile pass, which stays last)
    dist = dist_phase(K, smi)

    # 20. the seed and ingest meshes on a single-rank NCCL group
    meshes = mesh_phase(smi)

    # 21. remat at full-width InternLM2-1.8B (phase 19's configuration)
    remat = remat_phase(smi)

    # 18. device time by kernel, last (the profiler slows later launches)
    profile_kernels(DA, SSD)
    profiled = {}
    for arch in (LANEGCN, RESNET9):
        profile_rounds(arch)
        profiled[f"{arch} mads"] = profile_captured(K, arch, "mads")
    profiled[f"{LANEGCN} mads-joint per-layer"] = profile_captured(
        K, LANEGCN, "mads-joint", per_layer=True)
    profile_schedules(engine)
    for arch, batch, prompt, layers in OTHER_SERVES:
        if arch in PROFILED_DECODES:
            run = others[arch][1]
            profile_decode(arch, batch, prompt, layers,
                           1e3 * run["decode_s"] / GEN)
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
             launches_captured={
                 name: captured_launches(whole_run, profiled, name)
                 for name in (f"{RESNET9} mads", f"{LANEGCN} mads")},
             launches_lm={k: v["sparsify_ef"] for k, v in lm_launches.items()},
             launches_soak={label: p["launches"]["sparsify_ef"]
                            for label, p in ingest["soak"].items()
                            if p["launches"]["sparsify_ef"]},
             **dist_entry(dist, "mads", "sparsify_ef"),
             launches_seed_mesh=meshes["seeds"]["launches"]["sparsify_ef"],
             launches_remat={p: r["launches"]["sparsify_ef"]
                             for p, r in remat["runs"].items()},
             **{f"{k}_wide_row": v for k, v in wide["sparsify_ef"].items()},
             **timing["sparsify_ef"]),
        dict(name="sparsify_quantize_ef", route="cuda",
             source=src + "sparsify_ef.cu",
             replaces="src/repro/kernels/sparsify_ef.py:124",
             launches=launches_joint["sparsify_quantize_ef"], library_ms=None,
             launches_lanegcn_qsgd=lanegcn["qsgd"]["launches"][
                 "sparsify_quantize_ef"],
             launches_resnet9_mads_joint_rwp=trace[f"{RESNET9} mads-joint rwp"][
                 "launches"]["sparsify_quantize_ef"],
             launches_soak={label: p["launches"]["sparsify_quantize_ef"]
                            for label, p in ingest["soak"].items()
                            if p["launches"]["sparsify_quantize_ef"]},
             **dist_entry(dist, "mads-joint", "sparsify_quantize_ef"),
             launches_soak_mesh=meshes["soak"]["launches"][
                 "sparsify_quantize_ef"],
             **{f"{k}_wide_row": v
                for k, v in wide["sparsify_quantize_ef"].items()},
             **timing["sparsify_quantize_ef"]),
        # the per-layer codec's route to the same TPU kernel: launches and
        # times at ResNet-9's (20, 6,573,130), *_lanegcn at (20, 247,100)
        dict(name="sparsify_quantize_ef_segmented", route="cuda",
             source=src + "sparsify_ef.cu",
             replaces="src/repro/kernels/sparsify_ef.py:124",
             launches=launches_pl["sparsify_quantize_ef_segmented"],
             launches_lanegcn=lanegcn["mads-joint"]["launches"][
                 "sparsify_quantize_ef_segmented"],
             launches_captured_lanegcn=captured_launches(
                 whole_run, profiled, f"{LANEGCN} mads-joint per-layer"),
             **segmented[RESNET9],
             **{f"{key}_lanegcn": segmented[LANEGCN][key] for key in
                ("ms", "ms_per_call", "plain_ms", "bound_ms", "bound_share",
                 "tiles")}),
        dict(name="decode_attn", route="cuda", source=src + "decode_attn.cu",
             replaces="src/repro/kernels/decode_attn.py:64",
             launches=launches_dense["decode_attn"],
             launches_serve={a: l["decode_attn"] for a, (l, _) in others.items()
                             if l["decode_attn"]},
             **decode["main"],
             **{f"{key}_32k": decode["deep"][key] for key in
                ("ms", "ms_per_call", "plain_ms", "library_ms", "bound_ms",
                 "bound_share")}),
        dict(name="ssd_scan", route="cuda", source=src + "ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:60",
             launches=launches_ssm["ssd_scan"],
             launches_serve={a: l["ssd_scan"] for a, (l, _) in others.items()
                             if l["ssd_scan"]},
             # the LM phase's eval forwards (reduced Mamba2, 2 layers)
             launches_lm={k: v["ssd_scan"] for k, v in lm_launches.items()
                          if v["ssd_scan"]},
             **ssd),
    ]
    for entry in kernels:
        entry["timing"] = TIMING
        entry["held_on_main_path_inputs"] = [
            {k: h[k] for k in ("tag", "shape", "length", "dtype", "max_abs_err")
             if k in h}
            for h in HELD if h["name"] == entry["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
