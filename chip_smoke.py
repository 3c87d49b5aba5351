#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (a failed phase exits non-zero):

1. device: the card's name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shape (N = 20 devices x s = 6,573,130 ResNet-9
   parameters) in f32 and bf16 and at ragged shapes; uploads and counts
   bit-equal, errors within 1e-6; median times over 25 runs (CUDA events)
   beside the plain version's and the HBM bound;
4. main path: ``repro_torch.launch.train`` in-process at full-width
   ResNet-9, N = 20, batch 32, for policies ``mads`` (through
   ``sparsify_ef``) and ``mads-joint`` (through ``sparsify_quantize_ef``),
   with each kernel's launch count read around its run; uploads > 0 and a
   finite eval;
5. reference: the same training on CUDA and on the CPU (plain versions) at
   width 4 from one seed agree.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
CUDA card and outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
N_DEV, S_RESNET9 = 20, 6_573_130
T_ROW = [0.0, 0.7, 1.5, math.inf, math.nextafter(-math.inf, math.inf)]
TIMED_RUNS = 25


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median over ``runs`` launches of fn, each timed by CUDA events."""
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
    times = {
        "sparsify_ef": (
            median_ms(lambda: K.sparsify_ef_cuda(x, t)),
            median_ms(lambda: R.sparsify_ef_plain(x, t)),
            # x read, upload + error written; thresholds read, counts written
            3 * 4 * n_el + 2 * 4 * N_DEV,
            4 * n_el,  # |x|, compare, two selects per element
        ),
        "sparsify_quantize_ef": (
            median_ms(lambda: K.sparsify_quantize_ef_cuda(x, t, steps, levels,
                                                          seeds, base)),
            median_ms(lambda: R.sparsify_quantize_ef_plain(x, t, steps, levels,
                                                           seeds, base)),
            3 * 4 * n_el + 5 * 4 * N_DEV,
            22 * n_el,  # the hash (10), divide, add, floor, clamp, mul, sub, ...
        ),
    }
    out = {}
    for name, (ms, plain_ms, nbytes, ops) in times.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err[name],
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']}) "
              f"at ({N_DEV}, {S_RESNET9}) f32 on {card}", flush=True)
    return out


def train(argv):
    from repro_torch.launch import train as T

    with tempfile.TemporaryDirectory() as wd:
        return T.main(argv + ["--workdir", wd])


def main_path(K, policy: str, rounds: int = 4):
    """Phase 4 for one policy: returns (launches, steady rounds/s)."""
    argv = ["--arch", "resnet9-cifar10", "--policy", policy, "--rounds",
            str(rounds), "--devices", str(N_DEV), "--batch-size", "32",
            "--train-n", "2000", "--intercontact", "20", "--eval-every",
            str(rounds), "--device", "cuda", "--seed", "0"]
    K.reset_launches()
    res = train(argv)
    launches = dict(K.LAUNCHES)
    hist = res.history
    if not hist["uploads"][-1] > 0:
        fail(f"{policy}: no uploads in {rounds} rounds")
    if not all(math.isfinite(v) for v in hist["eval"]):
        fail(f"{policy}: eval not finite: {hist['eval']}")
    if not torch.isfinite(res.state.w).all():
        fail(f"{policy}: global model not finite")
    steady = res.round_seconds[1:]
    rps = len(steady) / sum(steady)
    print(f"main path {policy}: eval {hist['eval'][-1]:.4f}, uploads "
          f"{hist['uploads'][-1]:.0f}, launches {launches}, round seconds "
          f"{res.round_seconds}, steady {rps} rounds/s", flush=True)
    return launches, rps


def check_against_cpu():
    """Phase 5: CUDA and CPU (plain versions) runs from one seed agree."""
    hists = {}
    for dev in ("cuda", "cpu"):
        argv = ["--policy", "mads", "--width", "4", "--devices", "4",
                "--rounds", "3", "--eval-every", "1", "--batch-size", "8",
                "--train-n", "200", "--intercontact", "20", "--device", dev]
        hists[dev] = train(argv).history
    a, b = hists["cuda"], hists["cpu"]
    if a["uploads"] != b["uploads"] or a["round"] != b["round"]:
        fail(f"cuda and cpu runs differ: {a} vs {b}")
    if max(abs(x - y) for x, y in zip(a["eval"], b["eval"])) > 0.02:
        fail(f"cuda and cpu eval differ: {a['eval']} vs {b['eval']}")
    print(f"cuda run matches cpu run at width 4: eval {a['eval']} vs "
          f"{b['eval']}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from repro_torch.kernels import build
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import sparsify_ef as K

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} ({smi}); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    K.library()
    print(f"build: {build.library_path('sparsify_ef').name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    log = build.log_path("sparsify_ef")
    for line in log.read_text().splitlines() if log.exists() else ():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. kernels against their plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timing = check_kernels(K, R, smi)
    torch.cuda.empty_cache()

    # 4. main path, counts read around each policy's run
    launches_mads, rps_mads = main_path(K, "mads")
    if launches_mads["sparsify_ef"] < 1:
        fail(f"mads never launched sparsify_ef: {launches_mads}")
    launches_joint, rps_joint = main_path(K, "mads-joint")
    if launches_joint["sparsify_quantize_ef"] < 1:
        fail(f"mads-joint never launched sparsify_quantize_ef: {launches_joint}")
    print(f"rounds/s (steady, full-width ResNet-9, N={N_DEV}, batch 32) on "
          f"{smi}: mads {rps_mads}, mads-joint {rps_joint}", flush=True)

    # 5. against the CPU path at a small size
    check_against_cpu()

    src = "src/repro_torch/kernels/csrc/sparsify_ef.cu"
    kernels = [
        dict(name="sparsify_ef", route="cuda", source=src,
             replaces="src/repro/kernels/sparsify_ef.py:60",
             launches=launches_mads["sparsify_ef"], library_ms=None,
             **timing["sparsify_ef"]),
        dict(name="sparsify_quantize_ef", route="cuda", source=src,
             replaces="src/repro/kernels/sparsify_ef.py:124",
             launches=launches_joint["sparsify_quantize_ef"], library_ms=None,
             **timing["sparsify_quantize_ef"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
