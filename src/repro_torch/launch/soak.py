"""Soak the streaming ingestion server: sustained uploads/s; the port of
``repro/launch/soak.py``.

Generates a population of compressed uploads with the engines' own codec
pass (``core.afl.compress_uploads``, so on the card the sparsify kernels
run: ``topk32`` through ``sparsify_ef``, the quantising codecs ``topk``,
``joint``, ``fixed-kb`` and ``qsgd`` through ``sparsify_quantize_ef``),
serialises them to the wire format, and drives them through
``serve.IngestServer`` in a bounded-queue producer/consumer loop,
measuring sustained aggregation throughput:

    PYTHONPATH=src python -m repro_torch.launch.soak --uploads 10000 \
        --batch 256 --params 4096 --staleness hinge --out-dir runs/soak

The per-upload loop baseline (the fused op at batch = 1, what a naive
server does) runs alongside; ``speedup_vs_loop`` is the headline number,
and ``--out-dir`` receives ``BENCH_serve.json``.  Runs on the card unless
``--device cpu``.  The gradients come from a ``torch.Generator`` seeded by
``--seed`` (not the reference's ``jax.random`` draws).

``--mesh N`` splits each batch over N processes, one a card (gloo ranks on
the CPU with ``--device cpu``), under ``torchrun``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.soak ... --mesh 4

Every rank generates the same payload stream from ``--seed`` and offers
its own server its share of each batch (``serve/server.py``); the loop
baseline runs on each rank's card alone.  Rank 0 prints the summary and
writes ``BENCH_serve.json``, with the world size in its meta.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["drain_all", "ingest_soak", "make_payloads", "rank_share",
           "run_soak", "main"]

_CODECS = ("topk", "topk32", "qsgd", "joint", "fixed-kb")


def _make_codec(name: str, s: int):
    from repro_torch.compression.joint import JointCompressor
    from repro_torch.compression.qsgd import QSGDCompressor
    from repro_torch.compression.topk import FixedKbCompressor, TopKCompressor

    if name == "topk":
        return TopKCompressor(s=s, u=8)
    if name == "topk32":
        return TopKCompressor(s=s, u=32)
    if name == "qsgd":
        return QSGDCompressor(s=s)
    if name == "joint":
        return JointCompressor(s=s)
    if name == "fixed-kb":
        return FixedKbCompressor(s=s, b=8)
    raise ValueError(f"unknown codec {name!r}; known: {_CODECS}")


def make_payloads(uploads: int, s: int, max_k: int, *, codec: str = "topk",
                  max_stale: int = 32, seed: int = 0, chunk: int = 512,
                  device="cuda"):
    """Compress ``uploads`` synthetic gradients and serialise to the wire.

    Chunks of devices go through ``compress_uploads`` as (chunk, s) rows
    on ``device`` (one codec pass, one sparsify launch on the card, per
    chunk); each device's dense payload is then encoded with the codec's
    reported ``(step, b)`` so quantised codecs ship integer grid codes.
    Upload round tags are back-dated up to ``max_stale`` rounds so the
    staleness-weight family has a spread of ``delta_tau`` to act on.
    Budgets are sized so that k stays within ``max_k`` at the codec's
    narrowest value width (8 bits; 32 for ``topk32``; the joint codec's
    smallest b, which may be under 8).
    """
    import torch

    from repro_torch.compression import quant as Q
    from repro_torch.compression.wire import encode_upload, index_bits
    from repro_torch.core.afl import compress_uploads
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import TreeLayout

    device = resolve_device(device)
    comp = _make_codec(codec, s)
    layout = TreeLayout((("layer0",), ("layer1",)),
                        ((s // 2,), (s - s // 2,)))
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    dither = torch.Generator().manual_seed(seed + 0x5EED)
    u_bits = {"topk32": 32, "joint": min(getattr(comp, "b_grid", (8,)))}.get(
        codec, 8)
    cap = float(max_k) * (u_bits + index_bits(s))
    payloads = []
    for lo in range(0, uploads, chunk):
        n = min(chunk, uploads - lo)
        g_n = torch.randn((n, s), generator=gen, device=device)
        e_n = torch.zeros_like(g_n)
        budgets = torch.as_tensor(rng.uniform(0.25, 1.0, size=n) * cap,
                                  dtype=torch.float32).to(device)
        upload, _, cstats = compress_uploads(
            comp, g_n, e_n, budgets, Q.draw_seeds(dither, n, device), layout)
        step_b = torch.stack([cstats["step"], cstats["b"]]).to(
            torch.float64).cpu().numpy()
        stale = rng.integers(0, max_stale, size=n)
        for i in range(n):
            b_i = step_b[1, i]
            payloads.append(encode_upload(
                upload[i], b=b_i if b_i > 0 else 32.0, step=float(step_b[0, i]),
                device=lo + i, rnd=-int(stale[i]), max_k=max_k))
        del g_n, e_n, upload
    return payloads


def drain_all(server, payloads) -> None:
    """Producer/consumer loop: offer until backpressure, then step, until
    a step finds no upload (on any rank of a mesh: steps are collective)."""
    i, n = 0, len(payloads)
    while True:
        while i < n:
            if server.submit(payloads[i]):
                i += 1
            elif server.buffer.policy == "reject":
                i += 1  # refused for good: counted, the client re-uploads
            else:
                break  # deferred: retry the same payload after a step
        if not server.step() and i >= n:
            return


def rank_share(payloads, batch: int, mesh) -> list:
    """The payloads a rank of ``mesh`` offers: its rows of each batch of
    ``batch`` consecutive uploads (all of them without a mesh)."""
    if mesh is None:
        return list(payloads)
    per = batch // mesh.world_size
    return [p for j, p in enumerate(payloads)
            if (j % batch) // per == mesh.rank]


def run_soak(*, uploads: int = 10_000, batch: int = 256, s: int = 4096,
             max_k: int = 256, codec: str = "topk",
             staleness_family: str = "constant", alpha: float = 1.0,
             queue_cap: int = 0, queue_policy: str = "defer",
             mode: str = "parity", baseline: bool = True,
             baseline_n: int = 2048, mesh=None, seed: int = 0,
             tracer=None, chunk: int = 512, device="cuda") -> dict:
    """One soak point; returns throughput numbers + the telemetry snapshot.
    ``mesh``: a ``launch.mesh.ClientMesh`` to split each batch over (the
    run's device is then its card)."""
    from repro_torch.telemetry.tracing import PhaseTracer
    from repro_torch.utils.device import resolve_device

    device = resolve_device(device) if mesh is None else mesh.device
    tracer = tracer or PhaseTracer()
    if codec == "qsgd":
        max_k = s  # dense codec: every coordinate rides the wire
    with tracer.span("soak.generate", uploads=uploads):
        payloads = make_payloads(uploads, s, max_k, codec=codec,
                                 seed=seed, chunk=chunk, device=device)
    out = ingest_soak(payloads, s=s, max_k=max_k, batch=batch,
                      staleness_family=staleness_family, alpha=alpha,
                      queue_cap=queue_cap, queue_policy=queue_policy,
                      mode=mode, baseline=baseline, baseline_n=baseline_n,
                      tracer=tracer, device=device, mesh=mesh)
    out["codec"] = codec
    return out


def ingest_soak(payloads, *, s: int, max_k: int, batch: int = 256,
                staleness_family: str = "constant", alpha: float = 1.0,
                queue_cap: int = 0, queue_policy: str = "defer",
                mode: str = "parity", baseline: bool = True,
                baseline_n: int = 2048, tracer=None, device="cuda",
                mesh=None) -> dict:
    """Drive ``payloads`` through a fused ``IngestServer`` of ``batch``
    uploads a step and (``baseline``) the first ``baseline_n`` through a
    server of one upload a step; returns ``run_soak``'s numbers.  Over a
    ``mesh`` the fused server is split (each rank offers its share of
    every batch) and the baseline runs on each rank's card alone."""
    import torch

    from repro_torch.core.afl import StalenessWeight
    from repro_torch.serve import IngestServer
    from repro_torch.telemetry.tracing import PhaseTracer

    tracer = tracer or PhaseTracer()
    uploads = len(payloads)
    sw = StalenessWeight(family=staleness_family, alpha=alpha)
    w = {"layer0": torch.zeros((s // 2,), device=device),
         "layer1": torch.zeros((s - s // 2,), device=device)}

    def build(b, cap, m=None):
        srv = IngestServer(
            w, num_devices=uploads, batch=b, max_k=max_k, staleness=sw,
            queue_capacity=cap, queue_policy=queue_policy, mode=mode,
            tracer=tracer, mesh=m)
        # warm up outside the timed region (ingest is pure: discarded)
        PhaseTracer.fence(srv._ingest(srv.w, srv.pack([]), srv.tstate))
        return srv

    with tracer.span("soak.fused", uploads=uploads):
        share = batch if mesh is None else batch // mesh.world_size
        server = build(batch, queue_cap or 4 * share, mesh)
        mine = rank_share(payloads, batch, mesh)
        t0 = time.perf_counter()
        drain_all(server, mine)
        PhaseTracer.fence(server.w)
        fused_wall = time.perf_counter() - t0
    snap = server.snapshot()
    done = snap["counters"]["ingested"]
    out = {
        "uploads": uploads, "batch": batch, "s": s, "max_k": max_k,
        "staleness": staleness_family, "mode": mode,
        "world_size": 1 if mesh is None else mesh.world_size,
        "fused_wall_s": fused_wall, "fused_per_s": done / fused_wall,
        "snapshot": snap, "server": server,
    }
    if baseline:
        nb = min(uploads, baseline_n)
        with tracer.span("soak.loop_baseline", uploads=nb):
            loop_srv = build(1, max(queue_cap, 4 * batch) or 4 * batch)
            t0 = time.perf_counter()
            drain_all(loop_srv, payloads[:nb])
            PhaseTracer.fence(loop_srv.w)
            loop_wall = time.perf_counter() - t0
        out["loop_per_s"] = nb / loop_wall
        out["speedup_vs_loop"] = out["fused_per_s"] / out["loop_per_s"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--uploads", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--params", type=int, default=4096,
                    help="flat model size s")
    ap.add_argument("--max-k", type=int, default=256,
                    help="wire payload coordinate capacity")
    ap.add_argument("--codec", default="topk", choices=_CODECS)
    ap.add_argument("--staleness", default="constant",
                    choices=("constant", "hinge", "poly"))
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="arrival buffer capacity (0 = 4x batch)")
    ap.add_argument("--queue-policy", default="defer",
                    choices=("reject", "defer"))
    ap.add_argument("--mode", default="parity",
                    choices=("parity", "scatter"))
    ap.add_argument("--mesh", type=int, default=0,
                    help=">1: split each batch over this many processes, one "
                         "a card, under torchrun --nproc-per-node N")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the per-upload loop baseline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="small point (CI): 1500 uploads, s=2048")
    ap.add_argument("--out-dir", default="",
                    help="export BENCH_serve.json here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh > 1:
        import os

        from repro_torch.launch.mesh import make_mesh

        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != args.mesh:
            raise ValueError(
                f"--mesh {args.mesh} runs under torchrun --nproc-per-node "
                f"{args.mesh}; this process group has WORLD_SIZE {world}")
        mesh = make_mesh(device=args.device)
    if args.smoke:
        args.uploads, args.params = min(args.uploads, 1500), 2048
        args.batch, args.max_k = min(args.batch, 128), min(args.max_k, 128)

    from repro_torch.telemetry import export_bench
    from repro_torch.telemetry.tracing import PhaseTracer

    tracer = PhaseTracer()
    try:
        res = run_soak(
            uploads=args.uploads, batch=args.batch, s=args.params,
            max_k=args.max_k, codec=args.codec,
            staleness_family=args.staleness, alpha=args.alpha,
            queue_cap=args.queue_cap, queue_policy=args.queue_policy,
            mode=args.mode, baseline=not args.no_baseline, mesh=mesh,
            seed=args.seed, tracer=tracer, device=args.device)
    finally:
        if mesh is not None:
            mesh.close()
    if mesh is not None and mesh.rank != 0:
        return res

    server = res.pop("server")
    print(server.registry.summary(res["snapshot"]))
    print(tracer.summary())
    name = (f"soak_{args.codec}_{args.staleness}"
            f"_n{args.uploads}_b{args.batch}_s{args.params}")
    derived = f"uploads_per_s={res['fused_per_s']:.0f}"
    if "speedup_vs_loop" in res:
        derived += (f";loop_per_s={res['loop_per_s']:.0f}"
                    f";speedup_vs_loop={res['speedup_vs_loop']:.1f}x")
    row = f"{name},{res['fused_wall_s'] / max(args.uploads, 1) * 1e6:.1f},{derived}"
    print(row)
    if args.out_dir:
        export_bench("serve", [row], args.out_dir,
                     meta={"world_size": res["world_size"]})
    return res


if __name__ == "__main__":
    main()
