"""Plain PyTorch versions of the CUDA kernels.

The sparsify pair are twins of ``kernels/ref.py::sparsify_ef_ref`` and
``::sparsify_quantize_ef_ref`` of the reference, for x (rows, n) with one
parameter per row, so one call covers the whole federation as the CUDA
kernels do; ``sparsify_quantize_ef_segmented_plain`` takes one parameter
per (row, leaf), the per-layer codec's call, and
``sparsify_quantize_ef_blocks_plain`` the same on a rank's blocks under
a counter map (the codecs on a model axis).  ``decode_attn_plain`` is
the twin of ``decode_attn_ref`` (``decode_attn_partials_plain`` gives the
TPU kernel's own (m, l, acc) outputs before its wrapper divides, and
``decode_attn_partials_tol`` the rounding a kernel's may differ by), and
``ssd_scan_plain`` is the port's ``models/mamba2.py::ssd_chunked`` (the
reference's "ref" route for ``ssd_scan``).  The CPU path runs them
(``ops.py``), and ``chip_smoke.py`` holds the kernels to them on the card.
``ssd_chunk_cumsum`` ... ``ssd_chunk_out`` are the plain versions of the
five phases of the ``ssd_scan`` kernel, with its arithmetic (in-chunk log
decays summed and differenced in f64, everything else f32);
``ssd_scan_phases`` composes them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.compression.quant import dither_u01


def sparsify_ef_plain(x: torch.Tensor, thresholds: torch.Tensor):
    """x (rows, n), thresholds (rows,) f32 -> (upload, error, count (rows,) f32).

    upload = x where |x| >= t else 0, error = x where |x| < t else 0.
    """
    mask = x.to(torch.float32).abs() >= thresholds[:, None]
    zero = x.new_zeros(())
    count = mask.sum(dim=1, dtype=torch.int64).to(torch.float32)
    return torch.where(mask, x, zero), torch.where(mask, zero, x), count


def sparsify_quantize_ef_plain(x: torch.Tensor, thresholds, steps, levels,
                               seeds, base: int = 0):
    """Fused sparsify + stochastic quantise + error feedback, per row.

    x (rows, n) f32 or bf16; thresholds, steps, levels (rows,) f32; seeds
    (rows,) int32; base: dither counter offset of column 0.  upload =
    clip(floor(x/step + u), -levels, levels) * step where |x| >= t else 0,
    in x's dtype; error = x - upload (from the rounded upload); count (rows,)
    f32.  The dither u = dither_u01(seed, base + column): ``dither_u01``
    takes the index mod 2^32, as the reference's int32 index wraps once
    cast to uint32, so base + column may pass 2^32.
    """
    xf = x.to(torch.float32)
    mask = xf.abs() >= thresholds[:, None]
    idx = base + torch.arange(x.shape[1], device=x.device, dtype=torch.int64)
    u = dither_u01(seeds[:, None], idx[None, :])
    step = steps[:, None]
    lv = levels[:, None]
    q = torch.minimum(torch.maximum(torch.floor(xf / step + u), -lv), lv) * step
    upload = torch.where(mask, q, q.new_zeros(())).to(x.dtype)
    error = (xf - upload.to(torch.float32)).to(x.dtype)
    count = mask.sum(dim=1, dtype=torch.int64).to(torch.float32)
    return upload, error, count


def sparsify_quantize_ef_blocks_plain(x: torch.Tensor, thresholds, steps,
                                      levels, seeds, offsets, counters):
    """``sparsify_quantize_ef_plain`` with one threshold, step and levels
    per (row, leaf) under a counter map: x (rows, n) a rank's blocks;
    thresholds, steps, levels (rows, L) f32; seeds (rows,) int32; offsets:
    the L + 1 leaf boundaries (0, ..., n); ``counters`` each leaf's (g0,
    R, G, owned): local column c of leaf l draws the dither of counter
    g0 + (c // R) * G + c % R (its whole-model coordinate), and a leaf
    that is not owned counts 0; None: world 1's map (each leaf whole and
    owned, the counter its column).  Returns (upload, error, count (rows,
    L) int64).
    """
    offsets = [int(o) for o in offsets]
    sizes = torch.tensor([b - a for a, b in zip(offsets, offsets[1:])],
                         device=x.device)

    def per_column(p):
        return torch.repeat_interleave(p, sizes, dim=1)

    bounds = list(zip(offsets, offsets[1:]))
    if counters is None:
        idx = torch.arange(x.shape[1], device=x.device, dtype=torch.int64)
        owned = [True] * len(bounds)
    else:
        idx = torch.cat([torch.zeros(0, dtype=torch.int64, device=x.device)]
                        + [g0 + (c // max(run, 1)) * stride + c % max(run, 1)
                           for (a, b), (g0, run, stride, _) in zip(bounds,
                                                                   counters)
                           for c in [torch.arange(b - a, device=x.device,
                                                  dtype=torch.int64)]])
        owned = [own for *_, own in counters]
    xf = x.to(torch.float32)
    mask = xf.abs() >= per_column(thresholds)
    u = dither_u01(seeds[:, None], idx[None, :])
    step, lv = per_column(steps), per_column(levels)
    q = torch.minimum(torch.maximum(torch.floor(xf / step + u), -lv), lv) * step
    upload = torch.where(mask, q, q.new_zeros(())).to(x.dtype)
    error = (xf - upload.to(torch.float32)).to(x.dtype)
    count = torch.stack([
        mask[:, a:b].sum(dim=1, dtype=torch.int64) if own
        else torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for (a, b), own in zip(bounds, owned)], dim=1)
    return upload, error, count


def sparsify_quantize_ef_segmented_plain(x: torch.Tensor, thresholds, steps,
                                         levels, seeds, offsets):
    """``sparsify_quantize_ef_blocks_plain`` under world 1's map (each
    leaf whole and owned): the dither counter is the column, so leaf l's
    elements draw what a per-leaf call with base = offsets[l] draws.
    Returns (upload, error, count (rows, L) f32).
    """
    upload, error, count = sparsify_quantize_ef_blocks_plain(
        x, thresholds, steps, levels, seeds, offsets, None)
    return upload, error, count.to(torch.float32)


def decode_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      length: int) -> torch.Tensor:
    """Single-token GQA decode attention.

    q: (B, H, D); k, v: (B, S, KV, D); length: number of valid entries.
    Returns (B, H, D) in q's dtype; scores and softmax in f32.
    """
    b, s, kv, d = k.shape
    h = q.shape[1]
    qf = q.to(torch.float32).reshape(b, kv, h // kv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32)) / math.sqrt(d)
    valid = torch.arange(s, device=q.device) < length
    scores = torch.where(valid, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


def decode_attn_partials_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, length: int) -> tuple:
    """``decode_attn_plain``'s partials, all f32, in head order: m (B, H)
    the max of the scaled scores over the valid entries, l (B, H) the sum
    of exp(s - m), acc (B, H, D) the unnormalised output; no valid entry
    gives m = -inf, l = 0 and acc = 0."""
    b, s, kv, d = k.shape
    h = q.shape[1]
    qf = q.to(torch.float32).reshape(b, kv, h // kv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qf,
                          k.to(torch.float32)) / math.sqrt(d)
    valid = torch.arange(s, device=q.device) < length
    scores = torch.where(valid, scores, -torch.inf)
    m = (scores.amax(-1) if s
         else scores.new_full(scores.shape[:-1], -torch.inf))
    p = torch.where(torch.isfinite(m)[..., None],
                    torch.exp(scores - m[..., None]), 0.0)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return m.reshape(b, h), p.sum(-1).reshape(b, h), acc.reshape(b, h, d)


def decode_attn_partials_tol(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, length: int) -> tuple:
    """How far a kernel's (m, l, acc) may lie from
    ``decode_attn_partials_plain``'s on the same inputs: tolerances of the
    partials' shapes, from the rounding that the two can differ by, so
    that a block that drops or adds keys shows.

    Both sum q . k in f32 (the bf16 route's mma accumulates in f32): with
    u = 2^-23 a step (a tensor core may truncate), a score is within D u
    C of its exact value in each, C = sum_d |q_d k_d| / sqrt(D) of the
    row's valid keys at most.  So m is within 2 D u C (and its scale's 2u
    |m|); exp carries twice that into each probability relatively, and a
    sum of S terms adds S u: l within that relative part of l, acc within
    it of sum_j p_j |v_j|.  The bf16 route rounds each probability to
    bf16 (2^-9 relatively) before the product with V: 2^-8 of sum_j p_j
    |v_j| more on acc.  A row with no valid key has tolerances 0."""
    u = 2.0 ** -23
    b, s, kv, d = k.shape
    h = q.shape[1]
    n = min(max(int(length), 0), s)
    qa = q.to(torch.float32).abs().reshape(b, kv, h // kv, d)
    c = (torch.einsum("bkgd,bskd->bkgs", qa,
                      k[:, :n].to(torch.float32).abs()).amax(-1)
         / math.sqrt(d) if n else qa.new_zeros((b, kv, h // kv)))
    m, l, pv = decode_attn_partials_plain(q, k, v.abs(), n)
    fin = torch.isfinite(m)
    score = 2 * d * u * c.reshape(b, h)
    tm = torch.where(fin, score + 2 * u * m.abs(), 0.0)
    rel = torch.where(fin, 2 * score + n * u, 0.0)
    unit = 2.0 ** -8 if q.dtype == torch.bfloat16 else 0.0
    return tm, rel * l, (rel + unit)[..., None] * pv


def ssd_scan_plain(x, a, b, c, chunk: int):
    """Chunked Mamba2 SSD scan: (y (B,S,H,P), final state (B,H,P,N)), f32."""
    from repro_torch.models.mamba2 import ssd_chunked  # mamba2 imports ops

    return ssd_chunked(x, a, b, c, chunk)


def ssd_chunk_cumsum(a, chunk: int):
    """Phase 1: a (B, S, H) -> A (B, nc, Q, H) f64, cumsum within chunks."""
    bsz, s, h = a.shape
    return torch.cumsum(a.double().reshape(bsz, s // chunk, chunk, h), dim=2)


def ssd_cb(b, c, chunk: int):
    """Phase 2: b, c (B, S, N) -> C B^T (B, nc, Q, Q) f32, once per chunk
    (the kernel writes the tiles at or below the diagonal)."""
    bsz, s, n = b.shape
    bf, cf = (t.float().reshape(bsz, s // chunk, chunk, n) for t in (b, c))
    return torch.einsum("bcln,bcsn->bcls", cf, bf)


def ssd_chunk_states(x, b, acum):
    """Phase 3: each chunk's own state sum_s exp(A_last - A_s) x_s b_s^T,
    (B, H, nc, P, N) f32."""
    bsz, nc, q, h = acum.shape
    p, n = x.shape[-1], b.shape[-1]
    decay = torch.exp((acum[:, :, -1:] - acum).float())  # (B, nc, Q, H)
    xd = x.float().reshape(bsz, nc, q, h, p) * decay[..., None]
    return torch.einsum("bcsn,bcshp->bhcpn", b.float().reshape(bsz, nc, q, n), xd)


def ssd_state_pass(states, acum):
    """Phase 4: (the state entering each chunk (B, H, nc, P, N), the final
    state (B, H, P, N))."""
    decay = torch.exp(acum[:, :, -1].float()).permute(0, 2, 1)  # (B, H, nc)
    st = torch.zeros_like(states[:, :, 0])
    prev = []
    for i in range(states.shape[2]):
        prev.append(st)
        st = st * decay[:, :, i, None, None] + states[:, :, i]
    return torch.stack(prev, dim=2), st


def ssd_chunk_out(x, c, cb, acum, prev):
    """Phase 5: y (B, S, H, P) = (C B^T * exp(A_l - A_s), s <= l) X +
    exp(A_l) C state^T, per chunk."""
    bsz, nc, q, h = acum.shape
    p, n = x.shape[-1], c.shape[-1]
    xf = x.float().reshape(bsz, nc, q, h, p)
    cf = c.float().reshape(bsz, nc, q, n)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    diff = (acum[:, :, :, None, :] - acum[:, :, None, :, :]).float()  # l, s
    w = torch.where(causal[None, None, :, :, None], cb[..., None] * torch.exp(diff),
                    torch.zeros((), device=x.device))
    y = torch.einsum("bclsh,bcshp->bclhp", w, xf)
    y_off = torch.einsum("bcln,bhcpn->bclhp", cf, prev)
    y = y + y_off * torch.exp(acum.float())[..., None]
    return y.reshape(bsz, nc * q, h, p)


def ssd_scan_phases(x, a, b, c, chunk: int):
    """The five phases composed: (y (B,S,H,P), final state (B,H,P,N))."""
    q = min(chunk, x.shape[1])
    acum = ssd_chunk_cumsum(a, q)
    prev, final = ssd_state_pass(ssd_chunk_states(x, b, acum), acum)
    return ssd_chunk_out(x, c, ssd_cb(b, c, q), acum, prev), final
