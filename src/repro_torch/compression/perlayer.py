"""Per-layer bit budgets: the (k_l, b_l) split by greedy water-filling.

The global joint codec (``joint.solve_kb``) spends one (k, b) pair on the
whole message; here the contact budget ``B = tau * A(p)`` is split across
the L leaves of the parameter tree, each with its own scale, keep count
and bit-width.  Leaf l holds an energy fraction ``e_l`` of the signal;
spending ``A_l`` bits on it at width ``b`` keeps at least a

    kappa_l(b) = min(1, A_l / (s_l (b + lambda)))        lambda = ceil(log2 s)

fraction of its coordinates, each surviving quantisation with quality
``1 - eps(b)``, ``eps(b) = 4^{-(b-1)}/3``; the objective is the retained
useful energy ``sum_l e_l kappa_l(b_l) (1 - eps(b_l))``.  Below saturation
the per-bit density is ``(e_l/s_l) (1-eps(b))/(b+lambda)``, so one width
``b0`` serves every unsaturated leaf and the program is a fractional
knapsack: fill leaves in decreasing ``e_l/s_l`` up to their
b0-saturation cost ``s_l (b0 + lambda)``; budget left once every leaf is
full is spread size-proportionally and each leaf re-solves its width in
closed form.  The solver returns whichever of {greedy, uniform
size-proportional split} scores higher, so it never scores below the
uniform split.  Each shipping leaf pays its own fp32 scale: the solver
works against ``avail = B - 32 L`` and guarantees

    sum_l k_l (b_l + lambda) + 32 |{l : k_l > 0}|  <=  B.

The derivation is in the reference's ``compression/perlayer.py``, which
runs it per device; here every function is batched over the N rows of the
federation (energies, budgets and the results are (N, L) or (N,)).  Sums
over leaves and the cumulative sum of the knapsack run leaf by leaf, in
the reference's order, so that the float results are the reference's.
``compress_per_layer`` quantises all leaves of all devices in ONE launch
of the segmented ``sparsify_quantize_ef`` kernel (per-(row, leaf)
threshold, step and levels); the dither counter is the flat column, which
is the reference's ``base + index within leaf`` (on a model-axis rank's
blocks, the counter map's whole-model coordinate).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.compression import quant as Q
from repro_torch.compression.base import strict_from, strict_threshold
from repro_torch.core.sparsify import gather_block_abs
from repro_torch.kernels import ops
from repro_torch.sharding.collectives import all_reduce_
from repro_torch.utils.device import constant
from repro_torch.utils.fmath import div
from repro_torch.utils.tree import TreeLayout


def eps_b(b) -> torch.Tensor:
    """Quantisation-noise energy fraction at width b (see joint.py)."""
    b = torch.as_tensor(b, dtype=torch.float32)
    return div(torch.pow(4.0, -(b - 1.0)), 3.0)


def _fold(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (the reference's order)."""
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def _cumfold(t: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis, left to right."""
    out = [t[..., 0]]
    for i in range(1, t.shape[-1]):
        out.append(out[-1] + t[..., i])
    return torch.stack(out, dim=-1)


def _sizes(sizes, device) -> torch.Tensor:
    return constant([float(n) for n in sizes], device=device)


def _columns(x: torch.Tensor, layout):
    """Each leaf's columns of x (N, s), as (N, n_l) views."""
    return [x[:, off:off + n] for off, n in zip(layout.offsets, layout.sizes)]


def leaf_energies(x: torch.Tensor, layout) -> torch.Tensor:
    """Per-leaf signal energies ||x_l||^2 of x (N, s): (N, L)."""
    return torch.stack([l.to(torch.float32).square().sum(dim=-1)
                        for l in _columns(x, layout)], dim=-1)


def split_score(k, b, sizes, energies) -> torch.Tensor:
    """Retained-useful-energy score of a per-leaf allocation, per row:
    ``sum_l e_l * min(k_l/s_l, 1) * (1 - eps(b_l))`` with e_l the
    normalised energy fractions.  k, b, energies (N, L) -> (N,)."""
    sz = _sizes(sizes, energies.device)
    e = energies / torch.clamp(_fold(energies), min=1e-30)[:, None]
    return _fold(e * torch.clamp(k / sz, 0.0, 1.0) * (1.0 - eps_b(b)))


def _solve_avail(avail, sz, index_bits: int, bg):
    """Closed-form (k, b) per leaf given each leaf's own budget slice:
    avail (N, L), sz (L,), bg (G,) -> k, b (N, L)."""
    lam = float(index_bits)
    kappa = torch.clamp(avail[..., None] / (sz[:, None] * (bg + lam)),
                        0.0, 1.0)
    score = kappa * (1.0 - eps_b(bg))
    b = bg[torch.argmax(score, dim=-1)]
    k = torch.floor(torch.minimum(torch.clamp(avail / (b + lam), min=0.0),
                                  sz))
    return k, b


def _avail(budget_bits, num: int) -> torch.Tensor:
    return torch.clamp(budget_bits.to(torch.float32) - Q.SCALE_BITS * num,
                       min=0.0)


def uniform_split(budget_bits, sizes, index_bits: int, b_grid):
    """The single-(k, b) strategy as a per-leaf allocation: size-
    proportional shares of ``avail = B - 32 L``, one common width.
    budget_bits (N,) -> k, b (N, L)."""
    dev = budget_bits.device
    sz = _sizes(sizes, dev)
    bg = constant(b_grid, device=dev)
    avail = _avail(budget_bits, len(sizes))
    return _solve_avail(avail[:, None] * sz / _fold(sz), sz, index_bits, bg)


def solve_kb_per_leaf(budget_bits, sizes, energies, index_bits: int, b_grid):
    """Greedy water-filling (k_l, b_l) split of each row's budget.

    budget_bits (N,); sizes: the L leaf sizes; energies (N, L) (any
    positive scale).  Returns float (N, L) tensors ``(k, b)`` with ``b``
    from ``b_grid`` and the bit accounting of the module docstring.
    """
    dev = budget_bits.device
    sz = _sizes(sizes, dev)
    bg = constant(b_grid, device=dev)
    lam = float(index_bits)
    avail = _avail(budget_bits, len(sizes))

    # marginal-density-optimal width: common to every unsaturated leaf
    b0 = bg.index_select(
        0, torch.argmax(div(1.0 - eps_b(bg), bg + lam))[None])

    # fractional-knapsack fill in decreasing energy-per-coordinate order
    # (a stable sort: zero-energy leaves tie and keep their leaf order)
    density = energies / torch.clamp(_fold(energies), min=1e-30)[:, None] / sz
    order = torch.argsort(-density, dim=-1, stable=True)
    cap = sz * (b0 + lam)  # b0-saturation cost per leaf
    cap_sorted = cap[order]
    cum = _cumfold(cap_sorted)
    alloc_sorted = torch.minimum(
        torch.clamp(avail[:, None] - (cum - cap_sorted), min=0.0), cap_sorted)
    alloc = torch.zeros_like(alloc_sorted).scatter(-1, order, alloc_sorted)
    # leftover exists only once every leaf is b0-saturated: spread it
    # size-proportionally and let the per-leaf re-solve buy wider values
    leftover = torch.clamp(avail - _fold(alloc), min=0.0)
    alloc = alloc + leftover[:, None] * sz / _fold(sz)

    k_g, b_g = _solve_avail(alloc, sz, index_bits, bg)
    # constructive guarantee: never score below the uniform split
    k_u, b_u = uniform_split(budget_bits, sizes, index_bits, b_grid)
    greedy_wins = (split_score(k_g, b_g, sizes, energies)
                   >= split_score(k_u, b_u, sizes, energies))[:, None]
    return (torch.where(greedy_wins, k_g, k_u),
            torch.where(greedy_wins, b_g, b_u))


def placed_energies(xt: torch.Tensor, placement) -> torch.Tensor:
    """Per-leaf energies of a rank's blocks: the owned blocks' squares
    summed, all-reduced over ``model`` (N, L)."""
    e = torch.stack([
        l.to(torch.float32).square().sum(dim=-1) if own
        else l.new_zeros(l.shape[0], dtype=torch.float32)
        for l, own in zip(_columns(xt, placement.layout), placement.owned)],
        dim=-1)
    return all_reduce_(e, placement.model_axis)


def compress_per_layer(comp, xt, layout, budget_bits, seeds, placement=None,
                       energies=None):
    """The per-leaf compression pass behind ``JointCompressor(per_layer=
    True)``: xt (N, s) (signal + error memory) -> (payload, error, stats).

    Each (row, leaf) gets its own strict threshold (with the sampled-mode
    three-standard-error backoff of ``Compressor.spend``, scaled to the
    leaf's sample share), its own quantisation scale and its
    solver-assigned width; one segmented kernel launch quantises them
    all.  The budget gate is all-or-nothing on the bits summed over
    leaves, as in ``spend``.

    ``placement``: xt is a model-axis rank's blocks (``base.py``'s module
    docstring).  The solver sees the whole leaves' sizes and energies
    (the owned blocks' squares, all-reduced over ``model``: their float
    order is not world 1's single reduction); each leaf's threshold comes
    from its whole strided sample (exact: magnitudes), every leaf's parts
    gathered in one ``all_gather``; its amax is a MAX and its count the
    owned blocks' all-reduced over ``model``; the kernel runs under the
    blocks' counter map.  ``energies``: (N, L) energies to use instead
    of xt's (a test feeds world 1's to hold the rest bit for bit).
    """
    comp.check_placement(placement)
    full = layout if placement is None else placement.full
    sizes = full.sizes
    if energies is None:
        energies = (leaf_energies(xt, layout) if placement is None
                    else placed_energies(xt, placement))
    k_l, b_l = solve_kb_per_leaf(budget_bits, sizes, energies,
                                 comp.index_bits, comp.b_grid)
    lam = float(comp.index_bits)
    m_leaf = [max(min(int(comp.sample * n / max(comp.s, 1)), n), 16)
              for n in sizes]
    k_t = []
    for i, n in enumerate(sizes):
        ki = k_l[:, i]
        if comp.method == "sampled":
            rel = torch.clamp(
                3.0 * torch.sqrt(div(float(n),
                                     torch.clamp(ki, min=1.0)
                                     * float(m_leaf[i]))),
                max=0.5)
            ki = torch.floor(torch.clamp(ki * (1.0 - rel), min=0.0))
        k_t.append(ki)
    levels = Q.quant_levels(b_l)
    if placement is None:
        ts, amax = [], []
        for i, leaf in enumerate(_columns(xt, layout)):
            one = TreeLayout(((f"leaf{i}",),), (layout.shapes[i],))
            ts.append(strict_threshold(leaf, one, k_t[i], method=comp.method,
                                       sample=m_leaf[i]))
            amax.append(Q.tree_amax(leaf))
        amax = torch.stack(amax, dim=-1)
        upload, error, cnt = ops.sparsify_quantize_ef_segmented(
            xt, torch.stack(ts, dim=-1), Q.quant_step(amax, levels), levels,
            seeds, layout.offsets + (layout.size,))
    else:
        flats = gather_block_abs(
            xt, placement, None if comp.method == "exact" else m_leaf)
        ts = [strict_from(f, ki, n, comp.method)
              for f, ki, n in zip(flats, k_t, sizes)]
        amax = all_reduce_(torch.stack(
            [Q.tree_amax(leaf) for leaf in _columns(xt, placement.layout)],
            dim=-1), placement.model_axis, op=dist.ReduceOp.MAX)
        lay = placement.layout
        upload, error, cnt = ops.sparsify_quantize_ef_blocks(
            xt, torch.stack(ts, dim=-1), Q.quant_step(amax, levels), levels,
            seeds, lay.offsets + (lay.size,), placement.counters)
        cnt = all_reduce_(cnt, placement.model_axis).to(torch.float32)
    # accumulated leaf by leaf, as the reference's loop does
    bits = k_total = b_weighted = torch.zeros_like(budget_bits)
    for i in range(len(sizes)):
        c, b = cnt[:, i], b_l[:, i]
        bits = bits + c * (b + lam) + Q.SCALE_BITS * (c > 0)
        k_total = k_total + c
        b_weighted = b_weighted + c * b
    feasible = (bits <= budget_bits).to(torch.float32)
    # in place, as ``Compressor.spend``: no (N, s) temporary at full width
    payload = upload.mul_(feasible[:, None].to(upload.dtype))
    torch.where(feasible[:, None] > 0, error, xt, out=error)
    if not comp.error_feedback:
        error = torch.zeros_like(error)
    k_total = k_total * feasible
    stats = {
        "k": k_total,
        "bits": bits * feasible,
        # realised selection-weighted mean width (per-leaf widths differ)
        "b": torch.where(k_total > 0,
                         b_weighted / torch.clamp(k_total, min=1.0),
                         0.0) * feasible,
        # per-leaf scales don't fit a single-step wire header: 0 tells an
        # encoder to fall back to raw-f32 codes
        "step": torch.zeros_like(k_total),
    }
    return payload, error, stats
