"""Top-k gradient sparsification with error feedback (paper §III-D).

S(x) is magnitude thresholding at the (1 - k/s) quantile of |x|, with k a
per-device tensor:

* ``exact``  — threshold from a full descending sort;
* ``sampled`` — threshold from a strided sample of ~m elements (what the
  training CLI picks above 2M parameters, so ResNet-9 at full width).

The port works on flat (N, s) buffers, one row per device, with the
model's ``TreeLayout`` giving each leaf's columns; the flat column index
is the reference's flat coordinate.  ``sparsify_tree`` sends the mask,
error and count through the fused ``sparsify_ef`` op (the CUDA kernel on
the card) — the same arithmetic the reference computes inline.  Bit
accounting uses the realised count: bits = k_actual * (u + log2 s)
(eq. 7c).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.collectives import all_gather_parts_
from repro_torch.utils.fmath import div


def _ceil_log2_f32(s: int) -> float:
    """ceil(log2(float32(s))) as the reference computes it (in f32)."""
    return float(torch.ceil(torch.log2(torch.tensor(float(s), dtype=torch.float32))))


def bits_for_k(k, s: int, u: int = 32):
    """Upload payload in bits for k selected of s parameters (paper §III-D)."""
    return k * (u + _ceil_log2_f32(s))


def k_for_bits(bits, s: int, u: int = 32):
    """Largest k transmittable within ``bits`` (Proposition 1, bits=tau*A)."""
    return torch.clamp(div(bits, u + _ceil_log2_f32(s)), 0.0, float(s))


def _pick(srt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(srt, -1, idx.to(torch.int64)[..., None])[..., 0]


def threshold_for_k(x_abs: torch.Tensor, k, *, method: str = "exact",
                    sample: int = 65536) -> torch.Tensor:
    """Per-row |x| threshold such that ~k[row] elements of x_abs (N, n) pass."""
    s = x_abs.shape[-1]
    k = torch.clamp(torch.as_tensor(k, dtype=torch.float32,
                                    device=x_abs.device), 0.0, float(s))
    if method == "exact":
        srt = torch.sort(x_abs, dim=-1, descending=True).values
        idx = torch.clamp(torch.floor(k).to(torch.int32) - 1, 0, s - 1)
    elif method == "sampled":
        m = min(sample, s)
        stride = max(s // m, 1)
        srt = torch.sort(x_abs[..., : m * stride : stride], dim=-1,
                         descending=True).values
        idx = torch.clamp(torch.floor(div(k, float(s)) * m).to(torch.int32) - 1,
                          0, m - 1)
    else:
        raise ValueError(f"unknown method {method!r}")
    return torch.where(k < 1.0, torch.inf, _pick(srt, idx))


def _strides(shape: tuple, m: int):
    """The reference's per-dim strides for a ~m-element sample of a leaf
    of ``shape``: leading dims first, largest first, the last dim last;
    None where the whole leaf is the sample."""
    size = math.prod(shape)
    if size <= m or not shape:
        return None
    strides = [1] * len(shape)
    red = size / m
    order = sorted(range(len(shape)),
                   key=lambda i: (i == len(shape) - 1, -shape[i]))
    for i in order:
        if red <= 1.0:
            break
        st = int(min(shape[i], max(1, round(red))))
        strides[i] = st
        red /= st
    return strides


def _strided_sample(leaf: torch.Tensor, m: int) -> torch.Tensor:
    """~m-element |x| sample per row of ``leaf`` (N, *shape) by a
    rectangular strided slice — the reference's ``_strided_sample`` under
    its device vmap, stride for stride."""
    n, shape = leaf.shape[0], tuple(leaf.shape[1:])
    strides = _strides(shape, m)
    if strides is None:
        return leaf.to(torch.float32).abs().reshape(n, -1)
    block = leaf[(slice(None),) + tuple(slice(None, None, st) for st in strides)]
    return block.to(torch.float32).abs().reshape(n, -1)


def sample_abs(x: torch.Tensor, layout, sample: int) -> torch.Tensor:
    """The concatenated per-leaf strided |x| samples of x (N, s)."""
    return torch.cat([_strided_sample(l, m) for l, m in zip(
        layout.leaves(x), leaf_samples(layout, sample))], dim=1)


def leaf_samples(full_layout, sample: int) -> list:
    """``sample_abs``'s per-leaf sample sizes m_l of a ~``sample``
    sample of the whole model."""
    s = full_layout.size
    return [max(int(sample * sz / s), 16) for sz in full_layout.sizes]


def _block_sample_slices(shape, block, m: int):
    """The slices of a leaf's block (per-dim ``block`` slices of the whole
    leaf ``shape``) that the whole leaf's ~m-element strided sample takes:
    on each dim the sampled coordinates 0, st, 2 st, ... in the block."""
    strides = _strides(tuple(shape), m)
    if strides is None:
        return tuple(slice(None) for _ in shape)
    return tuple(slice((-b.start) % st, None, st)
                 for b, st in zip(block, strides))


def block_sample_sizes(full_layout, blocks: list, owned: list,
                       ms: list) -> list:
    """Per leaf, the number of coordinates ``block_samples`` takes from a
    rank's blocks under per-leaf sample sizes ``ms`` (0 where the rank
    does not own the leaf)."""
    return [math.prod(len(range(b.stop - b.start)[q]) for b, q in zip(
        block, _block_sample_slices(shape, block, m))) if own else 0
            for shape, block, own, m in zip(full_layout.shapes, blocks, owned,
                                            ms)]


def block_samples(x: torch.Tensor, full_layout, block_layout, blocks: list,
                  owned: list, ms: list) -> list:
    """A rank's part of each leaf's ~m_l-element strided |x| sample (the
    reference's ``_strided_sample`` of the whole leaf, ``ms`` per leaf):
    x (N, s_r) its flat blocks, ``blocks`` each leaf's per-dim slices of
    the whole leaf, ``owned`` whether its values count here (a leaf every
    rank holds whole counts on one of them).  One (N, w_l) f32 tensor a
    leaf, (N, 0) where the rank does not own it.  The ranks' parts of a
    leaf together hold its whole sample's values."""
    return [leaf[(slice(None),) + _block_sample_slices(shape, block, m)]
            .to(torch.float32).abs().reshape(x.shape[0], -1) if own
            else x.new_zeros((x.shape[0], 0), dtype=torch.float32)
            for shape, block, own, m, leaf in zip(
                full_layout.shapes, blocks, owned, ms,
                block_layout.leaves(x))]


def owned_abs(x: torch.Tensor, block_layout, owned: list) -> list:
    """Each leaf's |x| of a rank's blocks x (N, s_r), (N, n_l) f32, and
    (N, 0) where the rank does not own the leaf: the ranks' parts of a
    leaf together hold its whole magnitudes (exact thresholds)."""
    return [leaf.to(torch.float32).abs().reshape(x.shape[0], -1) if own
            else x.new_zeros((x.shape[0], 0), dtype=torch.float32)
            for leaf, own in zip(block_layout.leaves(x), owned)]


def gather_block_abs(x: torch.Tensor, pl, ms: list | None = None, *,
                     joined: bool = False) -> list:
    """Each leaf's whole |x| values (exact: ``ms`` None) or its whole
    ~m_l-element strided sample (``ms`` per leaf) from a rank's blocks x
    (N, s_r) under its placement ``pl`` (``core/distributed.py::
    Placement``): the rank's owned parts, put together over ``model`` in
    ONE ``all_gather`` with the ranks' widths stripped.  A leaf's values
    come in another order than world 1's, the same once sorted.
    ``joined``: one (N, w) tensor of every leaf's values instead of one a
    leaf (a global threshold's sort)."""
    if ms is None:
        parts = owned_abs(x, pl.layout, pl.owned)
        widths = [[math.prod(b.stop - b.start for b in block) if own else 0
                   for block, own in zip(*peer)] for peer in pl.peers]
    else:
        parts = block_samples(x, pl.full, pl.layout, pl.blocks, pl.owned, ms)
        widths = [block_sample_sizes(pl.full, *peer, ms) for peer in pl.peers]
    if joined:
        parts, widths = [torch.cat(parts, dim=1)], [[sum(w)] for w in widths]
    return all_gather_parts_(parts, pl.model_axis, widths)


def owned_count(x: torch.Tensor, t: torch.Tensor, block_layout, owned: list,
                count) -> torch.Tensor:
    """A rank's int64 count of |x| >= t on the leaves it owns, from the
    ``sparsify_ef`` count of all its blocks x (N, s_r): less the leaves
    another rank counts (summed over ``model`` it is the whole model's)."""
    count = count.to(torch.int64)
    for l, own in zip(block_layout.leaves(x), owned):
        if not own:
            count -= (l.to(torch.float32).abs() >= t.view(
                (-1,) + (1,) * (l.dim() - 1))).flatten(1).sum(
                    dim=1, dtype=torch.int64)
    return count


def block_counters(full_layout, blocks: list, owned: list) -> tuple:
    """The dither counter map of a rank's blocks (``kernels/
    sparsify_ef.py``): per leaf (g0, R, G, owned) such that local column
    c of the leaf's block has its whole-model coordinate g0 + (c // R) *
    G + c % R.  The rules cut at most one dim of a leaf (a mesh axis is
    used once a tensor), so a block is outer x [a0, a1) x inner: R = (a1
    - a0) * inner, G = extent * inner, g0 = the leaf's offset + a0 *
    inner.  A whole leaf's map is (offset, size, size)."""
    out = []
    for off, shape, block, own in zip(full_layout.offsets, full_layout.shapes,
                                      blocks, owned):
        cut = [i for i, (b, d) in enumerate(zip(block, shape))
               if (b.start, b.stop) != (0, d)]
        if len(cut) > 1 or any(b.step not in (None, 1) for b in block):
            raise ValueError(f"a block cut on dims {cut} of a leaf of shape "
                             f"{tuple(shape)}: the counter map takes one")
        size = math.prod(shape)
        if not cut:
            out.append((off, size, size, bool(own)))
            continue
        a = cut[0]
        inner = math.prod(shape[a + 1:])
        b = block[a]
        out.append((off + b.start * inner, (b.stop - b.start) * inner,
                    shape[a] * inner, bool(own)))
    return tuple(out)


def threshold_from_sample(flat: torch.Tensor, s: int, k) -> torch.Tensor:
    """Per-row threshold at which ~k of s coordinates pass, from the
    (N, m) |x| sample ``flat`` (``tree_threshold``'s sampled method)."""
    kf = torch.as_tensor(k, dtype=torch.float32, device=flat.device)
    frac = torch.clamp(div(kf, float(s)), 0.0, 1.0)
    srt = torch.sort(flat, dim=-1, descending=True).values
    m = flat.shape[-1]
    idx = torch.clamp(torch.floor(frac * m).to(torch.int32) - 1, 0, m - 1)
    return torch.where(kf < 1.0, torch.inf, _pick(srt, idx))


def tree_threshold(x: torch.Tensor, layout, k, *, method: str = "exact",
                   sample: int = 65536) -> torch.Tensor:
    """GLOBAL |x| threshold per device across all leaves such that ~k pass
    (the paper treats x_n as one flat vector).  x (N, s), k (N,)."""
    if method == "exact":
        return threshold_for_k(x.to(torch.float32).abs(), k, method="exact")
    return threshold_from_sample(sample_abs(x, layout, sample), layout.size,
                                 k)


def sparsify_tree(x: torch.Tensor, layout, k, *, method: str = "exact",
                  sample: int = 65536):
    """Tree-level S(x) for every device at once: (upload, error, k_actual).

    x (N, s) contiguous, k (N,); one global threshold per device across all
    leaves (``tree_threshold``), then ONE fused sparsify_ef call.
    """
    t = tree_threshold(x, layout, k, method=method, sample=sample)
    return ops.sparsify_ef(x, t.contiguous())


def quantize_values(x: torch.Tensor, layout, bits: int) -> torch.Tensor:
    """Symmetric uniform quantisation of the upload VALUES to ``bits`` bits,
    one scale per leaf and device (round half to even, as ``jnp.round``).
    x (N, s); bits >= 32 is a no-op."""
    if bits >= 32:
        return x
    levels = float(2 ** (bits - 1) - 1)
    out = torch.empty_like(x)
    for src, dst in zip(layout.leaves(x), layout.leaves(out)):
        lf = src.to(torch.float32)
        amax = lf.abs().amax(dim=tuple(range(1, lf.dim())), keepdim=True)
        scale = div(torch.clamp(amax, min=1e-12), levels)
        dst.copy_((torch.round(lf / scale) * scale).to(x.dtype))
    return out
