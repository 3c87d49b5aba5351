"""The ``Compressor`` API: spend a contact-time bit budget on a gradient.

    payload, error, stats = compressor.compress(x, budget_bits, error,
                                                seeds, layout)

The port's codecs run on the whole federation at once: ``x`` and
``error`` are flat (N, s) buffers (one row per device, leaves in flatten
order as ``layout`` gives them), ``budget_bits`` is the (N,) realised
contact capacity ``tau * A(p)``, and ``seeds`` are (N,) int32 dither seeds
for the quantising codecs.  ``payload`` is the dense dequantised upload,
``error`` the new error-feedback memory, and ``stats`` holds (N,) tensors
``k`` (#selected), ``bits`` (realised payload bits), ``b`` (value
bit-width) and ``step`` (the quantisation scale; 1.0 for raw floats).

The reference threads a PRNG key through its codec state; here the caller
draws the seeds (``core.afl.afl_round``) or passes them in (the tests give
the reference's).

**The group contract** (the reference's ``axis``): when each row is
partitioned over the ranks of a ``torch.distributed`` process group (rank
r holds a disjoint slice of every device's columns), pass the group and
the GLOBAL flat size ``s``.  ``strict_threshold`` gathers each rank's
strided sample (exact mode: its magnitudes) over the group before the
sort, so every rank sorts the same block and picks the same threshold;
``quant.tree_amax`` takes the MAX over the group (exact under any split);
``Compressor(group=)`` does both and sums the realised count over the
group, so every rank bills the same k.  With ``group=None`` nothing is
gathered and every value is what it was.

**A model-axis rank** (``core.distributed``'s round on a (data, model)
mesh) passes its ``Placement`` to ``compress`` instead.  ``group=`` does
not serve there: the rank's row holds boxes cut from each leaf (not a
disjoint slice of the flat row), the leaves every rank holds whole are
owned by model index 0, and the reference's sample is strided per whole
leaf, so it is not the concatenation of per-rank samples.  Through the
placement the threshold is read off the gathered parts of each leaf's
whole strided sample (exact mode: the owned magnitudes), the amax is a
MAX over ``model``, the count is the owned leaves' all-reduced, and the
dither counter of each element is its whole-model coordinate (the
blocks' counter map, ``kernels/sparsify_ef.py``): given the same x,
budget and seeds each rank's payload and error are world 1's on its
blocks, bit for bit.  With no placement, or with a model axis of 1,
every value is what it is without one.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.compression import quant as Q
from repro_torch.core.sparsify import (gather_block_abs, leaf_samples,
                                       owned_count, sample_abs)
from repro_torch.kernels import ops
from repro_torch.sharding.collectives import all_reduce_
from repro_torch.utils.device import constant
from repro_torch.utils.fmath import div


def gather_columns(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (..., m) of every rank of ``group``, concatenated along the
    last axis in rank order (the reference's tiled ``all_gather``)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def strict_from(flat: torch.Tensor, k, s: int, method: str) -> torch.Tensor:
    """The strict cutoff of ``strict_threshold`` from ``flat``, the |x|
    values it sorts (exact: all s of them; sampled: the sample)."""
    kf = torch.as_tensor(k, dtype=torch.float32, device=flat.device)
    srt = torch.sort(flat, dim=-1, descending=True).values
    if method == "exact":
        idx = torch.clamp(torch.floor(kf).to(torch.int32), 0, s - 1)
    else:
        frac = torch.clamp(div(kf, float(s)), 0.0, 1.0)
        m = flat.shape[-1]
        idx = torch.clamp(torch.floor(frac * m).to(torch.int32), 0, m - 1)
    picked = torch.gather(srt, -1, idx.to(torch.int64)[..., None])[..., 0]
    t = torch.where(kf < 1.0, torch.inf,
                    torch.where(kf >= float(s), -torch.inf, picked))
    return torch.nextafter(t, torch.full_like(t, torch.inf))


def strict_threshold(x: torch.Tensor, layout, k, *, method: str = "exact",
                     sample: int = 65536, group=None,
                     s: int | None = None, placement=None) -> torch.Tensor:
    """Per-device |x| cutoff whose STRICT-above set has <= floor(k) elements.

    The (k+1)-th order statistic bumped one ulp, so the shared ``>=``-mask
    kernels implement ``> t``: ties can only undershoot.  k >= s selects
    everything (the cutoff is nextafter(-inf, inf)); k < 1 selects nothing.

    ``group``/``s``: the group contract (module docstring).  x holds this
    rank's columns and ``layout`` their leaves; ``s`` is the global size.
    ``placement``: x is a model-axis rank's blocks (module docstring);
    the sample is the whole model's, gathered from the ranks' parts.
    """
    if placement is not None:
        ms = None if method == "exact" else leaf_samples(placement.full,
                                                         sample)
        flat = gather_block_abs(x, placement, ms, joined=True)[0]
        return strict_from(flat, k, placement.full.size, method)
    if s is None:
        s = layout.size
    if method == "exact":
        flat = x.to(torch.float32).abs()
    else:
        flat = sample_abs(x, layout, sample)
    if group is not None:
        flat = gather_columns(flat, group)
    return strict_from(flat, k, s, method)


def placed_amax(xt: torch.Tensor, placement) -> torch.Tensor:
    """``quant.tree_amax`` of a rank's blocks, MAX-reduced over ``model``
    (exact: a whole leaf holds the same values on every rank)."""
    return all_reduce_(Q.tree_amax(xt), placement.model_axis,
                       op=dist.ReduceOp.MAX)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base codec: bit accounting constants + the error-feedback frame.

    ``s`` is the flat model size; every selected coordinate pays
    ``index_bits = ceil(log2 s)`` of position overhead (paper eq. 7c).
    ``method``/``sample`` select exact or sampled thresholding.
    ``group``: a ``torch.distributed`` process group over which each row
    is partitioned (the group contract, module docstring); ``s`` is then
    the global size.  None (the default) for whole rows.
    """

    s: int
    method: str = "exact"
    sample: int = 65536
    error_feedback: bool = True
    group: object = None
    quantize = False  # whether the values ship quantised (with a scale)

    @property
    def index_bits(self) -> int:
        return int(math.ceil(math.log2(max(self.s, 2))))

    def masked_payload(self, xt, t, *, quantize: bool, step=None, levels=None,
                       seeds=None, placement=None):
        """(payload, error, k_actual) under per-device thresholds ``t``: one
        fused op over the (N, s) buffer.  The flat column is the reference's
        dither counter ``base + index``, so ``base`` is 0.  With a
        ``placement`` xt is a rank's blocks: the quantising op is the
        segmented one under the blocks' counter map, with the (N,) values
        broadcast over the leaves, and k_actual the owned leaves' int64
        count (the caller all-reduces it)."""
        if placement is None:
            if quantize:
                return ops.sparsify_quantize_ef(xt, t, step, levels, seeds,
                                                base=0)
            return ops.sparsify_ef(xt, t)
        if not quantize:
            upload, error, count = ops.sparsify_ef(xt, t)
            return upload, error, owned_count(xt, t, placement.layout,
                                              placement.owned, count)
        lay = placement.layout
        wide = (xt.shape[0], len(lay.sizes))
        upload, error, count = ops.sparsify_quantize_ef_blocks(
            xt, *(v[:, None].expand(wide).contiguous()
                  for v in (t, step, levels)),
            seeds, lay.offsets + (lay.size,), placement.counters)
        return upload, error, count.sum(dim=1)

    def check_placement(self, placement) -> None:
        if placement is not None and (self.group is not None
                                      or placement.full.size != self.s):
            raise ValueError(
                f"a placement takes group=None and the whole model's s = "
                f"{placement.full.size} (the codec has group={self.group}, "
                f"s = {self.s})")

    def spend(self, xt, layout, k_target, b, budget_bits, seeds, *,
              quantize: bool, placement=None):
        """Threshold at ~k_target, ship ``b``-bit values, bill the wire.

        Global strict-above threshold, fused payload/error/count, bit
        accounting ``k (b + log2 s) + scale``, and the all-or-nothing
        budget gate: an upload whose realised bits exceed the budget is
        withheld and the error memory keeps the whole signal.  Sampled mode
        first backs the target off by three standard errors of the sample
        quantile count, capped at half the affordable k.  ``placement``: xt
        is a model-axis rank's blocks (module docstring); the count is
        all-reduced over ``model`` before the gate, so that it fires the
        same way on every rank.
        """
        self.check_placement(placement)
        if self.method == "sampled":
            m = float(min(self.sample, self.s))
            rel = torch.clamp(
                3.0 * torch.sqrt(div(float(self.s),
                                     torch.clamp(k_target, min=1.0) * m)),
                max=0.5)
            k_target = torch.floor(torch.clamp(k_target * (1.0 - rel), min=0.0))
        t = strict_threshold(xt, layout, k_target, method=self.method,
                             sample=self.sample, group=self.group, s=self.s,
                             placement=placement)
        if not isinstance(b, torch.Tensor):  # a codec's fixed width
            b = constant(float(b), device=xt.device)
        if quantize:
            levels = torch.broadcast_to(
                Q.quant_levels(b), t.shape).contiguous()
            amax = (Q.tree_amax(xt, group=self.group) if placement is None
                    else placed_amax(xt, placement))
            step = Q.quant_step(amax, levels)
            payload, error, k_actual = self.masked_payload(
                xt, t, quantize=True, step=step, levels=levels, seeds=seeds,
                placement=placement)
            overhead = Q.SCALE_BITS
        else:
            payload, error, k_actual = self.masked_payload(
                xt, t, quantize=False, placement=placement)
            overhead = 0
        if self.group is not None:
            # rank-local popcounts -> the global k every rank bills with
            dist.all_reduce(k_actual, group=self.group)
        if placement is not None:
            k_actual = all_reduce_(k_actual, placement.model_axis).to(
                torch.float32)
        bits = k_actual * (b + self.index_bits) + overhead * (k_actual > 0)
        feasible = (bits <= budget_bits).to(torch.float32)
        # in place and in the payload's dtype (x * 1 and x * 0 round to
        # themselves): no (N, s) f32 temporary at a model's full width
        payload.mul_(feasible[:, None].to(payload.dtype))
        torch.where(feasible[:, None] > 0, error, xt, out=error)
        if not self.error_feedback:
            error = torch.zeros_like(error)
        k_actual = k_actual * feasible
        stats = {
            "k": k_actual,
            "bits": bits * feasible,
            "b": b * (k_actual > 0),
            # the message's quantisation scale; 1.0 on the raw-f32 path
            "step": step if quantize else torch.ones_like(k_actual),
        }
        return payload, error, stats

    def model_collectives(self, clients: int, leaves: int) -> list:
        """The collectives over ``model`` of ``compress`` on a rank's
        blocks (a placement) for ``clients`` rows of a model of ``leaves``
        leaves: (kind, result bytes) each.  ``spend``'s: the threshold's
        gather (each leaf's strided sample of ``sample`` over the model,
        or exact the whole model's magnitudes), the amax's MAX where the
        values ship quantised, and the count's all-reduce."""
        n = clients
        out = [("all-gather", n * 4 * (self.s if self.method == "exact"
                                       else self.sample))]
        if self.quantize:
            out.append(("all-reduce", n * 4))
        return out + [("all-reduce", n * 8)]

    def compress(self, x, budget_bits, error, seeds, layout, placement=None):
        """(payload, error, stats) of x + error under ``budget_bits``;
        ``placement``: x is a model-axis rank's blocks (module
        docstring)."""
        raise NotImplementedError
