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
gathered and every value is what it was.  ``core.distributed`` shards the
client axis instead (whole rows on a rank) and needs none of this.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.compression import quant as Q
from repro_torch.core.sparsify import sample_abs
from repro_torch.kernels import ops
from repro_torch.utils.device import constant
from repro_torch.utils.fmath import div


def gather_columns(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (..., m) of every rank of ``group``, concatenated along the
    last axis in rank order (the reference's tiled ``all_gather``)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def strict_threshold(x: torch.Tensor, layout, k, *, method: str = "exact",
                     sample: int = 65536, group=None,
                     s: int | None = None) -> torch.Tensor:
    """Per-device |x| cutoff whose STRICT-above set has <= floor(k) elements.

    The (k+1)-th order statistic bumped one ulp, so the shared ``>=``-mask
    kernels implement ``> t``: ties can only undershoot.  k >= s selects
    everything (the cutoff is nextafter(-inf, inf)); k < 1 selects nothing.

    ``group``/``s``: the group contract (module docstring).  x holds this
    rank's columns and ``layout`` their leaves; ``s`` is the global size.
    """
    if s is None:
        s = layout.size
    kf = torch.as_tensor(k, dtype=torch.float32, device=x.device)
    if method == "exact":
        flat = x.to(torch.float32).abs()
        if group is not None:
            flat = gather_columns(flat, group)
        srt = torch.sort(flat, dim=-1, descending=True).values
        idx = torch.clamp(torch.floor(kf).to(torch.int32), 0, s - 1)
    else:
        flat = sample_abs(x, layout, sample)
        if group is not None:
            flat = gather_columns(flat, group)
        srt = torch.sort(flat, dim=-1, descending=True).values
        frac = torch.clamp(div(kf, float(s)), 0.0, 1.0)
        m = flat.shape[-1]
        idx = torch.clamp(torch.floor(frac * m).to(torch.int32), 0, m - 1)
    picked = torch.gather(srt, -1, idx.to(torch.int64)[..., None])[..., 0]
    t = torch.where(kf < 1.0, torch.inf,
                    torch.where(kf >= float(s), -torch.inf, picked))
    return torch.nextafter(t, torch.full_like(t, torch.inf))


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

    @property
    def index_bits(self) -> int:
        return int(math.ceil(math.log2(max(self.s, 2))))

    def masked_payload(self, xt, t, *, quantize: bool, step=None, levels=None,
                       seeds=None):
        """(payload, error, k_actual) under per-device thresholds ``t``: one
        fused op over the (N, s) buffer.  The flat column is the reference's
        dither counter ``base + index``, so ``base`` is 0."""
        if quantize:
            return ops.sparsify_quantize_ef(xt, t, step, levels, seeds, base=0)
        return ops.sparsify_ef(xt, t)

    def spend(self, xt, layout, k_target, b, budget_bits, seeds, *,
              quantize: bool):
        """Threshold at ~k_target, ship ``b``-bit values, bill the wire.

        Global strict-above threshold, fused payload/error/count, bit
        accounting ``k (b + log2 s) + scale``, and the all-or-nothing
        budget gate: an upload whose realised bits exceed the budget is
        withheld and the error memory keeps the whole signal.  Sampled mode
        first backs the target off by three standard errors of the sample
        quantile count, capped at half the affordable k.
        """
        if self.method == "sampled":
            m = float(min(self.sample, self.s))
            rel = torch.clamp(
                3.0 * torch.sqrt(div(float(self.s),
                                     torch.clamp(k_target, min=1.0) * m)),
                max=0.5)
            k_target = torch.floor(torch.clamp(k_target * (1.0 - rel), min=0.0))
        t = strict_threshold(xt, layout, k_target, method=self.method,
                             sample=self.sample, group=self.group, s=self.s)
        if not isinstance(b, torch.Tensor):  # a codec's fixed width
            b = constant(float(b), device=xt.device)
        if quantize:
            levels = torch.broadcast_to(
                Q.quant_levels(b), t.shape).contiguous()
            step = Q.quant_step(Q.tree_amax(xt, group=self.group), levels)
            payload, error, k_actual = self.masked_payload(
                xt, t, quantize=True, step=step, levels=levels, seeds=seeds)
            overhead = Q.SCALE_BITS
        else:
            payload, error, k_actual = self.masked_payload(xt, t, quantize=False)
            overhead = 0
        if self.group is not None:
            # rank-local popcounts -> the global k every rank bills with
            dist.all_reduce(k_actual, group=self.group)
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

    def compress(self, x, budget_bits, error, seeds, layout):
        raise NotImplementedError
