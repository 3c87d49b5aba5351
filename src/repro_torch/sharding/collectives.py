"""The ``model`` axis's collectives, differentiable and batchable.

A rank of a ``(data, model)`` mesh holds its block of every parameter leaf
(``sharding/rules.py``) and computes on blocks; these are the named
collectives over its ``model`` group that make the blocks compute the
unsharded function (Megatron-LM's tensor parallelism):

* ``copy_to`` (Megatron's f): the identity forward, an all-reduce of the
  gradient backward; it starts a column-parallel region, whose input every
  rank holds whole and whose gradient each rank has only a part of;
* ``reduce_from`` (g): an all-reduce forward, the identity backward; it
  ends a row-parallel region, whose partial sums add up to the output;
* ``all_sum``: an all-reduce forward and an all-reduce backward, for a
  sum of the ranks' partial sums that every rank goes on to use (the
  whole batch's statistics where each rank holds its rows of a client's
  batch, ``core/afl.py::device_grads``' ``batch_axis``): each rank's
  loss reads the sum, so the sum's gradient is every rank's, and each
  rank's partial sum must take all of it (``reduce_from``'s identity
  backward would keep only the rank's own share);
* ``gather``: the blocks of a leaf put together along ``dim``, for a leaf
  that the rules shard on a dim the layer cannot split its work on; the
  gradient returns to the block, summed over the ranks (``grad="sum"``:
  each rank used the leaf for its own part of the work) or as it is
  (``grad="slice"``: every rank did the whole work).

``all_reduce_`` and ``all_gather_`` are the same collectives outside the
gradient (the distributed round's norms, counts and threshold samples;
``all_gather_parts_`` gathers parts whose widths differ over the ranks);
``agree`` checks that every rank holds the same tensor (the MoE routing's
checksums), a check outside the computed function that is not counted.
Each is a ``torch.autograd.Function`` with ``setup_context`` and a
``vmap`` rule, so that it works under ``torch.func.vmap(torch.func.grad)``
(the training gradient over a rank's clients, ``core/afl.py::
device_grads``) and inside ``models/remat.py``'s checkpoint: c10d's
collectives have no batching rule of their own, and the rule runs one
collective over every client's values at once (an all-reduce is
elementwise; the ranks hold the same number of clients).  NCCL on the
card, gloo on the CPU.  ``ModelAxis.counts`` counts each kind of
collective and its bytes, so the plan's numbers can be read off a run;
on a meta tensor a collective is counted and sends nothing, so a model
run on the meta device counts its own (``launch/roofline.py``).

``merge_partials`` and ``merge_softmax`` put together, outside the
gradient, the partial attentions of a serve cache whose slots are split
over the ranks of an axis (``combine`` is the merge itself, over a
stacked dim): over ``model`` where the rules cut the cache's ``head_dim``
(the port cuts its slots, ``sharding/rules.py::model_slots``), over a
mesh's ``data`` group (``launch/mesh.py::ClientMesh.data_axis``) where a
decode's batch does not divide it.  ``counts_before`` gives each rank
the per-expert counts of the ranks before it in an MoE dispatch group
that spans ranks (a serve step's data ranks, or the ranks a training
client's batch is split over), outside the gradient and under ``vmap``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class ModelAxis:
    """One rank's view of the ``model`` axis: its group, its index on the
    axis and the axis's size."""

    group: object
    rank: int
    size: int
    counts: dict = dataclasses.field(default_factory=dict)
    # None, or the checks run over the axis by name (``agree``'s callers,
    # the MoE routing's): each counted where it passed; the caller turns
    # them on (a dict) only outside the gradient and outside ``vmap``
    checks: dict | None = None

    def count(self, kind: str, t: torch.Tensor) -> None:
        n, b = self.counts.get(kind, (0, 0))
        self.counts[kind] = (n + 1, b + t.numel() * t.element_size())


def _all_reduce(x: torch.Tensor, axis: ModelAxis, op=dist.ReduceOp.SUM):
    y = x.contiguous().clone()
    axis.count("all-reduce", y)
    if not y.is_meta:  # a meta tensor (the plan's count) is counted alone
        dist.all_reduce(y, op=op, group=axis.group)
    return y


def _all_gather(x: torch.Tensor, axis: ModelAxis, dim: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    axis.count("all-gather", x)
    if not x.is_meta:
        dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, axis: ModelAxis, dim: int):
    per = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * per, per)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.axis), None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _Copy.apply(x, axis), in_dims[0]


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.axis), None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _Reduce.apply(x, axis), in_dims[0]


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.axis), None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _Sum.apply(x, axis), in_dims[0]


class _Before(torch.autograd.Function):
    @staticmethod
    def forward(counts, axis):
        # every rank's counts on a new leading dim (a batched tensor's
        # clients ride along), those of the ranks before this one summed
        return _all_gather(counts[None], axis, 0)[:axis.rank].sum(0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, counts, axis):
        return _Before.apply(counts, axis), in_dims[0]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim, grad):
        return _all_gather(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.axis, ctx.dim, ctx.grad = inputs

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = _Reduce.apply(g, ctx.axis)
        return _block(g, ctx.axis, ctx.dim), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, dim, grad):
        bd = in_dims[0]
        if bd is None:
            return _Gather.apply(x, axis, dim, grad), None
        x = x.movedim(bd, 0)
        return _Gather.apply(x, axis, dim % (x.dim() - 1) + 1, grad), 0


def copy_to(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """Megatron's f: the identity forward, all-reduce backward."""
    return x if axis is None or axis.size == 1 else _Copy.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """Megatron's g: all-reduce forward, the identity backward."""
    return x if axis is None or axis.size == 1 else _Reduce.apply(x, axis)


def all_sum(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """The sum of every rank's ``x``: all-reduce forward, all-reduce
    backward (the module's docstring)."""
    return x if axis is None or axis.size == 1 else _Sum.apply(x, axis)


def gather(x: torch.Tensor, axis: ModelAxis | None, dim: int,
           grad: str = "sum") -> torch.Tensor:
    """Every rank's block of a leaf, put together along ``dim``."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad {grad!r} is 'sum' or 'slice'")
    if axis is None or axis.size == 1:
        return x
    return _Gather.apply(x, axis, dim, grad)


def feed(x: torch.Tensor, axis: ModelAxis | None, dim: int, block: bool,
         split: bool) -> torch.Tensor:
    """``x`` whole, as a layer of the channel-parallel vision and
    trajectory models takes its input: a ``block`` of ``x`` (the rank's
    channels along ``dim``) gathered, its gradient summed over the ranks
    when the layer is ``split`` (each rank computes its part of the
    outputs from it) or sliced when every rank runs the whole layer; a
    whole ``x`` entering a split layer through ``copy_to``."""
    if block:
        return gather(x, axis, dim, "sum" if split else "slice")
    return copy_to(x, axis) if split else x


def all_reduce_(x: torch.Tensor, axis: ModelAxis | None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` all-reduced over the axis in place, outside the gradient."""
    if axis is not None and axis.size > 1:
        axis.count("all-reduce", x)
        dist.all_reduce(x, op=op, group=axis.group)
    return x


def all_gather_(x: torch.Tensor, axis: ModelAxis | None,
                dim: int) -> torch.Tensor:
    """Every rank's ``x`` put together along ``dim``, outside the
    gradient."""
    if axis is None or axis.size == 1:
        return x
    return _all_gather(x, axis, dim)


def all_gather_parts_(parts: list, axis: ModelAxis | None,
                      widths: list) -> list:
    """Each rank's (N, w) parts (one a leaf, say) put together over the
    axis in one ``all_gather``, outside the gradient: ``widths[m]`` the
    parts' widths on model index m (the ranks' parts differ in width, so
    each is padded to the widest rank's total and the pads stripped).
    Returns one (N, sum over m of widths[m][i]) tensor a part, the ranks'
    columns in model-index order."""
    if axis is None or axis.size == 1:
        return list(parts)
    n = parts[0].shape[0]
    mine = torch.cat(parts, dim=1)
    width = max(sum(w) for w in widths)
    pad = mine.new_zeros((n, width))
    pad[:, :mine.shape[1]] = mine
    got = _all_gather(pad, axis, 0).view(axis.size, n, width)
    out = [[] for _ in parts]
    for m, ws in enumerate(widths):
        at = 0
        for i, w in enumerate(ws):
            out[i].append(got[m, :, at:at + w])
            at += w
    return [torch.cat(o, dim=1) for o in out]


def agree(x: torch.Tensor, axis: ModelAxis | None) -> bool:
    """Whether every rank of the axis holds the same ``x`` (all-gathered
    outside the gradient and outside ``counts``: a check, not part of the
    function the ranks compute)."""
    if axis is None or axis.size == 1:
        return True
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return all(torch.equal(p, parts[0]) for p in parts[1:])


def combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> tuple:
    """Partial softmax attentions stacked on a leading dim put together:
    ``m`` (P, ...) each part's max of its scores, ``l`` the sum of exp(s -
    m), ``o`` (P, ..., D) the unnormalised output, all f32 -> the whole's
    (m, l, o) in the same convention.  A part whose entries are all
    masked (``m`` = -inf) adds nothing; if every part's are, m = -inf and
    l = o = 0, with no NaN."""
    top = m.amax(0)
    w = torch.where(torch.isfinite(m), torch.exp(m - top), 0.0)
    return top, (w * l).sum(0), (w[..., None] * o).sum(0)


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   axis: ModelAxis | None) -> tuple:
    """The partial attention over every rank's entries from each rank's
    over its own (``combine``'s convention): one all-gather of the three,
    then every rank combines them in rank order, so each holds the same
    (m, l, o)."""
    if axis is None or axis.size == 1:
        return m, l, o
    part = torch.cat([m[..., None], l[..., None], o], dim=-1)
    got = _all_gather(part[None], axis, 0)
    return combine(got[..., 0], got[..., 1], got[..., 2:])


def merge_softmax(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                  axis: ModelAxis | None) -> torch.Tensor:
    """The attention over every rank's slots from each rank's partial
    one over its own (``merge_partials``), normalised: o / l."""
    m, l, o = merge_partials(m, l, o, axis)
    return o / torch.clamp(l[..., None], min=1e-30)


def counts_before(counts: torch.Tensor,
                  axis: ModelAxis | None) -> torch.Tensor:
    """The sum of ``counts`` over the ranks before this one on the axis
    (zeros on rank 0): one all-gather, outside the gradient; under
    ``vmap`` one for every client at once."""
    if axis is None or axis.size == 1:
        return torch.zeros_like(counts)
    return _Before.apply(counts, axis)
