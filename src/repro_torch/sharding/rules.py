"""Parameter specs, their initialisation and the logical-axis sharding
rules (the port of ``repro/sharding/rules.py``).

Initialisation (``:111-146`` of the reference), with every init kind and
dtype of the reference.  Leaves are drawn from one ``torch.Generator`` in
flatten order (sorted keys) with the reference's distributions: N(0,
1/fan_in) * scale for ``normal`` (fan_in is ``shape[0]``, which for a
stacked leaf is the layer count, as in the reference), N(0, 0.02^2) for
``small``, N(0, 1) for ``embed``, ``scale`` for ``const``, constants for
``zeros`` / ``ones``, and for an int8 leaf (quantised expert weights)
clip(round(48 N(0, 1)), -127, 127).  Draws are made on the generator's
device (a CUDA generator keeps a 30B-parameter init off the host) and
then moved to ``device``; a leaf of more than ``DRAW_CHUNK`` values is
drawn in blocks of rows, so that its f32 draw never needs more than one
block beside the leaf.  ``init_params(blocks=)`` keeps only a rank's
block of each leaf from the same draws, so a sharded model holds the
unsharded one's weights without ever holding a whole leaf.
The draws differ from ``jax.random``'s; tests that need the reference's
weights carry them over with ``models.registry.load_params``.

The rules (``:21-103, 149-189``).  Every parameter dim carries a logical
name (``embed``, ``heads``, ``mlp``, ``vocab``, ...); a rule table maps
each name to ordered candidate mesh axes, and ``logical_to_pspec`` takes
the first candidate that exists in the mesh, divides the dim and is not
used by another dim of the tensor (so 28 heads on a model axis of 16 fall
back to ``head_dim``).  A spec is a tuple with one entry per dim (``None``,
an axis name, or a tuple of names), trailing ``None``s dropped: exactly
``tuple(PartitionSpec)``.  A mesh is anything that names its axes' sizes:
a mapping, ``launch.mesh.ClientMesh`` (``axis_sizes``), or an object with
``axis_names`` and ``devices.shape``.  ``local_block`` cuts a rank's block
out of a leaf and ``assemble`` puts the leaf back together from every
rank's block.  ``serve_split`` and ``data_blocks`` read a serve step's
``data`` axis off ``RULES_SERVE``: the batch's rows where they divide,
else a cache's slots (long_500k at batch 1), else neither.  ``model_slots``
is where a serve cache's slots go on ``model``: where the rules cut its
``head_dim`` there, the port cuts its slots instead (the same bytes a
card, and each rank's q . k a whole dot product).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
DRAW_CHUNK = 2**30  # values: larger leaves are drawn block by block


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


@dataclasses.dataclass
class ParamSpec:
    shape: Tuple[int, ...]
    dims: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | const | embed | small
    scale: float = 1.0
    dtype: Optional[str] = None  # override param dtype


def _draw(gen: torch.Generator, shape, std: float, scale: float,
          dt: torch.dtype, device) -> torch.Tensor:
    """N(0, 1) * std * scale drawn in f32 on the generator's device, as
    ``dt`` on ``device`` (int8: clip(round(48 N(0, 1)), -127, 127))."""
    vals = torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    if dt == torch.int8:
        return torch.clamp(torch.round(vals * 48.0), -127, 127).to(
            device=device, dtype=dt)
    return (vals * std * scale).to(device=device, dtype=dt)


def _init_leaf(gen: torch.Generator, spec: ParamSpec, dtype: torch.dtype,
               device, block: Optional[tuple] = None) -> torch.Tensor:
    """The leaf, or with ``block`` (one slice a dim) its block: the same
    draws, of which only the block is kept."""
    dt = torch_dtype(spec.dtype) if spec.dtype else dtype
    block = block or tuple(slice(0, n) for n in spec.shape)
    bshape = tuple(b.stop - b.start for b in block)
    whole = bshape == tuple(spec.shape)
    if spec.init == "zeros":
        return torch.zeros(bshape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(bshape, dtype=dt, device=device)
    if spec.init == "const":
        return torch.full(bshape, spec.scale, dtype=dt, device=device)
    if spec.init == "embed":
        std = 1.0
    elif spec.init == "small":
        std = 0.02
    elif spec.init == "normal":
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else spec.shape[-1]
        std = (1.0 / max(fan_in, 1)) ** 0.5
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    n = math.prod(spec.shape)
    if n <= DRAW_CHUNK or len(spec.shape) < 2:
        full = _draw(gen, spec.shape, std, spec.scale, dt, device)
        return full if whole else full[block].clone()
    out = torch.empty(bshape, dtype=dt, device=device)
    rows = max(1, DRAW_CHUNK * spec.shape[0] // n)
    r0, r1 = block[0].start, block[0].stop
    for start in range(0, spec.shape[0], rows):
        stop = min(start + rows, spec.shape[0])
        vals = _draw(gen, (stop - start,) + tuple(spec.shape[1:]), std,
                     spec.scale, dt, device)
        lo, hi = max(start, r0), min(stop, r1)
        if lo < hi:
            out[lo - r0:hi - r0].copy_(
                vals[(slice(lo - start, hi - start),) + block[1:]])
    return out


def init_params(specs, gen: torch.Generator, dtype=torch.float32,
                device="cpu", blocks=None) -> dict:
    """Initialise a nested dict of ParamSpec into tensors on ``device``;
    ``blocks`` (a tree of per-dim slice tuples, ``block_tree``'s) keeps
    each leaf's block only, from the same draws."""
    paths, leaves = tree_flatten(specs)
    bl = [None] * len(leaves) if blocks is None else tree_flatten(blocks)[1]
    arrs = [_init_leaf(gen, s, torch_dtype(dtype), device, b)
            for s, b in zip(leaves, bl)]
    return tree_unflatten(paths, arrs)


# ---------------------------------------------------------------------------
# The logical-axis rules
# ---------------------------------------------------------------------------

# Ordered candidates per logical axis.  Tuples may name several mesh axes
# (sharded over their product); ``None`` is explicitly unsharded.
Rules = Mapping[str, Sequence[Optional[Tuple[str, ...]]]]

# Training (the distributed AFL round): ``data`` is the client axis
RULES_TRAIN: Rules = {
    "client": [("data",)],
    "batch": [("pod", "data"), ("data",)],
    "layers": [None],
    "vocab": [("model",)],
    "embed": [None],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [("model",)],
    "mlp": [("model",)],
    "experts": [("model",)],
    "expert_mlp": [("model",)],
    "ssm_heads": [("model",)],
    "ssm_state": [None],
    "ssm_inner": [("model",)],
    "conv": [None],
    "seq": [None],
    "pos": [None],
}

# Serving (prefill and decode): ``data`` shards the batch (or a long
# cache's sequence)
RULES_SERVE: Rules = {
    "client": [None],
    "batch": [("pod", "data"), ("data",), None],
    "layers": [None],
    "vocab": [("model",)],
    "embed": [None],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [("model",)],
    "mlp": [("model",)],
    "experts": [("model",)],
    "expert_mlp": [("model",)],
    "ssm_heads": [("model",)],
    "ssm_state": [None],
    "ssm_inner": [("model",)],
    "conv": [None],
    "seq": [("data",), None],  # long-context KV cache: sequence-parallel
    "pos": [None],
}

# the client axis over (pod, data), as the train step's state takes it
RULES_TRAIN_CLIENT: Rules = dict(RULES_TRAIN, client=[("pod", "data"),
                                                      ("data",)])


def axis_sizes(mesh) -> dict:
    """The mesh's axis sizes by name, in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if hasattr(mesh, "axis_names") and hasattr(mesh, "devices"):
        return dict(zip(mesh.axis_names, mesh.devices.shape))
    return dict(mesh.axis_sizes)


def logical_to_pspec(dims: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                     rules: Rules, mesh) -> tuple:
    """Resolve one tensor's logical dims to a spec."""
    if len(dims) != len(shape):
        raise ValueError(f"dims {dims} do not match shape {shape}")
    used: set = set()
    out = []
    sizes = axis_sizes(mesh)
    for name, size in zip(dims, shape):
        chosen = None
        for cand in rules.get(name or "", [None]):
            if cand is None:
                break
            if not all(a in sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            prod = math.prod(sizes[a] for a in cand)
            if prod == 0 or size % prod != 0:
                continue
            chosen = cand
            break
        if chosen is None:
            out.append(None)
        else:
            used.update(chosen)
            out.append(chosen[0] if len(chosen) == 1 else tuple(chosen))
    while out and out[-1] is None:  # trailing Nones dropped
        out.pop()
    return tuple(out)


def _is_dims(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None)))
                                        for i in x)


def _map(fn, *trees):
    """``fn`` over the leaves of same-structured nested dicts."""
    paths, first = tree_flatten(trees[0])
    rest = [tree_flatten(t)[1] for t in trees[1:]]
    return tree_unflatten(paths, [fn(*ls) for ls in zip(first, *rest)])


def axes_tree(specs) -> dict:
    """The logical-dims tree of a spec tree."""
    return _map(lambda s: tuple(s.dims), specs)


def shapes_tree(specs) -> dict:
    """The spec tree as meta tensors, each in its spec's dtype (bf16
    unless named), the reference's ``ShapeDtypeStruct``s."""
    return _map(lambda s: torch.empty(
        s.shape, dtype=torch_dtype(s.dtype) if s.dtype else torch.bfloat16,
        device="meta"), specs)


def pspec_tree(axes, shapes, rules: Rules, mesh) -> dict:
    """A logical-dims tree and a matching tree of shaped leaves (anything
    with ``.shape``) to specs."""
    return _map(lambda d, s: logical_to_pspec(tuple(d), tuple(s.shape),
                                              rules, mesh), axes, shapes)


@dataclasses.dataclass(frozen=True)
class TreeSharding:
    """The placement of a tree over a mesh: a spec a leaf and the mesh's
    axis sizes (the reference's tree of ``NamedSharding``)."""

    specs: dict
    axis_sizes: dict


def sharding_tree(axes, shapes, rules: Rules, mesh) -> TreeSharding:
    return TreeSharding(pspec_tree(axes, shapes, rules, mesh),
                        axis_sizes(mesh))


def prepend_axis(axes, name: str) -> dict:
    """Prepend a logical axis (e.g. ``client`` or ``layers``) to every
    leaf."""
    return _map(lambda d: (name,) + tuple(d), axes)


def rank_coords(mesh, rank: int) -> dict:
    """Rank ``rank``'s coordinate on each axis: row-major over the axes in
    order, as ``Mesh(devices.reshape(shape))`` places device r."""
    sizes = axis_sizes(mesh)
    out = {}
    for name in reversed(list(sizes)):
        out[name] = rank % sizes[name]
        rank //= sizes[name]
    return {name: out[name] for name in sizes}


def block_slices(shape, spec: tuple, mesh, coords: dict) -> tuple:
    """The slice of each dim that the rank at ``coords`` holds."""
    sizes = axis_sizes(mesh)
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(slice(0, n))
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, idx = 1, 0
        for a in names:  # row-major over the entry's axes
            idx = idx * sizes[a] + coords[a]
            parts *= sizes[a]
        per = n // parts
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


def local_block(leaf: torch.Tensor, spec: tuple, mesh,
                coords: dict) -> torch.Tensor:
    """The rank's block of ``leaf`` (a view)."""
    return leaf[block_slices(tuple(leaf.shape), spec, mesh, coords)]


def assemble(blocks: Sequence[torch.Tensor], shape, spec: tuple,
             mesh) -> torch.Tensor:
    """The whole leaf from every rank's block, ``blocks[r]`` rank r's
    (``local_block``'s inverse)."""
    out = torch.empty(tuple(shape), dtype=blocks[0].dtype,
                      device=blocks[0].device)
    for r, b in enumerate(blocks):
        out[block_slices(tuple(shape), spec, mesh, rank_coords(mesh, r))] = b
    return out


def block_tree(specs_tree: dict, shapes, mesh, coords: dict) -> dict:
    """Each leaf's per-dim block slices (``init_params(blocks=)``)."""
    return _map(lambda p, s: block_slices(tuple(s.shape), p, mesh, coords),
                specs_tree, shapes)


def _data_only(spec: tuple) -> tuple:
    return tuple(e if e == "data" else None for e in spec)


def _serve_dims(batch: int, seq: Optional[int]) -> tuple:
    return ((("batch", "seq"), (batch, seq)) if seq is not None
            else (("batch",), (batch,)))


def serve_split(batch: int, seq: Optional[int], mesh) -> Optional[str]:
    """What ``RULES_SERVE`` puts on the ``data`` axis of a serve step of
    ``batch`` sequences of ``seq`` (tokens or cache slots; None where the
    step has no sequence dim, a recurrent cache): "batch", "seq" or None
    (a data axis of 1, or neither divides)."""
    if axis_sizes(mesh).get("data", 1) == 1:
        return None
    dims, shape = _serve_dims(batch, seq)
    spec = logical_to_pspec(dims, shape, RULES_SERVE, mesh)
    return next((n for n, e in zip(dims, spec) if e == "data"), None)


@functools.cache  # asked a few times a decode step, on the host
def model_slots(slots: int, kv_heads: int, head_dim: int, m: int,
                rank: int) -> Optional[slice]:
    """The slots of a serve cache of ``slots`` (of ``kv_heads`` heads of
    ``head_dim``) that rank ``rank`` of a model axis of ``m`` holds, where
    ``RULES_SERVE`` cuts the cache's ``head_dim`` over ``model`` (its kv
    heads do not divide): block ``rank`` of blocks of ceil(slots / m), the
    last shorter (or empty), every kv head and the whole head dim in it;
    None where the rules leave the cache whole or cut its kv heads (the
    rank holds every slot of its kv heads).  A departure in layout, not
    in bytes: a ``head_dim`` block would leave each rank a partial q . k,
    which no softmax can take, where a block of slots keeps the decode on
    the ``decode_attn`` kernel, its (m, l, acc) partials merged over the
    axis (``sharding/collectives.py::merge_partials``)."""
    if m == 1:
        return None
    spec = logical_to_pspec(("kv_heads", "head_dim"), (kv_heads, head_dim),
                            RULES_SERVE, {"model": m})
    if spec != (None, "model"):
        return None
    per = -(-slots // m)
    return slice(min(rank * per, slots), min((rank + 1) * per, slots))


def serve_block(batch: int, seq: Optional[int], mesh, coords: dict) -> tuple:
    """The rank's (rows, slots) of a serve step's ``batch`` and of ``seq``
    cache slots under ``RULES_SERVE`` (slots None with ``seq`` None)."""
    dims, shape = _serve_dims(batch, seq)
    spec = _data_only(logical_to_pspec(dims, shape, RULES_SERVE, mesh))
    sl = block_slices(shape, spec, mesh, coords)
    return sl[0], (sl[1] if seq is not None else None)


def data_blocks(axes, shapes, mesh, coords: dict) -> dict:
    """Each leaf's per-dim block slices on the ``data`` axis alone under
    ``RULES_SERVE``: its spec with every other axis's entry dropped (a
    serve cache's ``model`` part is the rank's head plan,
    ``models/layers.py::head_plan``, or its ``model_slots``)."""
    return _map(lambda d, s: block_slices(tuple(s.shape), _data_only(
        logical_to_pspec(tuple(d), tuple(s.shape), RULES_SERVE, mesh)),
        mesh, coords), axes, shapes)
