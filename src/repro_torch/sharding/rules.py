"""Parameter specs and their initialisation (the port of
``repro/sharding/rules.py:111-146``).

Only the spec dataclass and ``init_params`` are ported, with every init
kind and dtype of the reference; the logical-axis sharding rules wait for
the distributed step.  Leaves are drawn from one ``torch.Generator`` in
flatten order (sorted keys) with the reference's distributions: N(0,
1/fan_in) * scale for ``normal`` (fan_in is ``shape[0]``, which for a
stacked leaf is the layer count, as in the reference), N(0, 0.02^2) for
``small``, N(0, 1) for ``embed``, ``scale`` for ``const``, constants for
``zeros`` / ``ones``, and for an int8 leaf (quantised expert weights)
clip(round(48 N(0, 1)), -127, 127).  Draws are made on the generator's
device (a CUDA generator keeps a 30B-parameter init off the host) and
then moved to ``device``; a leaf of more than ``DRAW_CHUNK`` values is
drawn in blocks of rows, so that its f32 draw never needs more than one
block beside the leaf.
The draws differ from ``jax.random``'s; tests that need the reference's
weights carry them over with ``models.registry.load_params``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
               device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype) if spec.dtype else dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "const":
        return torch.full(spec.shape, spec.scale, dtype=dt, device=device)
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
        return _draw(gen, spec.shape, std, spec.scale, dt, device)
    out = torch.empty(spec.shape, dtype=dt, device=device)
    rows = max(1, DRAW_CHUNK * spec.shape[0] // n)
    for start in range(0, spec.shape[0], rows):
        blk = out[start:start + rows]
        blk.copy_(_draw(gen, blk.shape, std, spec.scale, dt, device))
    return out


def init_params(specs, gen: torch.Generator, dtype=torch.float32,
                device="cpu") -> dict:
    """Initialise a nested dict of ParamSpec into tensors on ``device``."""
    paths, leaves = tree_flatten(specs)
    arrs = [_init_leaf(gen, s, torch_dtype(dtype), device) for s in leaves]
    return tree_unflatten(paths, arrs)
