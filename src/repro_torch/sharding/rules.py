"""Parameter specs and their initialisation (the port of
``repro/sharding/rules.py:111-146``).

Only the spec dataclass and ``init_params`` are ported, with the init
kinds and dtypes ResNet-9 and the dense and ssm LLMs use; the
logical-axis sharding rules wait for the distributed step, and the other
kinds for the families that use them.  Leaves are drawn from one
``torch.Generator`` in flatten order (sorted keys) with the reference's
distributions: N(0, 1/fan_in) * scale for ``normal`` (fan_in is
``shape[0]``, which for a stacked leaf is the layer count, as in the
reference), N(0, 0.02^2) for ``small``, and constants for ``zeros`` /
``ones``.  Draws are made on the generator's device (a CUDA generator
keeps a 3B-parameter init off the host) and then moved to ``device``.
The draws differ from ``jax.random``'s; tests that need the reference's
weights carry them over with ``models.registry.load_params``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


@dataclasses.dataclass
class ParamSpec:
    shape: Tuple[int, ...]
    dims: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | small
    scale: float = 1.0
    dtype: Optional[str] = None  # override param dtype


def _init_leaf(gen: torch.Generator, spec: ParamSpec, dtype: torch.dtype,
               device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype) if spec.dtype else dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "small":
        std = 0.02
    elif spec.init == "normal":
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else spec.shape[-1]
        std = (1.0 / max(fan_in, 1)) ** 0.5
    else:
        raise NotImplementedError(f"init {spec.init!r} is not ported")
    vals = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    return (vals * std * spec.scale).to(device=device, dtype=dt)


def init_params(specs, gen: torch.Generator, dtype=torch.float32,
                device="cpu") -> dict:
    """Initialise a nested dict of ParamSpec into tensors on ``device``."""
    paths, leaves = tree_flatten(specs)
    arrs = [_init_leaf(gen, s, torch_dtype(dtype), device) for s in leaves]
    return tree_unflatten(paths, arrs)
