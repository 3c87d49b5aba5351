"""Model registry: one interface over the ported architecture families.

``build_model(cfg)`` returns a ``Model`` whose functions close over
nothing — params and caches are explicit dicts of tensors — so the AFL
core can vmap them over devices.  The paper's two models (vision: ResNet-9;
trajectory: LaneGCN) and the dense (Llama) and ssm (Mamba2) LLM families
are ported; ``load_params`` carries a reference parameter tree (numpy
arrays) over.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.rules import init_params, torch_dtype
from repro_torch.utils.tree import TreeLayout, tree_flatten, tree_unflatten


@dataclasses.dataclass(eq=False)
class Model:
    cfg: ModelConfig
    specs: dict
    loss_fn: Callable  # (params, cfg, batch) -> scalar loss
    forward: Callable
    decode_step: Optional[Callable] = None  # (params, cfg, cache, token, pos)
    prefill: Optional[Callable] = None
    init_cache: Optional[Callable] = None  # (cfg, batch, max_seq, device)

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        return init_params(self.specs, gen, torch_dtype(self.cfg.param_dtype),
                           device)

    @functools.cached_property
    def layout(self) -> TreeLayout:
        """Leaf paths, shapes and flat offsets in flatten order."""
        return TreeLayout.of(self.specs, shape_of=lambda s: s.shape)

    def num_params(self) -> int:
        return sum(math.prod(s.shape) for s in tree_flatten(self.specs)[1])


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "vision":
        from repro_torch.models import resnet as R

        return Model(cfg, R.param_specs(cfg), R.loss_fn, R.forward)
    if cfg.family == "trajectory":
        from repro_torch.models import lanegcn as G

        return Model(cfg, G.param_specs(cfg), G.loss_fn, G.forward)
    if cfg.family == "dense":
        from repro_torch.models import transformer as T

        return Model(cfg, T.param_specs(cfg), T.loss_fn, T.forward,
                     decode_step=T.decode_step, prefill=T.prefill,
                     init_cache=T.init_cache)
    if cfg.family == "ssm":
        from repro_torch.models import mamba2 as M

        return Model(cfg, M.param_specs(cfg), M.loss_fn, M.forward,
                     decode_step=M.decode_step, prefill=M.prefill,
                     init_cache=M.init_cache)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1)")


def _to_tensor(leaf, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy leaf as a tensor; bf16 leaves (numpy dtype ``bfloat16`` of
    ml_dtypes, which torch cannot read) are carried over bit for bit."""
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def load_params(model: Model, tree, device="cpu") -> dict:
    """The reference's parameter tree (numpy arrays) as the port's tensors.

    Checks the leaf paths (in flatten order) and shapes against the
    model's specs and raises ``ValueError`` on any mismatch.
    """
    paths, leaves = tree_flatten(tree)
    layout = model.layout
    if tuple(paths) != layout.paths:
        raise ValueError(f"leaf paths {paths} != model's {list(layout.paths)}")
    for path, leaf, shape in zip(paths, leaves, layout.shapes):
        if tuple(np.shape(leaf)) != shape:
            raise ValueError(f"leaf {'/'.join(path)}: shape "
                             f"{tuple(np.shape(leaf))} != spec {shape}")
    dt = torch_dtype(model.cfg.param_dtype)
    return tree_unflatten(paths, [_to_tensor(l, dt, device) for l in leaves])


def demo_batch(cfg: ModelConfig, batch: int, seq: int,
               rng: np.random.Generator):
    """Concrete small arrays for smoke tests (the reference's draws)."""
    if cfg.family == "vision":
        return {
            "images": rng.normal(0, 1, (batch, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, batch).astype(np.int32),
        }
    if cfg.family == "trajectory":
        return {
            "past": rng.normal(0, 1, (batch, 20, 2)).astype(np.float32),
            "lanes": rng.normal(0, 1, (batch, 32, 2)).astype(np.float32),
            "future": rng.normal(0, 1, (batch, 30, 2)).astype(np.float32),
        }
    if cfg.family in ("dense", "ssm"):
        return {
            "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        }
    raise NotImplementedError(f"demo_batch for family {cfg.family!r}")
