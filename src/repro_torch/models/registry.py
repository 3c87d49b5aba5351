"""Model registry: one interface over the ported architecture families.

``build_model(cfg)`` returns a ``Model`` whose functions close over
nothing — params are explicit dicts of tensors — so the AFL core can vmap
them over devices.  Only the vision family (ResNet-9) is ported;
``load_params`` carries a reference parameter tree (numpy arrays) over.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

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
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP.md, queue 1: "
        "LaneGCN first, then the LLM families)")


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
    return tree_unflatten(paths, [
        torch.tensor(np.asarray(l), dtype=dt, device=device) for l in leaves])


def demo_batch(cfg: ModelConfig, batch: int, rng: np.random.Generator):
    """Concrete small arrays for smoke tests (the reference's draws)."""
    if cfg.family == "vision":
        return {
            "images": rng.normal(0, 1, (batch, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, batch).astype(np.int32),
        }
    raise NotImplementedError(f"demo_batch for family {cfg.family!r}")
