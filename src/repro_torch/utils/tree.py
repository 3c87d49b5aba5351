"""Parameter trees as nested dicts, in ``jax.tree.flatten`` order.

The reference keeps every federated quantity (the global model w, the
per-device models w_n, cumulative gradients g_n, error memories e_n) as a
pytree; the port keeps each as ONE flat buffer, (s,) or (N, s), and a
``TreeLayout`` that maps leaf names to column ranges.  The order is the
reference's: dict keys sorted at every level, so the flat column index is
the reference's flat coordinate index (which drives the global threshold
sample, the dither counter ``base`` and the float sum order of
``x_norm2``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch


def _walk(node, prefix, paths, leaves) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], prefix + (k,), paths, leaves)
    else:
        paths.append(prefix)
        leaves.append(node)


def tree_flatten(tree):
    """(paths, leaves) of a nested dict, keys sorted at every level.

    A module-level walk, not a closure: a nested recursive function refers
    to itself through its own cell, and that cycle would keep ``leaves``
    (and the tensors in it) alive until Python's cyclic collector runs."""
    paths, leaves = [], []
    _walk(tree, (), paths, leaves)
    return paths, leaves


def tree_unflatten(paths, leaves) -> dict:
    """Inverse of ``tree_flatten`` for nested dicts."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Leaf paths, shapes and column offsets of a flattened tree."""

    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]

    @classmethod
    def of(cls, tree, shape_of: Callable[[Any], Tuple[int, ...]] = None):
        paths, leaves = tree_flatten(tree)
        shape_of = shape_of or (lambda l: tuple(l.shape))
        return cls(tuple(paths), tuple(tuple(shape_of(l)) for l in leaves))

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, off = [], 0
        for n in self.sizes:
            out.append(off)
            off += n
        return tuple(out)

    @property
    def size(self) -> int:
        """Total number of scalar parameters s."""
        return sum(self.sizes)

    def leaves(self, flat: torch.Tensor):
        """Per-leaf views of ``flat`` (..., s) shaped (..., *leaf_shape)."""
        lead = tuple(flat.shape[:-1])
        return [
            flat[..., off:off + n].view(lead + shape)
            for off, n, shape in zip(self.offsets, self.sizes, self.shapes)
        ]

    def unflatten(self, flat: torch.Tensor) -> dict:
        """Nested dict of views of ``flat`` (..., s)."""
        return tree_unflatten(self.paths, self.leaves(flat))

    def flatten(self, tree, lead: int = 0) -> torch.Tensor:
        """Concatenate a tree whose leaves carry ``lead`` leading dims."""
        paths, leaves = tree_flatten(tree)
        if tuple(paths) != self.paths:
            raise ValueError(f"tree paths {paths} != layout {self.paths}")
        return torch.cat(
            [l.reshape(tuple(l.shape[:lead]) + (-1,)) for l in leaves], dim=lead)


def flatten_concat(tree) -> torch.Tensor:
    """Concatenate all leaves into one flat vector."""
    return TreeLayout.of(tree).flatten(tree)


def unflatten_like(vec: torch.Tensor, ref) -> dict:
    """Inverse of ``flatten_concat`` given a reference tree."""
    return TreeLayout.of(ref).unflatten(vec)
