"""Minimal optimizer library (the port of ``src/repro/optim/optimizers.py``:
optax-style pure functions on trees of tensors: nested dicts, leaves in
``jax.tree.leaves`` order).

The paper trains with plain SGD (lr 0.01); AdamW/momentum are provided for
the beyond-paper drivers.  State and updates are nested dicts matching
params, with the reference's dtypes: f32 moments, an int32 ``count``,
adamw's updates cast to the parameter's dtype.  A learning rate is a
float or a schedule (``optim/schedules.py``) of the int32 count; a
schedule's 0-d f32 tensor promotes a bf16 operand to f32, as the
reference's strongly typed f32 scalar does (torch would keep the bf16),
and a float rate is rounded to a bf16 operand's dtype first, as JAX
rounds a weakly typed Python scalar.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state); updates are SUBTRACTED


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    paths, leaves = tree_flatten(tree)
    others = [tree_flatten(r)[1] for r in rest]
    return tree_unflatten(paths, [fn(*xs) for xs in zip(leaves, *others)])


def _mul(a, x: torch.Tensor) -> torch.Tensor:
    """a * x with JAX's promotion: a Python float is first rounded to x's
    dtype (a weak type; torch would multiply by the unrounded value), a
    tensor promotes with x."""
    if isinstance(a, torch.Tensor):
        dt = torch.promote_types(a.dtype, x.dtype)
        return a.to(dt) * x.to(dt)
    return torch.tensor(a, dtype=x.dtype) * x


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _count():
    return torch.zeros((), dtype=torch.int32)


def sgd(lr) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"count": _count()}

    def update(grads, state, params=None):
        step = state["count"]
        updates = _map(lambda g: _mul(lr_fn(step), g), grads)
        return updates, {"count": step + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {
            "count": _count(),
            "mu": _map(lambda p: torch.zeros_like(p, dtype=F32), params),
        }

    def update(grads, state, params=None):
        step = state["count"]
        mu = _map(lambda m, g: beta * m + g.to(F32), state["mu"], grads)
        if nesterov:
            upd = _map(lambda m, g: _mul(lr_fn(step), beta * m + g), mu, grads)
        else:
            upd = _map(lambda m: _mul(lr_fn(step), m), mu)
        return upd, {"count": step + 1, "mu": mu}

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {
            "count": _count(),
            "m": _map(lambda p: torch.zeros_like(p, dtype=F32), params),
            "v": _map(lambda p: torch.zeros_like(p, dtype=F32), params),
        }

    def update(grads, state, params):
        step = state["count"] + 1
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(F32), state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(F32)),
                 state["v"], grads)
        bc1 = 1 - torch.pow(b1, step.to(F32))
        bc2 = 1 - torch.pow(b2, step.to(F32))
        lr_t = lr_fn(step)

        def upd(m_, v_, p):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            return _mul(lr_t, u).to(p.dtype)

        updates = _map(upd, m, v, params)
        return updates, {"count": step, "m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tree_flatten(grads)[1]))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return _map(lambda g: _mul(scale, g).to(g.dtype), grads), norm


def apply_updates(params, updates):
    return _map(lambda p, u: (p - u.to(p.dtype)).to(p.dtype), params, updates)
