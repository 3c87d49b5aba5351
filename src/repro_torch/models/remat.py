"""Activation checkpointing of a layer body (``ModelConfig.remat``); the
port of the reference's ``jax.checkpoint`` sites.

``checkpoint(body, policy, tree, *tensors)`` runs ``body(tree, *tensors)``
(a layer: its parameter subtree and its activations) and, when a gradient
is being taken, keeps for the backward pass only what ``policy`` says:

* ``"none"``: everything autograd saves (no checkpoint);
* ``"full"``: the body's inputs; the backward recomputes the body, then
  differentiates it (``jax.checkpoint(body)``);
* ``"dots"``: the inputs and the outputs of the body's weight products,
  the calls to ``dot`` (q, k, v, o, gate, up, down, the MoE router and
  shared experts): the reference's ``checkpoint_dots_with_no_batch_dims``,
  which keeps every ``dot_general`` without batch dimensions.  The
  backward recomputes the rest (norms, RoPE, the attention einsums,
  softmax, activations); there each ``dot`` returns its kept product, and
  its backward is the product's own.

``torch.utils.checkpoint`` is not used: its non-reentrant form needs
saved-tensor hooks, which ``torch.func`` does not support, and the
training gradient is ``vmap(grad(loss))`` (``core/afl.py::device_grads``).
A ``torch.autograd.Function`` with ``setup_context`` and
``generate_vmap_rule = True`` works under both transforms: it saves only
what the policy keeps and, in ``backward``, recomputes the body through
``torch.func.vjp``.  The recomputation runs the same operations on the
same values, so the gradient is bit-equal to ``"none"``'s
(``tests/test_torch_remat.py``).

Memory.  ``torch.func.grad`` runs its backward pass with
``create_graph=True``, so without a checkpoint every layer's saved
activations and every backward temporary stay alive until the pass ends
(at full-width InternLM2-1.8B, 40 GiB over the state for two clients:
PERF.md).  The checkpoint's backward returns its layer's gradient
detached from that graph, so a layer's recomputed activations and
temporaries are freed when its backward returns.  The price: the gradient
through a checkpoint is not itself differentiable (no second derivative;
training takes none).

Outside a gradient (``torch.is_grad_enabled()`` false: serving, evals
under ``no_grad``) every policy runs the body as it is.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import REMAT_POLICIES as POLICIES
from repro_torch.utils.tree import tree_flatten, tree_unflatten

__all__ = ["POLICIES", "checkpoint", "dot", "full_only"]

_tape = None  # the running ``dots`` body's _Tape; None outside one


class _Tape:
    """The products of one ``dots`` body: recorded in its forward,
    replayed in order when the backward recomputes it."""

    def __init__(self, kept=None):
        self.replay = kept is not None
        self.kept = list(kept) if self.replay else []
        self.i = 0


def _product(x, w, eq):
    return x @ w if eq is None else torch.einsum(eq, x, w)


class _Kept(torch.autograd.Function):
    """A weight product whose value was kept: the forward returns it, the
    backward is the product's (``x @ w`` as ``torch.matmul`` folds it to
    ``mm``; an einsum ``a,b->c`` by the einsums ``c,b->a`` and ``a,c->b``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(eq, x, w, kept):
        return kept

    @staticmethod
    def setup_context(ctx, inputs, output):
        eq, x, w, _ = inputs
        ctx.eq = eq
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        _, need_x, need_w, _ = ctx.needs_input_grad
        gx = gw = None
        if ctx.eq is None:
            d, f = w.shape
            g2 = g.reshape(-1, f)
            if need_x:
                gx = g2.mm(w.t()).view(x.shape)
            if need_w:
                gw = x.reshape(-1, d).t().mm(g2)
        else:
            ins, out = ctx.eq.split("->")
            a, b = ins.split(",")
            if need_x:
                gx = torch.einsum(f"{out},{b}->{a}", g, w)
            if need_w:
                gw = torch.einsum(f"{a},{out}->{b}", x, g)
        return None, gx, gw, None


def dot(x, w, eq: str | None = None):
    """The weight product ``x @ w`` (``w`` 2-D), or ``torch.einsum(eq, x,
    w)`` (a two-operand equation with no batch dimensions): what a
    ``"dots"`` checkpoint keeps.  Outside one it is the product."""
    tape = _tape
    if tape is not None and tape.replay:
        kept = tape.kept[tape.i]
        tape.i += 1
        return _Kept.apply(eq, x, w, kept)
    out = _product(x, w, eq)
    if tape is not None:
        tape.kept.append(out)
    return out


def _run(body, args, tape):
    """``body(*args)`` with ``tape`` as the running ``dots`` tape."""
    global _tape
    outer, _tape = _tape, tape
    try:
        return body(*args)
    finally:
        _tape = outer


class _Layer:
    """One checkpointed call: the flat body, its policy, and what its
    forward found out (how many outputs the body has, and whether it
    returns one tensor)."""

    def __init__(self, body, policy: str):
        self.body = body
        self.policy = policy
        self.n_out = 0
        self.single = False


class _Checkpoint(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(run, *args):
        tape = _Tape() if run.policy == "dots" else None
        out = _run(run.body, args, tape)
        run.single = not isinstance(out, tuple)
        out = (out,) if run.single else out
        kept = tape.kept if tape is not None else []
        run.n_out = len(out)
        return (*out, *kept)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, *args = inputs
        ctx.run = run
        ctx.n_args = len(args)
        kept = output[run.n_out:]
        ctx.save_for_backward(*args, *kept)
        ctx.mark_non_differentiable(*kept)

    @staticmethod
    def backward(ctx, *grads):
        run = ctx.run
        saved = ctx.saved_tensors
        args, kept = saved[:ctx.n_args], saved[ctx.n_args:]
        need = [i for i in range(ctx.n_args) if ctx.needs_input_grad[1 + i]]

        def recompute(*diff):
            full = list(args)
            for i, d in zip(need, diff):
                full[i] = d
            out = _run(run.body, full,
                       _Tape(kept) if run.policy == "dots" else None)
            return (out,) if run.single else out

        _, vjp = torch.func.vjp(recompute, *(args[i] for i in need))
        got = vjp(tuple(grads[:run.n_out]))
        # detached: ``torch.func.grad`` differentiates with create_graph=True,
        # and a graph of this gradient would keep the layer's recomputed
        # activations and backward temporaries alive until the whole
        # backward pass ends (what "none" pays)
        out = [None] * ctx.n_args
        for i, g in zip(need, got):
            out[i] = g.detach()
        return (None, *out)


def checkpoint(body, policy: str, tree, *tensors):
    """``body(tree, *tensors)`` under the checkpoint ``policy`` (one of
    ``POLICIES``).  ``tree`` is the layer's parameter subtree (a dict of
    tensors); every other tensor the body reads must come in ``tensors``
    (a closed-over tensor would not get its gradient).  Returns what the
    body returns: a tensor or a tuple of tensors."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r} not in {POLICIES}")
    if policy == "none" or not torch.is_grad_enabled():
        return body(tree, *tensors)
    paths, leaves = tree_flatten(tree)
    nt = len(tensors)

    def flat_body(*args):
        return body(tree_unflatten(paths, list(args[nt:])), *args[:nt])

    run = _Layer(flat_body, policy)
    out = _Checkpoint.apply(run, *tensors, *leaves)[:run.n_out]
    return out[0] if run.single else out


def full_only(policy: str) -> str:
    """The policy of a model that reads only ``"full"`` (the reference's
    Mamba2, hybrid and encoder-decoder): ``"dots"`` runs as ``"none"``."""
    return "full" if policy == "full" else "none"
