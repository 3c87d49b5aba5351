"""LaneGCN-lite for Argoverse-style motion forecasting (paper §VI-C).

ActorNet: 1D conv stack over the past trajectory; MapNet: graph
convolutions over lane-centreline nodes (chain adjacency); FusionNet:
actor->map attention; a regression head predicts 30 future (x, y)
offsets.  Metric and loss: ADE (mean Euclidean displacement), as in the
paper.

Parameters keep the reference's tree: WIO conv weights (3, C_in, C_out),
permuted to torch's (C_out, C_in, 3) at each call; the past track enters
``forward`` as NWC and is permuted to NCW inside.  XLA's ``SAME`` padding
for a width-3 kernel is (1, 1) at stride 1 and (0, 1) at stride 2 on an
even length (torch refuses ``padding="same"`` above stride 1), so both
convs pad explicitly.  The max over time is ``amax``, which splits the
gradient evenly over ties as ``jnp.max`` does (after the ReLUs, ties at 0
are common).  Functional over the params dict, so
``torch.func.vmap(torch.func.grad(loss_fn))`` gives per-device gradients.

Channel-parallel over a ``model_axis`` (a ``sharding.collectives.
ModelAxis``): the rules put every linear's and conv's outputs (weight
columns and bias) on ``mlp``, so each layer is column-parallel, taking
its input whole (a block gathered, ``collectives.feed``) and computing
its rank's block of the outputs.  The fusion's scores sum over d: each
rank's partial scores from its blocks of q and k are all-reduced
(``reduce_from``), and the softmax and the context's block follow on
every rank (its weights enter the context's block through ``copy_to``).
``head2``'s 60 outputs do not divide over 8: there the rules
leave it whole and every rank runs it.  The predictions are gathered and
the ADE loss is computed whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import ParamSpec
from repro_torch.utils.device import constant

FUTURE = 30


def param_specs(cfg) -> dict:
    d = cfg.d_model

    def lin(i, o):
        return {
            "w": ParamSpec((i, o), (None, "mlp")),
            "b": ParamSpec((o,), ("mlp",), init="zeros"),
        }

    return {
        "actor_conv1": {"w": ParamSpec((3, 2, d), (None, None, "mlp")),
                        "b": ParamSpec((d,), ("mlp",), init="zeros")},
        "actor_conv2": {"w": ParamSpec((3, d, d), (None, None, "mlp")),
                        "b": ParamSpec((d,), ("mlp",), init="zeros")},
        "map_in": lin(2, d),
        "gcn1": lin(2 * d, d),
        "gcn2": lin(2 * d, d),
        "fuse_q": lin(d, d),
        "fuse_k": lin(d, d),
        "fuse_v": lin(d, d),
        "head1": lin(2 * d, cfg.d_ff),
        "head2": lin(cfg.d_ff, FUTURE * 2),
    }


def _lin(p, x):
    return x @ p["w"] + p["b"]


def _conv1d(p, x, stride: int = 1):
    """Width-3 ``SAME`` conv + bias + ReLU on NCW x, WIO weights."""
    x = F.pad(x, (1, 1) if stride == 1 else (0, 1))
    y = F.conv1d(x, p["w"].permute(2, 1, 0), stride=stride)
    return F.relu(y + p["b"][:, None])


def forward(params, cfg, batch_past, batch_lanes, model_axis=None, **_):
    """past: (B, 20, 2); lanes: (B, M, 2) -> predicted future (B, 30, 2)."""
    d, ff, fut = cfg.d_model, cfg.d_ff, FUTURE * 2
    # whether the rank holds a block of a layer's outputs (every d-wide
    # layer alike)
    cd = params["map_in"]["b"].shape[0] != d
    cf = params["head1"]["b"].shape[0] != ff
    co = params["head2"]["b"].shape[0] != fut

    def feed(x, dim, block, split):
        return C.feed(x, model_axis, dim, block, split)

    x = batch_past.to(torch.float32).permute(0, 2, 1)
    a = _conv1d(params["actor_conv1"], x)
    a = _conv1d(params["actor_conv2"], feed(a, 1, cd, cd), stride=2)
    actor = torch.amax(a, dim=2)  # (B, d)

    m = F.relu(_lin(params["map_in"], batch_lanes.to(torch.float32)))  # (B,M,d)
    # chain-adjacency graph conv: neighbour mean = (prev + next)/2
    for key in ("gcn1", "gcn2"):
        m = feed(m, -1, cd, cd)
        prev = torch.roll(m, 1, dims=1)
        nxt = torch.roll(m, -1, dims=1)
        neigh = 0.5 * (prev + nxt)
        m = F.relu(_lin(params[key], torch.cat([m, neigh], -1)))

    aq = feed(actor, -1, cd, cd)
    q = _lin(params["fuse_q"], aq)[:, None, :]  # (B,1,d)
    m = feed(m, -1, cd, cd)
    k = _lin(params["fuse_k"], m)
    v = _lin(params["fuse_v"], m)
    # the reference's scale: sqrt(d_model) taken in f32
    scale = torch.sqrt(constant(float(cfg.d_model), device=q.device))
    s = torch.einsum("bqd,bmd->bqm", q, k)
    if cd:  # the rank's blocks' partial scores
        s = C.reduce_from(s, model_axis)
    att = torch.softmax(s / scale, -1)
    if cd:  # the whole weights into the rank's block of the context
        att = C.copy_to(att, model_axis)
    ctx = torch.einsum("bqm,bmd->bqd", att, v)[:, 0]  # (B,d)

    ah = aq if cf == cd else feed(actor, -1, cd, cf)
    h = F.relu(_lin(params["head1"], torch.cat([ah, feed(ctx, -1, cd, cf)],
                                               -1)))
    out = _lin(params["head2"], feed(h, -1, cf, co))
    if co:  # every rank computes the whole loss
        out = C.gather(out, model_axis, -1, "slice")
    out = out.reshape(-1, FUTURE, 2)
    return out, torch.zeros((), dtype=torch.float32, device=out.device)


def loss_fn(params, cfg, batch, model_axis=None, batch_axis=None):
    """ADE: a mean over the samples (``batch_axis`` as
    ``encdec.loss_fn``'s)."""
    pred, _ = forward(params, cfg, batch["past"], batch["lanes"], model_axis)
    return ade(pred, batch["future"])


def ade(pred, target):
    """Average displacement error (paper's Argoverse metric)."""
    return torch.linalg.vector_norm(pred - target.to(torch.float32),
                                    dim=-1).mean()
