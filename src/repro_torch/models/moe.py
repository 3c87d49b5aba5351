"""Mixture-of-Experts layer (GShard-style grouped capacity dispatch); the
port of ``repro/models/moe.py``.

Qwen-family MoE: optional shared experts (an always-on dense path) and
routed experts with top-k softmax gating.  Tokens are routed in groups of
``GROUP``; within a group each expert takes at most ``cap`` tokens, a
token's slot being its rank in token order among the group's tokens that
chose that expert, and tokens ranked at or past ``cap`` are dropped for
that expert.  The reference moves tokens to and from the (expert, slot)
buffers with one-hot einsums; here the same moves are two gathers (an
entry of the reference's dispatch tensor is 0 or 1 and each slot holds at
most one token, so its einsum copies the token exactly), and the expert
products are one batched matmul per projection.  Every step is out of
place, so the dispatch runs under ``torch.func.vmap`` (the clients'
vmapped gradient) with a batching rule for each operator, and has no host
sync or data-dependent shape (a CUDA graph captures it).  At decode a
group is the batch: for Qwen3-MoE at batch 4, ``cap`` is 1.

Over a ``model`` axis (``model_axis``; ``sharding/rules.py`` places the
leaves) every rank holds every token of its data row and computes the
whole routing (logits, ``dispatch``, capacity, ``keep``, ``aux``) from
the router gathered whole.  Its experts' work is then split as the rules
split the leaves:

* ``experts`` on ``model`` (E % M == 0): the rank holds E/M experts,
  builds (E/M, ng * cap, d) buffers of the choices that landed on them
  (the others point at the spare row) and combines only those;
* ``expert_mlp`` on ``model`` (E % M != 0): every expert on every rank,
  with a column block of ``wi_gate`` / ``wi_up`` and a row block of
  ``wo``;
* the shared experts on ``mlp``, as ``layers.mlp_apply`` splits.

The partial outputs are added and all-reduced once (``reduce_from``): one
all-reduce of (tokens, d) a layer forward, and no all-to-all (the tokens
are on every rank already).  The routing is replicated, so its gradient
is the same on every rank: the router's returns to its block as it is
(``gather(grad="slice")``); x enters the rank's own work through
``copy_to``, and so do the gate weights before the combine (their
gradient is summed over the ranks before it flows into the replicated
routing) and the whole leaves the rank's own work reads (the shared
``gate``; an ``expert_mlp`` split's int8 scales).  With the axis's
``checks`` on (a dict), every MoE layer outside the gradient checks that
each rank routed alike (a checksum of ``topi`` and ``keep``
all-gathered, ``collectives.agree``) and counts it under "routing"; a
rank that routes a token otherwise raises.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.remat import dot
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import ParamSpec

F32 = torch.float32
GROUP = 512  # tokens per dispatch group


def moe_specs(cfg) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, (cfg.moe_d_ff or cfg.d_ff)
    edt = "int8" if cfg.expert_dtype == "int8" else None
    sp = {
        "router": ParamSpec((d, e), ("embed", "experts"), init="small"),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dtype=edt),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dtype=edt),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"), dtype=edt),
    }
    if edt:
        # per-expert dequantisation scales (applied to the products'
        # OUTPUTS, so that int8 weights are only ever cast, never scaled)
        for nm, fan in (("s_gate", d), ("s_up", d), ("s_down", f)):
            sp[nm] = ParamSpec((e,), ("experts",), init="const",
                               scale=(1.0 / fan) ** 0.5 / 48.0, dtype="float32")
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * f
        sp["shared"] = {
            "wi_gate": ParamSpec((d, fs), ("embed", "mlp")),
            "wi_up": ParamSpec((d, fs), ("embed", "mlp")),
            "wo": ParamSpec((fs, d), ("mlp", "embed")),
            "gate": ParamSpec((d, 1), ("embed", None), init="small"),
        }
    return sp


def capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts)
    return max(c, 1)


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties, and pad rows' uniform probabilities are all ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits, cfg):
    """Top-k routing. logits: (..., E). Returns (weights, mask, topi):
    the renormalised gate weights and the 0/1 choice mask, (..., E) f32,
    and the chosen experts (..., k) in descending probability."""
    probs = torch.softmax(logits.to(F32), dim=-1)
    _, topi = top_k(probs, cfg.num_experts_per_tok)
    mask = torch.scatter(torch.zeros_like(probs), -1, topi, 1.0)
    weights = probs * mask
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, mask, topi


def load_balance_loss(probs_mean, dispatch_frac, num_experts: int):
    """Switch/GShard auxiliary loss: E * sum_e f_e * P_e."""
    return num_experts * torch.sum(probs_mean * dispatch_frac)


def dispatch(logits, cfg):
    """The routing plan of groups of tokens. logits: (ng, g, E).

    Returns (weights, keep, topi, slot, aux): ``keep`` (ng, g, E) f32 is
    1 where a token is routed to an expert and holds a slot there (the
    reference's ``keep``); ``slot`` (ng, g, k) is each choice's slot in
    its expert's buffer (its rank among the group's tokens that chose the
    expert), and ``aux`` the load-balance loss over every row, pads too.
    """
    weights, mask, topi = route(logits, cfg)
    pos_in_exp = (torch.cumsum(mask, dim=1) - 1.0) * mask  # (ng,g,E)
    keep = (pos_in_exp < capacity(logits.shape[1], cfg)).to(F32) * mask
    probs = torch.softmax(logits.to(F32), dim=-1)
    aux = load_balance_loss(probs.mean(dim=(0, 1)), mask.mean(dim=(0, 1)),
                            cfg.num_experts)
    slot = torch.gather(pos_in_exp, -1, topi).long()
    return weights, keep, topi, slot, aux


def _experts(p, cfg, xe):
    """The routed experts' SwiGLU on their buffers. xe: (E, rows, d)."""
    dt = xe.dtype
    gate = torch.bmm(xe, p["wi_gate"].to(dt))
    up = torch.bmm(xe, p["wi_up"].to(dt))
    if cfg.expert_dtype == "int8":
        gate = gate * p["s_gate"][:, None, None].to(dt)
        up = up * p["s_up"][:, None, None].to(dt)
    ye = torch.bmm(L.silu_f32(gate) * up, p["wo"].to(dt))
    if cfg.expert_dtype == "int8":
        ye = ye * p["s_down"][:, None, None].to(dt)
    return ye


def _groups(x, g: int):
    """(B, S, d) -> (ng, g, d) groups of tokens, pads last."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    if xt.shape[0] % g:  # pad tokens to a whole number of groups
        xt = torch.nn.functional.pad(xt, (0, 0, 0, g - xt.shape[0] % g))
    return xt.reshape(-1, g, d)


def _check_routing(topi, keep, axis) -> None:
    """With ``axis.checks`` on: every rank's ``topi`` and ``keep`` the
    same (a position-weighted checksum of each, all-gathered).  The
    caller turns the checks on only outside the gradient and outside
    ``vmap`` (``agree``'s all-gather has no batching rule)."""
    if not L._split(axis) or axis.checks is None:
        return
    w = torch.arange(1, topi.numel() + 1, device=topi.device) % 65521 + 1
    kw = torch.arange(1, keep.numel() + 1, device=keep.device) % 65521 + 1
    sums = torch.stack([(topi.reshape(-1).long() * w).sum(),
                        (keep.reshape(-1).long() * kw).sum(),
                        keep.sum().long()])
    if not C.agree(sums, axis):
        raise RuntimeError(f"MoE routing differs over the model axis on "
                           f"rank {axis.rank}: checksums {sums.tolist()}")
    axis.checks["routing"] = axis.checks.get("routing", 0) + 1


def moe_apply(p, cfg, x, model_axis=None):
    """x: (B, S, d) -> (B, S, d), aux_loss (scalar f32); over
    ``model_axis`` on the rank's blocks of ``p`` (the module's
    docstring)."""
    b, s, d = x.shape
    t = b * s
    dt = x.dtype
    g = max(min(GROUP, t), 1)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    f = cfg.moe_d_ff or cfg.d_ff
    ma = model_axis
    split = L._split(ma)
    el = p["wi_gate"].shape[0]  # the rank's experts
    e0 = ma.rank * el if el != e else 0
    routed = split and (el != e or p["wi_gate"].shape[2] != f)
    shared = bool(cfg.num_shared_experts) and split and (
        p["shared"]["wi_gate"].shape[1] != cfg.num_shared_experts * f)
    xc = C.copy_to(x, ma) if routed or shared else x  # the rank's own work
    xg = _groups(x, g)
    ng = xg.shape[0]
    cap = capacity(g, cfg)

    router = L.whole(p["router"], (d, e), ma, "slice")
    logits = dot(xg, router.to(dt))
    weights, keep, topi, slot, aux = dispatch(logits, cfg)
    _check_routing(topi, keep, ma)
    # every choice's row in the rank's (E/M, ng, cap) buffers; a dropped
    # choice, or one on another rank's expert, points at one spare row
    # past them
    kept = torch.gather(keep, -1, topi) > 0  # (ng,g,k)
    mine = kept & (topi >= e0) & (topi < e0 + el) if el != e else kept
    grp = torch.arange(ng, device=x.device)[:, None, None]
    nrow = el * ng * cap
    rows = torch.where(mine, ((topi - e0) * ng + grp) * cap + slot, nrow)
    # the inverse map, each buffer row's token, built out of place: a row
    # no token holds reads a spare zero token past the ng*g real ones
    # (the spare buffer row, which every other choice writes, is cut)
    tok = torch.arange(ng * g, device=x.device).reshape(ng, g, 1)
    src = torch.full((nrow + 1,), ng * g, dtype=torch.long, device=x.device)
    src = torch.scatter(src, 0, rows.reshape(-1),
                        tok.expand(ng, g, k).reshape(-1))[:nrow]
    xd = _groups(xc, g) if routed else xg
    xz = torch.nn.functional.pad(xd.reshape(-1, d), (0, 0, 0, 1))
    pe = p
    if routed and el == e and cfg.expert_dtype == "int8":
        # whole scales read by the rank's blocks of every expert
        pe = dict(p, **{nm: C.copy_to(p[nm], ma)
                        for nm in ("s_gate", "s_up", "s_down")})
    ye = _experts(pe, cfg, xz[src].view(el, ng * cap, d))
    ye = torch.nn.functional.pad(ye.reshape(-1, d), (0, 0, 0, 1))
    # the combine: gate weights (cast to the activation dtype, as the
    # reference's combine tensor is) times the experts' rows, summed in
    # f32; over the axis the weights' gradient is summed before it flows
    # into the routing, and the rank combines its own choices
    w = torch.gather(weights, -1, topi) * kept
    if routed:
        w = C.copy_to(w, ma) * mine
    w = w.to(dt)
    yg = torch.einsum("gtk,gtkd->gtd", w.to(F32), ye[rows].to(F32)).to(dt)
    y = yg.reshape(-1, d)[:t].reshape(b, s, d)

    ysh = None
    if cfg.num_shared_experts:
        sp = p["shared"]
        xs = xc if shared else x
        hsh = L.silu_f32(dot(xs, sp["wi_gate"].to(dt))) * dot(
            xs, sp["wi_up"].to(dt))
        ysh = dot(hsh, sp["wo"].to(dt))
        gate = C.copy_to(sp["gate"], ma) if shared else sp["gate"]
        sgate = torch.sigmoid(dot(xs, gate.to(dt)).to(F32)).to(dt)
        ysh = sgate * ysh
        if shared == routed:  # both partial (one all-reduce) or whole
            y, ysh = y + ysh, None
    if routed:
        y = C.reduce_from(y, ma)
    if ysh is not None:
        y = y + C.reduce_from(ysh, ma) if shared else y + ysh
    return y, aux
