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

import dataclasses

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


def dispatch(logits, cfg, own=None, before=None, cap=None, means=None):
    """The routing plan of groups of tokens. logits: (ng, g, E).

    Returns (weights, keep, topi, slot, aux): ``keep`` (ng, g, E) f32 is
    1 where a token is routed to an expert and holds a slot there (the
    reference's ``keep``); ``slot`` (ng, g, k) is each choice's slot in
    its expert's buffer (its rank among the group's tokens that chose the
    expert), and ``aux`` the load-balance loss over every row, pads too.
    Over a serve step's data ranks (``moe_apply``): ``own`` (ng, g) marks
    the rows that are this rank's tokens, ``before`` maps the rank's
    per-group expert counts (ng, E) to those of the ranks before it in the
    same groups, and ``cap`` is the whole group's capacity.  ``means``
    maps the rank's sums of the own rows' probabilities and choices over
    (ng, g), each (E,), to the whole batch's means (P_e, f_e), as the
    reference means them over every row of every group, pads too (a
    training client's batch split over ranks); without it ``aux`` is over
    the rank's groups.
    """
    weights, mask, topi = route(logits, cfg)
    if own is not None:
        mask = mask * own[..., None]
    pos_in_exp = torch.cumsum(mask, dim=1) - 1.0
    if before is not None:
        pos_in_exp = pos_in_exp + before(mask.sum(1))[:, None]
    pos_in_exp = pos_in_exp * mask  # (ng,g,E)
    cap = capacity(logits.shape[1], cfg) if cap is None else cap
    keep = (pos_in_exp < cap).to(F32) * mask
    probs = torch.softmax(logits.to(F32), dim=-1)
    if means is None:
        p_e, f_e = probs.mean(dim=(0, 1)), mask.mean(dim=(0, 1))
    else:
        p_e, f_e = means((probs * own[..., None]).sum(dim=(0, 1)),
                         mask.sum(dim=(0, 1)))
    aux = load_balance_loss(p_e, f_e, cfg.num_experts)
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


def _groups(x, g: int, lead: int = 0, ng: int = 0):
    """(B, S, d) -> (ng, g, d) groups of tokens, pads last; ``lead`` pad
    rows first and ``ng`` groups in all (a data rank's tokens placed at
    their offsets in the whole batch's groups)."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    ng = ng or -(-xt.shape[0] // g)
    tail = ng * g - lead - xt.shape[0]
    if lead or tail:
        xt = torch.nn.functional.pad(xt, (0, 0, lead, tail))
    return xt.reshape(ng, g, d)


@dataclasses.dataclass(frozen=True)
class Span:
    """A data rank's tokens among the whole batch's dispatch groups: they
    are tokens [offset, offset + t) of ``total`` (the ranks' rows in rank
    order), in groups of ``g`` of which the rank's first is ``first``;
    ``lead`` rows of that group come before them, and the rank's ``ng``
    groups end with its last token (the last rank's with the whole
    batch's pads)."""

    g: int
    total: int
    offset: int
    t: int
    first: int
    lead: int
    ng: int
    last_rank: bool

    @classmethod
    def of(cls, t: int, data_axis) -> "Span":
        n, r = data_axis.size, data_axis.rank
        total = t * n
        g = max(min(GROUP, total), 1)
        off = r * t
        first = off // g
        return cls(g, total, off, t, first, off % g,
                   (off + t - 1) // g - first + 1, r == n - 1)

    @property
    def spans(self) -> bool:
        """Whether a group holds tokens of two ranks (every rank sees the
        same: the ranks hold equal token counts)."""
        return self.t % self.g != 0

    @property
    def groups(self) -> int:
        """The whole batch's groups."""
        return -(-self.total // self.g)

    def own(self, device) -> torch.Tensor:
        """(ng, g) f32: 1 on this rank's tokens, and on the last rank the
        whole batch's pads after them."""
        i = torch.arange(self.ng * self.g, device=device)
        end = self.ng * self.g if self.last_rank else self.lead + self.t
        return ((i >= self.lead) & (i < end)).to(F32).reshape(self.ng,
                                                              self.g)


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


def moe_apply(p, cfg, x, model_axis=None, data_axis=None, batch_axis=None):
    """x: (B, S, d) -> (B, S, d), aux_loss (scalar f32); over
    ``model_axis`` on the rank's blocks of ``p`` (the module's
    docstring).  ``data_axis``: x is this rank's rows of a serve step's
    batch split over the axis's ranks in rank order, and its tokens are
    routed in the whole batch's groups: a group that spans ranks has the
    whole group's capacity, and a token's slot counts the tokens of the
    ranks before it (``collectives.counts_before``, one all-gather a
    layer; none where no group spans ranks), so ``keep`` and the slots
    are one process's on the whole batch.  ``aux`` is then over the
    rank's groups (serving discards it).  ``batch_axis``: x is this
    rank's rows of a training client's batch (tokens [r t, (r + 1) t) of
    it, ``core/distributed.py``'s chunks), routed as over ``data_axis``,
    and ``aux`` is the whole batch's: P_e and f_e the means over all of
    its groups' rows, the rank's sums added over the axis in one
    ``collectives.all_sum`` of (2E,) f32 (f_e's half carries no
    gradient), the same scalar on every rank."""
    b, s, d = x.shape
    t = b * s
    dt = x.dtype
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
    own = before = means = None
    axis = data_axis if L._split(data_axis) else batch_axis
    if L._split(axis):
        sp = Span.of(t, axis)
        g, lead, ng = sp.g, sp.lead, sp.ng
        own = sp.own(x.device)
        if sp.spans:
            def before(counts):
                # the rank's groups placed among the whole batch's, built
                # out of place (a batched tensor takes no in-place write)
                whole = torch.nn.functional.pad(
                    counts, (0, 0, sp.first, sp.groups - sp.first - ng))
                return C.counts_before(whole, axis)[sp.first:sp.first + ng]
        if axis is batch_axis:
            def means(probs, mask):
                both = C.all_sum(torch.cat([probs, mask.detach()]), axis)
                return both[:e] / (sp.groups * g), both[e:] / (sp.groups * g)
    else:
        g, lead = max(min(GROUP, t), 1), 0
        ng = -(-t // g)
    xg = _groups(x, g, lead, ng)
    cap = capacity(g, cfg)

    router = L.whole(p["router"], (d, e), ma, "slice")
    logits = dot(xg, router.to(dt))
    dkw = {} if own is None else dict(own=own, before=before, cap=cap,
                                      means=means)
    weights, keep, topi, slot, aux = dispatch(logits, cfg, **dkw)
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
    xd = _groups(xc, g, lead, ng) if routed else xg
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
    y = yg.reshape(-1, d)[lead:lead + t].reshape(b, s, d)

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
