"""Mixture-of-Experts layer (GShard-style grouped capacity dispatch); the
port of ``repro/models/moe.py``.

Qwen-family MoE: optional shared experts (an always-on dense path) and
routed experts with top-k softmax gating.  Tokens are routed in groups of
``GROUP``; within a group each expert takes at most ``cap`` tokens, a
token's slot being its rank in token order among the group's tokens that
chose that expert, and tokens ranked at or past ``cap`` are dropped for
that expert.  The reference moves tokens to and from the (expert, slot)
buffers with one-hot einsums; here the same moves are an index copy and a
gather (an entry of the reference's dispatch tensor is 0 or 1 and each
slot holds at most one token, so its einsum copies the token exactly), and
the expert products are one batched matmul per projection.  At decode a
group is the batch: for Qwen3-MoE at batch 4, ``cap`` is 1.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.remat import dot
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
    mask = torch.zeros_like(probs).scatter_(-1, topi, 1.0)
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


def moe_apply(p, cfg, x):
    """x: (B, S, d) -> (B, S, d), aux_loss (scalar f32)."""
    b, s, d = x.shape
    t = b * s
    dt = x.dtype
    xt = x.reshape(t, d)
    g = max(min(GROUP, t), 1)
    if t % g:  # pad tokens to a whole number of groups; the pads come last
        xt = torch.nn.functional.pad(xt, (0, 0, 0, g - t % g))
    ng = xt.shape[0] // g
    xg = xt.reshape(ng, g, d)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(g, cfg)

    logits = dot(xg, p["router"].to(dt))
    weights, keep, topi, slot, aux = dispatch(logits, cfg)
    # every choice's row in the (E, ng, cap) buffers; a dropped choice
    # points at one spare zero row past them
    kept = torch.gather(keep, -1, topi) > 0  # (ng,g,k)
    grp = torch.arange(ng, device=x.device)[:, None, None]
    rows = torch.where(kept, (topi * ng + grp) * cap + slot, e * ng * cap)
    buf = torch.zeros((e * ng * cap + 1, d), dtype=dt, device=x.device)
    buf.index_copy_(0, rows.reshape(-1),
                    xg[:, :, None, :].expand(ng, g, k, d).reshape(-1, d))
    ye = _experts(p, cfg, buf[:-1].view(e, ng * cap, d))
    ye = torch.cat([ye.reshape(-1, d), buf.new_zeros((1, d))])
    # the combine: gate weights (cast to the activation dtype, as the
    # reference's combine tensor is) times the experts' rows, summed in f32
    w = (torch.gather(weights, -1, topi) * kept).to(dt)
    yg = torch.einsum("gtk,gtkd->gtd", w.to(F32), ye[rows].to(F32)).to(dt)
    y = yg.reshape(-1, d)[:t].reshape(b, s, d)

    if cfg.num_shared_experts:
        sp = p["shared"]
        hsh = L.silu_f32(dot(x, sp["wi_gate"].to(dt))) * dot(
            x, sp["wi_up"].to(dt))
        ysh = dot(hsh, sp["wo"].to(dt))
        sgate = torch.sigmoid(dot(x, sp["gate"].to(dt)).to(F32)).to(dt)
        y = y + sgate * ysh
    return y, aux
