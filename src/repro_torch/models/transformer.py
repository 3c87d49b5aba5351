"""Decoder-only transformer LM, dense family (Llama-3.2 and kin); the port
of ``repro/models/transformer.py``.

Layers are stacked on a leading ``layers`` axis in the parameter tree, as
in the reference (which runs them with ``lax.scan``); here a Python loop
walks the axis.  Dense GQA blocks only: the MoE and VLM variants raise
``NotImplementedError`` (ROADMAP.md, queue 1), and so does the int8 KV
cache.

Decode supports the plain KV cache, through the ``decode_attn`` kernel,
and the ring-buffer sliding-window cache (``cfg.sliding_window > 0``),
through the plain einsum path, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.sharding.rules import ParamSpec
from repro_torch.utils.tree import tree_flatten, tree_unflatten


def _refuse_unported(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"transformer family {cfg.family!r} is not ported (ROADMAP.md, "
            "queue 1: the other LLM families)")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "the int8 KV cache is not ported (ROADMAP.md, queue 1)")


def stack_specs(specs, n: int, axis_name: str = "layers"):
    paths, leaves = tree_flatten(specs)
    return tree_unflatten(paths, [
        ParamSpec((n,) + s.shape, (axis_name,) + s.dims, s.init, s.scale, s.dtype)
        for s in leaves])


def layer(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on axis 0 (views)."""
    paths, leaves = tree_flatten(tree)
    return tree_unflatten(paths, [l[i] for l in leaves])


def block_specs(cfg) -> dict:
    _refuse_unported(cfg)
    return {
        "ln_attn": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln_mlp": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attn_specs(cfg),
        "mlp": L.mlp_specs(cfg),
    }


def param_specs(cfg) -> dict:
    sp = {
        "embed": L.embed_specs(cfg),
        "layers": stack_specs(block_specs(cfg), cfg.num_layers),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        sp["unembed"] = {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="small")
        }
    return sp


# ---------------------------------------------------------------------------
# Full-sequence forward (training / prefill)
# ---------------------------------------------------------------------------


def forward(params, cfg, tokens, *, collect_kv=False):
    """Returns (logits, aux_loss), and the stacked (k, v) of every layer,
    each (L, B, S, KV, D), too if ``collect_kv``.  Positions are 0..S-1.
    """
    x = L.embed(params, cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos, sin = L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["attn"], cfg, h)
        q, k = L.apply_rope(q, k, cos, sin)
        attn = L.causal_attention(q, k, v, sliding_window=cfg.sliding_window)
        x = x + L.attn_out(lp["attn"], attn, x.dtype)
        h2 = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h2)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_kv:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux


def loss_fn(params, cfg, batch):
    """Mean next-token cross-entropy. batch: tokens/labels (B, S)."""
    logits, _ = forward(params, cfg, batch["tokens"])
    return L.cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_seq: int, device="cpu"):
    _refuse_unported(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = cfg.activation_dtype
    return {
        "pos": torch.full((batch, max_seq), -1, dtype=torch.int32, device=device),
        "length": 0,
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def prefill(params, cfg, tokens, *, max_seq: Optional[int] = None):
    """Run the prompt, return (last-token logits, filled cache).

    The cache is allocated once at ``max_seq`` slots, (L, B, max_seq, KV,
    D), and ``decode_step`` writes it in place; ``length`` is a Python int.
    """
    logits, _, (ks, vs) = forward(params, cfg, tokens, collect_kv=True)
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    cache = init_cache(cfg, b, max_seq, tokens.device)
    cache["k"][:, :, :s] = ks
    cache["v"][:, :, :s] = vs
    cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32, device=tokens.device)
    cache["length"] = s
    return logits[:, -1], cache


def decode_step(params, cfg, cache, token, pos: int):
    """One decode step. token: (B,) int; pos: the absolute position, a
    Python int, so that the slot and ``length`` need no copy from the card.

    The cache is updated IN PLACE and returned: the new k and v go into
    slot ``pos`` (``pos % window`` with ``cfg.sliding_window > 0``, where
    the cache's seq dim is the window, a ring buffer).  The reference's
    ``dynamic_update_slice`` makes a functional copy instead; the values
    are the same.
    """
    pos = int(pos)
    x = L.embed(params, cfg, token)[:, None, :]  # (B,1,d)
    b = x.shape[0]
    window = cfg.sliding_window
    s_cache = cache["k"].shape[2]
    slot = pos % max(s_cache, 1) if window > 0 else pos
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = L.rope_cos_sin(posb, cfg.resolved_head_dim, cfg.rope_theta)
    cache["pos"][:, slot] = pos
    wpos = cache["pos"] if window > 0 else None
    length = min(pos + 1, s_cache)
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["attn"], cfg, h)
        q, k = L.apply_rope(q, k, cos, sin)
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        attn = L.decode_attention(q[:, 0], kc, vc, length, window_pos=wpos)
        x = x + L.attn_out(lp["attn"], attn[:, None], x.dtype)
        h2 = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h2)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, cfg, x)[:, 0]
    cache["length"] = length
    return logits, cache
