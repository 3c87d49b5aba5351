"""Decoder-only transformer LM (dense / MoE / VLM backbone); the port of
``repro/models/transformer.py``.

Layers are stacked on a leading ``layers`` axis in the parameter tree, as
in the reference (which runs them with ``lax.scan``); here a Python loop
walks the axis.  Covers:

* dense GQA blocks (llama3 / internlm2 / qwen2 / qwen3 signatures:
  qkv-bias, qk-norm, GQA, tied embeddings),
* MoE blocks (shared + routed experts, top-k routing, capacity dispatch;
  ``models/moe.py``),
* the Qwen2-VL language backbone: M-RoPE position streams and an
  embedding injection path for the (stubbed) vision frontend.

Decode supports the plain KV cache, through the ``decode_attn`` kernel;
the ring-buffer sliding-window cache (``cfg.sliding_window > 0``) and the
int8 cache (``cfg.kv_cache_dtype == "int8"``) go through plain einsum
paths, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.remat import checkpoint
from repro_torch.sharding.rules import ParamSpec
from repro_torch.utils.tree import tree_flatten, tree_unflatten

F32 = torch.float32


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
    sp = {
        "ln_attn": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln_mlp": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attn_specs(cfg),
    }
    if cfg.is_moe:
        sp["moe"] = MOE.moe_specs(cfg)
    else:
        sp["mlp"] = L.mlp_specs(cfg)
    return sp


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


def _ffn(lp, cfg, h):
    """The block's feed-forward half: (y, aux loss)."""
    if cfg.is_moe:
        return MOE.moe_apply(lp["moe"], cfg, h)
    return L.mlp_apply(lp["mlp"], h), None


def _block(lp, cfg, x, cos, sin):
    """One decoder layer: (x, the MoE aux loss or None, its k, v)."""
    h = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = L.attn_qkv(lp["attn"], cfg, h)
    q, k = L.apply_rope(q, k, cos, sin)
    attn = L.causal_attention(q, k, v, sliding_window=cfg.sliding_window)
    x = x + L.attn_out(lp["attn"], attn, x.dtype)
    h2 = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
    y, a = _ffn(lp, cfg, h2)
    return x + y, a, k, v


def forward(params, cfg, tokens=None, *, embeds=None, positions=None,
            cache=None):
    """Returns (logits, aux_loss).

    ``embeds`` (B, S, d) replaces the token embedding (the VLM's stub
    injection).  ``positions``: (B, S), or (3, B, S) for M-RoPE; 0..S-1
    by default (on all three streams for M-RoPE).  Each layer runs under
    ``cfg.remat``'s checkpoint (``models/remat.py``) unless ``cache``.
    With ``cache`` (``init_cache``'s, at least S slots: the prefill) each
    layer's k and v go into its first S slots as the layer returns, so no
    layer's k and v outlive it, and the logits are the last position's
    alone, (B, 1, V).
    """
    x = (L.embed(params, cfg, tokens) if embeds is None
         else embeds.to(cfg.activation_dtype))
    b, s, _ = x.shape
    if positions is None:
        positions = (L.text_mrope_positions(b, s, x.device)
                     if cfg.mrope_sections
                     else torch.arange(s, device=x.device)[None].expand(b, s))
    cos, sin = L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    aux = torch.zeros((), dtype=F32, device=x.device)

    def body(lp, x, cos, sin):  # the layer ``cfg.remat`` checkpoints
        x, a, _, _ = _block(lp, cfg, x, cos, sin)
        return x if a is None else (x, a)

    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        if cache is not None:  # the prefill: serving keeps no checkpoint
            x, a, k, v = _block(lp, cfg, x, cos, sin)
            _write_kv(cache, cfg, i, k, v)
        else:
            out = checkpoint(body, cfg.remat, lp, x, cos, sin)
            x, a = out if cfg.is_moe else (out, None)
        if a is not None:
            aux = aux + a
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cache is not None:
        x = x[:, -1:]
    return L.unembed(params, cfg, x), aux


def _write_kv(cache, cfg, i: int, k, v):
    """Layer i's k and v (B, S, KV, D) into the cache's first S slots,
    quantised for an int8 cache."""
    s = k.shape[1]
    if cfg.kv_cache_dtype == "int8":
        k, k_scale = L.quantize_kv(k)
        v, v_scale = L.quantize_kv(v)
        cache["k_scale"][i, :, :s] = k_scale
        cache["v_scale"][i, :, :s] = v_scale
    cache["k"][i, :, :s] = k
    cache["v"][i, :, :s] = v


def loss_fn(params, cfg, batch):
    """Mean next-token cross-entropy + the MoE aux loss. batch:
    tokens/labels (B, S)."""
    logits, aux = forward(params, cfg, batch["tokens"])
    return L.cross_entropy(logits, batch["labels"]) + cfg.router_aux_loss * aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_seq: int, device="cpu"):
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {
        "pos": torch.full((batch, max_seq), -1, dtype=torch.int32, device=device),
        "length": 0,
    }
    if cfg.kv_cache_dtype == "int8":
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=F32, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=F32, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
    return cache


def prefill(params, cfg, tokens, *, embeds=None, positions=None,
            max_seq: Optional[int] = None):
    """Run the prompt, return (last-token logits, filled cache).

    The cache is allocated once at ``max_seq`` slots, (L, B, max_seq, KV,
    D), filled layer by layer by ``forward``, and ``decode_step`` writes
    it in place; ``length`` is a Python int.  An int8 cache holds the
    quantised k and v and their scales.
    """
    src = tokens if embeds is None else embeds
    b, s = src.shape[:2]
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    cache = init_cache(cfg, b, max_seq, src.device)
    logits, _ = forward(params, cfg, tokens, embeds=embeds,
                        positions=positions, cache=cache)
    cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32, device=src.device)
    cache["length"] = s
    return logits[:, -1], cache


def decode_step(params, cfg, cache, token, pos: int):
    """One decode step. token: (B,) int; pos: the absolute position, a
    Python int, so that the slot and ``length`` need no copy from the card.

    The cache is updated IN PLACE and returned: the new k and v go into
    slot ``pos`` (``pos % window`` with ``cfg.sliding_window > 0``, where
    the cache's seq dim is the window, a ring buffer).  The reference's
    ``dynamic_update_slice`` makes a functional copy instead; the values
    are the same.  An int8 cache takes the new k and v quantised and
    attends through the plain ``decode_attention_q``, as the reference.
    """
    pos = int(pos)
    x = L.embed(params, cfg, token)[:, None, :]  # (B,1,d)
    b = x.shape[0]
    window = cfg.sliding_window
    s_cache = cache["k"].shape[2]
    slot = pos % max(s_cache, 1) if window > 0 else pos
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections:
        posb = posb.expand(3, b, 1)
    cos, sin = L.rope_cos_sin(posb, cfg.resolved_head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    cache["pos"][:, slot] = pos
    wpos = cache["pos"] if window > 0 else None
    length = min(pos + 1, s_cache)
    quant = cfg.kv_cache_dtype == "int8"
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["attn"], cfg, h)
        q, k = L.apply_rope(q, k, cos, sin)
        if quant:
            ksc, vsc = cache["k_scale"][i], cache["v_scale"][i]
            kc[:, slot], ksc[:, slot] = L.quantize_kv(k[:, 0])
            vc[:, slot], vsc[:, slot] = L.quantize_kv(v[:, 0])
            attn = L.decode_attention_q(q[:, 0], kc, vc, ksc, vsc, length,
                                        window_pos=wpos)
        else:
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
            attn = L.decode_attention(q[:, 0], kc, vc, length, window_pos=wpos)
        x = x + L.attn_out(lp["attn"], attn[:, None], x.dtype)
        h2 = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + _ffn(lp, cfg, h2)[0]
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, cfg, x)[:, 0]
    cache["length"] = length
    return logits, cache
