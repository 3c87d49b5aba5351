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

``model_axis`` (a ``sharding.collectives.ModelAxis``, an explicit
argument of every entry point): the blocks run tensor-parallel on
the rank's parameter blocks (``models/layers.py``).  ``forward`` then
returns the rank's vocabulary block of the logits, ``loss_fn`` the whole
loss, ``prefill`` and ``decode_step`` the whole logits; the KV cache
holds the kv heads of the rank's q heads (``layers.head_plan``: its
block of them when they divide over the axis), and each decode step runs
``decode_attn`` on the rank's (B, H/M, KV/M, S, D).  Where the kv heads
do not divide and the rules cut the cache's ``head_dim`` instead, the
rank holds every kv head over its block of the slots
(``layers.cache_block``): each decode attends over it through the
kernel's partials entry and merges over the axis (``layers.
decode_attention``).  The MoE blocks run on the rank's experts
(``models/moe.py``).

Over a serve step's ``data`` axis (``launch/steps.py``) a rank runs its
rows of the batch (``data_axis``: only the MoE dispatch, whose groups may
span ranks, exchanges anything), or, where the batch does not divide,
the whole batch over its block of the cache's slots (``seq_axis``), the
model axis's block nested in it.
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


def _ffn(lp, cfg, h, model_axis=None, data_axis=None, batch_axis=None):
    """The block's feed-forward half: (y, aux loss)."""
    if cfg.is_moe:
        return MOE.moe_apply(lp["moe"], cfg, h, model_axis, data_axis,
                             batch_axis)
    return L.mlp_apply(lp["mlp"], h, model_axis, cfg.d_ff), None


def _block(lp, cfg, x, cos, sin, model_axis=None, data_axis=None,
           batch_axis=None):
    """One decoder layer: (x, the MoE aux loss or None, its k, v: every
    kv head's where a serve cache's slots are cut, ``layers.slot_cut``)."""
    h = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = L.attn_qkv(lp["attn"], cfg, h, model_axis)
    q, k = L.apply_rope(q, k, cos, sin)
    attn = L.causal_attention(q, L.head_kv(k, cfg, model_axis),
                              L.head_kv(v, cfg, model_axis),
                              sliding_window=cfg.sliding_window)
    x = x + L.attn_out(lp["attn"], attn, x.dtype, cfg, model_axis)
    h2 = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
    y, a = _ffn(lp, cfg, h2, model_axis, data_axis, batch_axis)
    return x + y, a, k, v


def forward(params, cfg, tokens=None, *, embeds=None, positions=None,
            cache=None, cache_at: int = 0, model_axis=None, data_axis=None,
            batch_axis=None):
    """Returns (logits, aux_loss).

    ``embeds`` (B, S, d) replaces the token embedding (the VLM's stub
    injection).  ``positions``: (B, S), or (3, B, S) for M-RoPE; 0..S-1
    by default (on all three streams for M-RoPE).  Each layer runs under
    ``cfg.remat``'s checkpoint (``models/remat.py``) unless ``cache``.
    With ``cache`` (``init_cache``'s: the prefill) each layer's k and v
    go into its slots as the layer returns, so no layer's k and v outlive
    it, and the logits are the last position's alone, (B, 1, V); the
    cache's slot 0 is the whole cache's ``cache_at`` (a rank's block,
    ``layers.prompt_slots``).  Over ``model_axis`` the logits are the rank's
    vocabulary block.  ``data_axis``: the batch is the rank's rows of a
    serve step's batch split over it (only the MoE dispatch reads it).
    ``batch_axis``: the batch is the rank's rows of a training client's
    batch split over it, and the MoE's routing and aux loss are the
    whole batch's (``moe.moe_apply``).
    """
    x = (L.embed(params, cfg, tokens, model_axis) if embeds is None
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
        x, a, _, _ = _block(lp, cfg, x, cos, sin, model_axis, data_axis,
                            batch_axis)
        return x if a is None else (x, a)

    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        if cache is not None:  # the prefill: serving keeps no checkpoint
            x, a, k, v = _block(lp, cfg, x, cos, sin, model_axis,
                                data_axis)
            _write_kv(cache, cfg, i, k, v, cache_at)
        else:
            out = checkpoint(body, cfg.remat, lp, x, cos, sin)
            x, a = out if cfg.is_moe else (out, None)
        if a is not None:
            aux = aux + a
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cache is not None:
        x = x[:, -1:]
    return L.unembed(params, cfg, x, model_axis), aux


def _write_kv(cache, cfg, i: int, k, v, at: int = 0):
    """Layer i's k and v (B, S, KV, D) into the cache's slots, whose slot
    0 is the whole cache's ``at`` (``layers.write_block``), quantised for
    an int8 cache."""
    if cfg.kv_cache_dtype == "int8":
        k, k_scale = L.quantize_kv(k)
        v, v_scale = L.quantize_kv(v)
        L.write_block(cache["k_scale"][i], k_scale, at)
        L.write_block(cache["v_scale"][i], v_scale, at)
    L.write_block(cache["k"][i], k, at)
    L.write_block(cache["v"][i], v, at)


def loss_fn(params, cfg, batch, model_axis=None, batch_axis=None):
    """Mean next-token cross-entropy + the MoE aux loss. batch:
    tokens/labels (B, S): over ``batch_axis`` the rank's rows of a
    client's batch, the aux loss the whole batch's (the same on every
    rank) and the cross-entropy the mean over the rank's rows."""
    logits, aux = forward(params, cfg, batch["tokens"], model_axis=model_axis,
                          batch_axis=batch_axis)
    return (L.cross_entropy(logits, batch["labels"], cfg, model_axis)
            + cfg.router_aux_loss * aux)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_seq: int, device="cpu", model_axis=None):
    """The KV cache (L, B, max_seq, KV, D) and its slots' positions (B,
    max_seq): over ``model_axis`` the kv heads of the rank's q heads
    (``layers.head_plan``), or where the rules cut the cache's
    ``head_dim``, every kv head over the rank's block of the slots
    (``layers.cache_block``; the positions stay whole)."""
    shape = (cfg.num_layers, batch, L.cache_slots(cfg, model_axis, max_seq),
             len(L.cache_kv(cfg, model_axis)), cfg.resolved_head_dim)
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
            max_seq: Optional[int] = None, model_axis=None, data_axis=None,
            seq_axis=None):
    """Run the prompt, return (last-token logits, filled cache).

    The cache is allocated once at ``max_seq`` slots, (L, B, max_seq, KV,
    D), filled layer by layer by ``forward``, and ``decode_step`` writes
    it in place; ``length`` is a Python int.  An int8 cache holds the
    quantised k and v and their scales.  ``data_axis`` as ``forward``'s;
    ``seq_axis`` (a data axis the batch does not divide over): every rank
    runs the whole prompt and keeps its block of the slots
    (``layers.prompt_slots``).
    """
    src = tokens if embeds is None else embeds
    b, s = src.shape[:2]
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    slots, first, at = L.prompt_slots(cfg, model_axis, seq_axis, max_seq)
    cache = init_cache(cfg, b, slots, src.device, model_axis)
    logits, _ = forward(params, cfg, tokens, embeds=embeds,
                        positions=positions, cache=cache, cache_at=at,
                        model_axis=model_axis, data_axis=data_axis)
    L.prompt_positions(cache["pos"], s, first)
    cache["length"] = s
    return L.gather_vocab(logits[:, -1], cfg, model_axis), cache


def decode_step(params, cfg, cache, token, pos: int, model_axis=None,
                data_axis=None, seq_axis=None):
    """One decode step. token: (B,) int; pos: the absolute position, a
    Python int, so that the slot and ``length`` need no copy from the card.

    The cache is updated IN PLACE and returned: the new k and v go into
    slot ``pos`` (``pos % window`` with ``cfg.sliding_window > 0``, where
    the cache's seq dim is the window, a ring buffer).  The reference's
    ``dynamic_update_slice`` makes a functional copy instead; the values
    are the same.  An int8 cache takes the new k and v quantised and
    attends through the plain ``decode_attention_q``, as the reference.

    ``data_axis``: the batch is the rank's rows (the MoE dispatch reads
    it).  ``seq_axis``: the cache holds the rank's block of the slots
    (every rank the whole batch): the window is the whole cache's, the
    token's k, v and position go to the rank that owns its slot, and each
    attention runs over the rank's slots and is merged over the axis
    (``layers.decode_attention``), as over the model axis where the
    cache's slots are cut there (``layers.slot_cut``; the positions are
    whole on it, the k and v its block).
    """
    pos = int(pos)
    x = L.embed(params, cfg, token, model_axis)[:, None, :]  # (B,1,d)
    b = x.shape[0]
    cut = L.decode_cut(cfg, model_axis, seq_axis, cache["pos"], pos,
                       cfg.sliding_window > 0)
    slot, length, kw = cut.slot, cut.length, cut.kw
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections:
        posb = posb.expand(3, b, 1)
    cos, sin = L.rope_cos_sin(posb, cfg.resolved_head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    quant = cfg.kv_cache_dtype == "int8"
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["attn"], cfg, h, model_axis)
        q, k = L.apply_rope(q, k, cos, sin)
        if quant:
            ksc, vsc = cache["k_scale"][i], cache["v_scale"][i]
            if slot is not None:
                kc[:, slot], ksc[:, slot] = L.quantize_kv(k[:, 0])
                vc[:, slot], vsc[:, slot] = L.quantize_kv(v[:, 0])
            attn = L.decode_attention_q(q[:, 0], kc, vc, ksc, vsc, length,
                                        **kw)
        else:
            if slot is not None:
                kc[:, slot] = k[:, 0].to(kc.dtype)
                vc[:, slot] = v[:, 0].to(vc.dtype)
            attn = L.decode_attention(q[:, 0], kc, vc, length, **kw)
        x = x + L.attn_out(lp["attn"], attn[:, None], x.dtype, cfg,
                           model_axis)
        h2 = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + _ffn(lp, cfg, h2, model_axis, data_axis)[0]
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.gather_vocab(L.unembed(params, cfg, x, model_axis)[:, 0], cfg,
                            model_axis)
    cache["length"] = cut.token.length
    return logits, cache
