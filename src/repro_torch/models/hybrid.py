"""Zamba2-style hybrid: a Mamba2 backbone and a SHARED attention block
applied every ``cfg.attn_every`` layers [arXiv:2411.15242]; the port of
``repro/models/hybrid.py``.

The backbone is split into segments of ``attn_every`` mamba layers; the
shared attention block (one weight copy) runs before every segment except
the first.  Because the shared block sees different activations at each
depth, decode keeps a separate KV-cache slot per invocation (``len(
segments(cfg)) - 1`` of them: 13 for Zamba2-7B's 81 layers) while the
weights stay shared.  The Mamba2 layers are ``mamba2.mamba_block``: a
prefill whose length is a multiple of ``ssm_chunk`` goes through the
``ssd_scan`` kernel.

Over a ``model`` axis (``model_axis``) the Mamba2 layers run on the
rank's heads (``models/mamba2.py``) and the shared block on its
attention heads through ``layers.attn_qkv`` / ``attn_out``, as the
dense family's (``layers.head_plan``); its cache slots hold the kv heads
of the rank's q heads, or where the rules cut their ``head_dim``, every
kv head over the rank's block of the ring (``layers.cache_block``).
Over a serve step's ``data`` axis a rank runs its rows of the batch, or
at long_500k (batch 1) the whole batch with its block of the shared
attention's ring (``seq_axis``).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.transformer import layer, stack_specs
from repro_torch.sharding.rules import ParamSpec

F32 = torch.float32


def segments(cfg):
    """Layer counts per segment: [attn_every, attn_every, ..., remainder]."""
    sizes, left = [], cfg.num_layers
    while left > 0:
        take = min(cfg.attn_every, left)
        sizes.append(take)
        left -= take
    return sizes


def param_specs(cfg) -> dict:
    return {
        "embed": L.embed_specs(cfg),
        "layers": stack_specs(M2.block_specs(cfg), cfg.num_layers),
        "shared_attn": {
            "ln": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "attn": L.attn_specs(cfg),
        },
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "unembed": {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="small")
        },
    }


def _shared_attn(params, cfg, x, cos, sin, model_axis=None):
    """The shared block over a whole sequence: (x + attn, k, v: every kv
    head's where the cache's slots are cut, ``layers.slot_cut``)."""
    sp = params["shared_attn"]
    h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
    q, k, v = L.attn_qkv(sp["attn"], cfg, h, model_axis)
    q, k = L.apply_rope(q, k, cos, sin)
    attn = L.causal_attention(q, L.head_kv(k, cfg, model_axis),
                              L.head_kv(v, cfg, model_axis))
    return x + L.attn_out(sp["attn"], attn, x.dtype, cfg, model_axis), k, v


def _cos_sin(cfg, b: int, s: int, device):
    positions = torch.arange(s, device=device)[None].expand(b, s)
    return L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


def forward(params, cfg, tokens, *, train=False, model_axis=None, **_):
    """Logits and a zero aux loss; ``train=True`` runs the Mamba2 layers'
    differentiable chunked SSD in place of the kernel.  Over
    ``model_axis`` the logits are the rank's vocabulary block."""
    x = L.embed(params, cfg, tokens, model_axis)
    cos, sin = _cos_sin(cfg, *tokens.shape, x.device)
    off = 0
    for i, size in enumerate(segments(cfg)):
        if i > 0:
            x = _shared_attn(params, cfg, x, cos, sin, model_axis)[0]
        # the Mamba2 stack, under cfg.remat as the reference's _mamba_scan
        x = M2.layer_stack(params["layers"], cfg, x, range(off, off + size),
                           train, model_axis)
        off += size
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, cfg, x, model_axis)
    return logits, torch.zeros((), dtype=F32, device=x.device)


def loss_fn(params, cfg, batch, model_axis=None, batch_axis=None):
    """Mean next-token cross-entropy (``batch_axis`` as
    ``encdec.loss_fn``'s)."""
    logits, _ = forward(params, cfg, batch["tokens"], train=True,
                        model_axis=model_axis)
    return L.cross_entropy(logits, batch["labels"], cfg, model_axis)


def init_cache(cfg, batch: int, max_seq: int, device="cpu", model_axis=None):
    """The Mamba2 cache and the shared block's (invocations, B, max_seq,
    KV, D) slots: over ``model_axis`` the rank's blocks and the kv heads
    of its q heads (``layers.head_plan``), or every kv head over its
    block of the slots (``layers.cache_block``; the positions whole)."""
    na = len(segments(cfg)) - 1
    shape = (na, batch, L.cache_slots(cfg, model_axis, max_seq),
             len(L.cache_kv(cfg, model_axis)), cfg.resolved_head_dim)
    c = M2.init_cache(cfg, batch, device=device, model_axis=model_axis)
    c["attn_k"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
    c["attn_v"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
    c["pos"] = torch.full((batch, max_seq), -1, dtype=torch.int32, device=device)
    return c


def cache_axes(cfg) -> dict:
    """The recurrent and shared-attention cache's logical dims (the
    reference's)."""
    ax = M2.cache_axes(cfg)
    ax["attn_k"] = ("layers", "batch", "seq", "kv_heads", "head_dim")
    ax["attn_v"] = ("layers", "batch", "seq", "kv_heads", "head_dim")
    ax["pos"] = ("batch", "seq")
    return ax


def prefill(params, cfg, tokens, *, max_seq=None, model_axis=None,
            seq_axis=None, **_):
    """Run the prompt: returns (last logits, recurrent + shared-attn cache),
    the cache allocated once at ``max_seq`` attention slots (``seq_axis``:
    the rank's block of them, ``layers.prompt_slots``)."""
    x = L.embed(params, cfg, tokens, model_axis)
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    slots, first, at = L.prompt_slots(cfg, model_axis, seq_axis, max_seq)
    cache = init_cache(cfg, b, slots, x.device, model_axis)
    cos, sin = _cos_sin(cfg, b, s, x.device)
    off = 0
    for i, size in enumerate(segments(cfg)):
        if i > 0:
            x, k, v = _shared_attn(params, cfg, x, cos, sin, model_axis)
            L.write_block(cache["attn_k"][i - 1], k, at)
            L.write_block(cache["attn_v"][i - 1], v, at)
        for j in range(off, off + size):
            lp = layer(params["layers"], j)
            h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
            y, conv, ssm = M2.mamba_block(lp["mamba"], cfg, h,
                                          collect_cache=True,
                                          model_axis=model_axis)
            x = x + y
            for key, short in M2.CONV_KEYS:
                cache[key][j] = conv[short]
            cache["ssm"][j] = ssm
        off += size
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, cfg, x[:, -1], model_axis)
    L.prompt_positions(cache["pos"], s, first)
    return L.gather_vocab(logits, cfg, model_axis), cache


def decode_step(params, cfg, cache, token, pos: int, model_axis=None,
                seq_axis=None, **_):
    """One step; the cache is updated IN PLACE and returned (the reference
    returns new arrays; the values are the same).

    The shared block's attention slots are a ring of ``max_seq`` slots
    masked by ``window_pos``, as in the reference, whose decode takes its
    plain einsum path there on every backend (its Pallas kernel is not
    called with ``window_pos``); so does this one, which is also why
    Zamba2's head dim 112, outside ``decode_attn``'s (64, 128), never
    reaches the kernel.  ``seq_axis``: the attention slots are the rank's
    block of the ring (every rank runs the whole batch and the whole
    Mamba2 state), as ``transformer.decode_step``'s, and over the model
    axis where the ring's slots are cut there (``layers.slot_cut``).
    """
    pos = int(pos)
    x = L.embed(params, cfg, token, model_axis)[:, None, :]
    b = x.shape[0]
    cut = L.decode_cut(cfg, model_axis, seq_axis, cache["pos"], pos, True)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = L.rope_cos_sin(posb, cfg.resolved_head_dim, cfg.rope_theta)
    sp = params["shared_attn"]
    off = 0
    for i, size in enumerate(segments(cfg)):
        if i > 0:
            ak, av = cache["attn_k"][i - 1], cache["attn_v"][i - 1]
            h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
            q, k, v = L.attn_qkv(sp["attn"], cfg, h, model_axis)
            q, k = L.apply_rope(q, k, cos, sin)
            if cut.slot is not None:
                ak[:, cut.slot] = k[:, 0].to(ak.dtype)
                av[:, cut.slot] = v[:, 0].to(av.dtype)
            attn = L.decode_attention(q[:, 0], ak, av, cut.length, **cut.kw)
            x = x + L.attn_out(sp["attn"], attn[:, None], x.dtype, cfg,
                               model_axis)
        for j in range(off, off + size):
            lp = layer(params["layers"], j)
            h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
            conv = {short: cache[key][j] for key, short in M2.CONV_KEYS}
            y, new_conv, new_ssm = M2.mamba_block(
                lp["mamba"], cfg, h, conv_state=conv,
                ssm_state=cache["ssm"][j], model_axis=model_axis)
            x = x + y
            for key, short in M2.CONV_KEYS:
                cache[key][j] = new_conv[short]
            cache["ssm"][j] = new_ssm
        off += size
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params, cfg, x, model_axis)[:, 0]
    return L.gather_vocab(logits, cfg, model_axis), cache
