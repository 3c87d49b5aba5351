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


def _shared_attn(params, cfg, x, cos, sin):
    """The shared block over a whole sequence: (x + attn, k, v)."""
    sp = params["shared_attn"]
    h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
    q, k, v = L.attn_qkv(sp["attn"], cfg, h)
    q, k = L.apply_rope(q, k, cos, sin)
    attn = L.causal_attention(q, k, v)
    return x + L.attn_out(sp["attn"], attn, x.dtype), k, v


def _cos_sin(cfg, b: int, s: int, device):
    positions = torch.arange(s, device=device)[None].expand(b, s)
    return L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


def forward(params, cfg, tokens, *, train=False, **_):
    """Logits and a zero aux loss; ``train=True`` runs the Mamba2 layers'
    differentiable chunked SSD in place of the kernel."""
    x = L.embed(params, cfg, tokens)
    cos, sin = _cos_sin(cfg, *tokens.shape, x.device)
    off = 0
    for i, size in enumerate(segments(cfg)):
        if i > 0:
            x = _shared_attn(params, cfg, x, cos, sin)[0]
        # the Mamba2 stack, under cfg.remat as the reference's _mamba_scan
        x = M2.layer_stack(params["layers"], cfg, x, range(off, off + size),
                           train)
        off += size
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ params["unembed"]["w"].to(x.dtype)
    return logits, torch.zeros((), dtype=F32, device=x.device)


def loss_fn(params, cfg, batch):
    logits, _ = forward(params, cfg, batch["tokens"], train=True)
    return L.cross_entropy(logits, batch["labels"])


def init_cache(cfg, batch: int, max_seq: int, device="cpu"):
    na = len(segments(cfg)) - 1
    shape = (na, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    c = M2.init_cache(cfg, batch, device=device)
    c["attn_k"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
    c["attn_v"] = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
    c["pos"] = torch.full((batch, max_seq), -1, dtype=torch.int32, device=device)
    return c


def prefill(params, cfg, tokens, *, max_seq=None, **_):
    """Run the prompt: returns (last logits, recurrent + shared-attn cache),
    the cache allocated once at ``max_seq`` attention slots."""
    x = L.embed(params, cfg, tokens)
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    cache = init_cache(cfg, b, max_seq, x.device)
    cos, sin = _cos_sin(cfg, b, s, x.device)
    off = 0
    for i, size in enumerate(segments(cfg)):
        if i > 0:
            x, k, v = _shared_attn(params, cfg, x, cos, sin)
            cache["attn_k"][i - 1, :, :s] = k
            cache["attn_v"][i - 1, :, :s] = v
        for j in range(off, off + size):
            lp = layer(params["layers"], j)
            h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
            y, conv, ssm = M2.mamba_block(lp["mamba"], cfg, h, collect_cache=True)
            x = x + y
            for key, short in M2.CONV_KEYS:
                cache[key][j] = conv[short]
            cache["ssm"][j] = ssm
        off += size
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x[:, -1] @ params["unembed"]["w"].to(x.dtype)
    cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32, device=x.device)
    return logits, cache


def decode_step(params, cfg, cache, token, pos: int):
    """One step; the cache is updated IN PLACE and returned (the reference
    returns new arrays; the values are the same).

    The shared block's attention slots are a ring of ``max_seq`` slots
    masked by ``window_pos``, as in the reference, whose decode takes its
    plain einsum path there on every backend (its Pallas kernel is not
    called with ``window_pos``); so does this one, which is also why
    Zamba2's head dim 112, outside ``decode_attn``'s (64, 128), never
    reaches the kernel.
    """
    pos = int(pos)
    x = L.embed(params, cfg, token)[:, None, :]
    b = x.shape[0]
    s_cache = cache["attn_k"].shape[2]
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = L.rope_cos_sin(posb, cfg.resolved_head_dim, cfg.rope_theta)
    slot = pos % s_cache
    cache["pos"][:, slot] = pos
    length = min(pos + 1, s_cache)
    sp = params["shared_attn"]
    off = 0
    for i, size in enumerate(segments(cfg)):
        if i > 0:
            ak, av = cache["attn_k"][i - 1], cache["attn_v"][i - 1]
            h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
            q, k, v = L.attn_qkv(sp["attn"], cfg, h)
            q, k = L.apply_rope(q, k, cos, sin)
            ak[:, slot] = k[:, 0].to(ak.dtype)
            av[:, slot] = v[:, 0].to(av.dtype)
            attn = L.decode_attention(q[:, 0], ak, av, length,
                                      window_pos=cache["pos"])
            x = x + L.attn_out(sp["attn"], attn[:, None], x.dtype)
        for j in range(off, off + size):
            lp = layer(params["layers"], j)
            h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
            conv = {short: cache[key][j] for key, short in M2.CONV_KEYS}
            y, new_conv, new_ssm = M2.mamba_block(
                lp["mamba"], cfg, h, conv_state=conv, ssm_state=cache["ssm"][j])
            x = x + y
            for key, short in M2.CONV_KEYS:
                cache[key][j] = new_conv[short]
            cache["ssm"][j] = new_ssm
        off += size
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ params["unembed"]["w"].to(x.dtype))[:, 0]
    return logits, cache
