"""Shared neural building blocks of the LLM families (pure functions over
param dicts); the port of ``repro/models/layers.py``.

Conventions, as in the reference:
* activations in ``cfg.dtype`` (bf16), reductions and softmax in f32;
* prefill attention is the chunked online softmax over KV chunks, written
  out in torch (not SDPA) so that it stays comparable with the reference;
* GQA repeats KV heads at compute time;
* plain RoPE and Qwen2-VL's M-RoPE (t/h/w sections of the frequencies);
* decode attends one token against a KV cache, either through the
  ``decode_attn`` kernel (``kernels/ops.py``) or, in ring-buffer
  (``window_pos``) mode, through the plain einsum path;
* the int8 KV cache (``quantize_kv``, ``decode_attention_q``) is plain
  torch, as the reference's is plain ``jnp`` outside any kernel.

Not in this package: the reference's mesh-only ``_replicate`` (a sharding
constraint, the identity outside a mesh).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.rules import ParamSpec

F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.to(F32)).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(F32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_cos_sin(positions, head_dim: int, theta: float,
                 sections: Tuple[int, ...] = ()):
    """cos/sin tables (B, S, head_dim/2) in f32.

    positions: (B, S) for plain RoPE, or (3, B, S) for M-RoPE, where the
    frequency slots are split into contiguous (t, h, w) ``sections`` and
    each section reads its own positional stream (Qwen2-VL §2.1).  As in
    the reference, a section past the head_dim/2 slots is cut short
    silently: the reduced Qwen2-VL (head_dim 64, sections (16, 24, 24))
    gives t slots 0-15, h slots 16-31 and w none.
    """
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(F32)[..., None] * inv
    if sections:
        if positions.dim() != 3 or positions.shape[0] != len(sections):
            raise ValueError(f"M-RoPE needs positions ({len(sections)}, B, S), "
                             f"got {tuple(positions.shape)}")
        pieces, off = [], 0
        for i, sec in enumerate(sections):
            pieces.append(ang[i, ..., off:off + sec])
            off += sec
        ang = torch.cat(pieces, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(q, k, cos, sin):
    """q: (B,S,H,D), k: (B,S,KV,D); cos/sin: (B,S,D/2)."""
    c = cos[:, :, None, :].to(F32)
    s = sin[:, :, None, :].to(F32)
    qf = _rotate(q.to(F32), c, s).to(q.dtype)
    kf = _rotate(k.to(F32), c, s).to(k.dtype)
    return qf, kf


def text_mrope_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """For pure-text streams all three M-RoPE position channels coincide."""
    pos = torch.arange(seq, device=device)
    return pos.expand(3, batch, seq)


# ---------------------------------------------------------------------------
# Attention (online softmax over KV chunks)
# ---------------------------------------------------------------------------


def _repeat_kv(k, groups: int):
    if groups == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(
        b, s, kv * groups, d)


def causal_attention(q, k, v, *, chunk: int = 1024, sliding_window: int = 0,
                     causal: bool = True):
    """Memory-efficient attention from position 0; causal unless
    ``causal=False`` (the encoder and cross-attention).

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  The online softmax runs over
    KV chunks of ``chunk`` keys, so peak memory is O(Sq * chunk) per head.
    The last chunk is cut short instead of padded: the reference's padded
    keys are masked to -inf and add nothing.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    groups = h // max(kv, 1)
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, sk)

    qf = q.to(F32)
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), -torch.inf, dtype=F32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=F32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=F32, device=q.device)
    for start in range(0, sk, chunk):
        kb = k[:, start:start + chunk].to(F32)
        vb = v[:, start:start + chunk].to(F32)
        k_pos = start + torch.arange(kb.shape[1], device=q.device)
        s_ = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            if sliding_window:
                mask &= q_pos[:, None] - k_pos[None, :] < sliding_window
            s_ = torch.where(mask[None, None], s_, -torch.inf)
        m_new = torch.maximum(m, s_.amax(-1))
        p = torch.exp(s_ - m_new[..., None])
        p = torch.where(torch.isfinite(m_new)[..., None], p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)  # (B,Sq,H,D)


def decode_attention(q, k_cache, v_cache, length: int, *,
                     window_pos: Optional[torch.Tensor] = None):
    """Single-token attention against a KV cache.

    q: (B, H, D); caches: (B, S, KV, D); ``length``: number of valid cache
    entries (a Python int).  Without ``window_pos`` this is the
    ``decode_attn`` kernel (its plain version on the CPU).  ``window_pos``
    (ring-buffer mode): absolute positions per cache slot (B, S), -1 for an
    empty slot, used for masking instead of the slot index; that mode is
    the reference's plain einsum path here as there.
    """
    if window_pos is None:
        return ops.decode_attn(q, k_cache, v_cache, length)
    b, s, kv, d = k_cache.shape
    h = q.shape[1]
    groups = h // max(kv, 1)
    qf = q.to(F32).reshape(b, kv, groups, d)
    s_ = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(F32)) / math.sqrt(d)
    valid = window_pos >= 0
    s_ = torch.where(valid[:, None, None, :], s_, -torch.inf)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return out.reshape(b, h, d).to(q.dtype)


def quantize_kv(x):
    """Symmetric per-(token, head) int8 quantisation. x: (..., S, KV, D).

    Returns (int8 values, f32 scales (..., S, KV)): halves the decode
    cache's bytes against bf16."""
    xf = x.to(F32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_attention_q(q, kq, vq, k_scale, v_scale, length: int, *,
                       window_pos: Optional[torch.Tensor] = None):
    """``decode_attention`` over an int8 cache; the scales multiply the
    score and probability rows, so the dequantised cache never exists.
    Plain torch, as the reference's is plain ``jnp``.

    q: (B, H, D); kq, vq: (B, S, KV, D) int8; scales: (B, S, KV) f32."""
    b, s, kv, d = kq.shape
    h = q.shape[1]
    groups = h // max(kv, 1)
    qf = q.to(F32).reshape(b, kv, groups, d)
    s_ = torch.einsum("bkgd,bskd->bkgs", qf, kq.to(F32)) / math.sqrt(d)
    s_ = s_ * k_scale.permute(0, 2, 1)[:, :, None, :]  # (B,KV,1,S)
    if window_pos is None:
        valid = (torch.arange(s, device=q.device) < length)[None].expand(b, s)
    else:
        valid = window_pos >= 0
    s_ = torch.where(valid[:, None, None, :], s_, -torch.inf)
    p = torch.softmax(s_, dim=-1)
    p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, vq.to(F32))
    return out.reshape(b, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block parameter specs + apply
# ---------------------------------------------------------------------------


def attn_specs(cfg) -> dict:
    hd = cfg.resolved_head_dim
    sp = {
        "wq": ParamSpec((cfg.d_model, cfg.num_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((cfg.d_model, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((cfg.d_model, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.num_heads, hd, cfg.d_model), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((cfg.num_heads, hd), ("heads", "head_dim"), init="zeros")
        sp["bk"] = ParamSpec((cfg.num_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
        sp["bv"] = ParamSpec((cfg.num_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        sp["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return sp


def attn_qkv(p, cfg, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_out(p, x_attn, dtype):
    return torch.einsum("bshk,hkd->bsd", x_attn, p["wo"].to(dtype))


# ---------------------------------------------------------------------------
# MLP (SwiGLU) + embeddings
# ---------------------------------------------------------------------------


def mlp_specs(cfg) -> dict:
    ff = cfg.d_ff
    return {
        "wi_gate": ParamSpec((cfg.d_model, ff), ("embed", "mlp")),
        "wi_up": ParamSpec((cfg.d_model, ff), ("embed", "mlp")),
        "wo": ParamSpec((ff, cfg.d_model), ("mlp", "embed")),
    }


def silu_f32(x):
    """silu computed in f32 and returned in x's dtype (the reference's
    ``jax.nn.silu(x.astype(f32)).astype(x.dtype)``)."""
    return torch.nn.functional.silu(x.to(F32)).to(x.dtype)


def mlp_apply(p, x):
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    return (silu_f32(g) * u) @ p["wo"].to(x.dtype)


def cross_entropy(logits, labels):
    """Mean next-token cross-entropy over all positions, in f32."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - label_logit)


def embed_specs(cfg) -> dict:
    return {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="small")}


def embed(params, cfg, tokens):
    return params["embed"]["tok"][tokens.long()].to(cfg.activation_dtype)


def unembed(params, cfg, x):
    """Project to vocab logits (tied or untied)."""
    if cfg.tie_embeddings:
        return x @ params["embed"]["tok"].to(x.dtype).T
    return x @ params["unembed"]["w"].to(x.dtype)
