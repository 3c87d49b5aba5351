"""Whisper-style encoder-decoder transformer [arXiv:2212.04356]; the port
of ``repro/models/encdec.py``.

The mel-spectrogram + two-conv frontend is a STUB, as in the reference:
``frames`` (B, encoder_seq, d_model) arrive as precomputed frame
embeddings.  Encoder: bidirectional self-attention with sinusoidal
positions.  Decoder: causal self-attention (KV cache) + cross-attention to
the encoder output (cross K/V computed once at prefill) + GELU MLP.
Pre-LN LayerNorm throughout.  At decode the cross-attention reads the
whole encoder cache through the ``decode_attn`` kernel, as the reference's
reaches its Pallas kernel; the self-attention passes ``window_pos`` and
takes the plain einsum path, as the reference's does.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.remat import checkpoint, full_only
from repro_torch.models.transformer import layer, stack_specs
from repro_torch.sharding.rules import ParamSpec

F32 = torch.float32


def _ln_specs(cfg):
    return {
        "scale": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "bias": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }


def _gelu_mlp_specs(cfg):
    return {
        "wi": ParamSpec((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
        "bi": ParamSpec((cfg.d_ff,), ("mlp",), init="zeros"),
        "wo": ParamSpec((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
        "bo": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }


def _gelu_mlp(p, x):
    """``jax.nn.gelu``'s default, the tanh approximation, in f32."""
    h = x @ p["wi"].to(x.dtype) + p["bi"].to(x.dtype)
    h = torch.nn.functional.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    return h @ p["wo"].to(x.dtype) + p["bo"].to(x.dtype)


def _enc_block_specs(cfg):
    return {
        "ln_attn": _ln_specs(cfg),
        "attn": L.attn_specs(cfg),
        "ln_mlp": _ln_specs(cfg),
        "mlp": _gelu_mlp_specs(cfg),
    }


def _dec_block_specs(cfg):
    return {
        "ln_self": _ln_specs(cfg),
        "self_attn": L.attn_specs(cfg),
        "ln_cross": _ln_specs(cfg),
        "cross_attn": L.attn_specs(cfg),
        "ln_mlp": _ln_specs(cfg),
        "mlp": _gelu_mlp_specs(cfg),
    }


def param_specs(cfg) -> dict:
    return {
        "embed": L.embed_specs(cfg),
        "enc_layers": stack_specs(_enc_block_specs(cfg), cfg.encoder_layers),
        "enc_ln_f": _ln_specs(cfg),
        "dec_layers": stack_specs(_dec_block_specs(cfg), cfg.num_layers),
        "dec_ln_f": _ln_specs(cfg),
        "unembed": {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="small")
        },
    }


def _sinusoid(positions, d: int):
    """Sinusoidal embeddings (len(positions), d) in f32."""
    pos = positions.to(F32)[:, None]
    dim = torch.arange(d // 2, dtype=F32, device=positions.device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=positions.device),
                          2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln(p, x, eps):
    return L.layer_norm(x, p["scale"], p["bias"], eps)


def _add_positions(cfg, x, start: int = 0):
    pos = torch.arange(start, start + x.shape[1], device=x.device)
    return x + _sinusoid(pos, cfg.d_model).to(x.dtype)[None]


def encode(params, cfg, frames):
    """frames: (B, encoder_seq, d_model) stub embeddings -> encoder output."""
    x = _add_positions(cfg, frames.to(cfg.activation_dtype))

    def body(lp, x):  # each layer under cfg.remat ("full" only)
        h = _ln(lp["ln_attn"], x, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["attn"], cfg, h)
        attn = L.causal_attention(q, k, v, causal=False)
        x = x + L.attn_out(lp["attn"], attn, x.dtype)
        h = _ln(lp["ln_mlp"], x, cfg.norm_eps)
        return x + _gelu_mlp(lp["mlp"], h)

    policy = full_only(cfg.remat)
    for i in range(cfg.encoder_layers):
        x = checkpoint(body, policy, layer(params["enc_layers"], i), x)
    return _ln(params["enc_ln_f"], x, cfg.norm_eps)


def _cross_kv(lp, cfg, enc_out):
    """One decoder layer's cross-attention k, v (B, encoder_seq, KV, D).
    ``enc_out`` may be a pair (the encoder output for k, for v)."""
    ca = lp["cross_attn"]
    enc_k, enc_v = enc_out if isinstance(enc_out, tuple) else (enc_out,) * 2
    dt = enc_k.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_k, ca["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_v, ca["wv"].to(dt))
    if cfg.qkv_bias:
        k = k + ca["bk"].to(dt)
        v = v + ca["bv"].to(dt)
    return k, v


def cache_axes(cfg) -> dict:
    """The self- and cross-attention caches' logical dims (the
    reference's)."""
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"k": kv, "v": kv,
            "xk": ("layers", "batch", "pos", "kv_heads", "head_dim"),
            "xv": ("layers", "batch", "pos", "kv_heads", "head_dim"),
            "pos": ("batch", "seq")}


def precompute_cross_kv(params, cfg, enc_out):
    """Every decoder layer's cross k, v, stacked (L, B, encoder_seq, KV, D)."""
    kvs = [_cross_kv(layer(params["dec_layers"], i), cfg, enc_out)
           for i in range(cfg.num_layers)]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def _decoder(params, cfg, tokens, enc_out, cache=None):
    """Teacher-forced decoder pass from position 0: the final normed
    activations; with ``cache``, each layer's self and cross k, v are
    written into it."""
    x = _add_positions(cfg, L.embed(params, cfg, tokens))
    s = tokens.shape[1]

    def block(lp, x, enc_out):
        h = _ln(lp["ln_self"], x, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["self_attn"], cfg, h)
        attn = L.causal_attention(q, k, v)
        x = x + L.attn_out(lp["self_attn"], attn, x.dtype)
        h = _ln(lp["ln_cross"], x, cfg.norm_eps)
        q2, _, _ = L.attn_qkv(lp["cross_attn"], cfg, h)
        k2, v2 = _cross_kv(lp, cfg, enc_out)
        xatt = L.causal_attention(q2, k2, v2, causal=False)
        x = x + L.attn_out(lp["cross_attn"], xatt, x.dtype)
        h = _ln(lp["ln_mlp"], x, cfg.norm_eps)
        return x + _gelu_mlp(lp["mlp"], h), k, v, k2, v2

    def body(lp, x, enc_v, enc_k):  # each layer under cfg.remat ("full" only)
        # enc_out comes in twice, for the cross v and k, so that its
        # gradient takes a layer's two parts one at a time, in the order
        # autograd adds them without a checkpoint: the same sums, bit-equal
        return block(lp, x, (enc_k, enc_v))[0]

    policy = full_only(cfg.remat)
    for i in range(cfg.num_layers):
        lp = layer(params["dec_layers"], i)
        if cache is None:
            x = checkpoint(body, policy, lp, x, enc_out, enc_out)
            continue
        x, k, v, k2, v2 = block(lp, x, enc_out)  # serving: no checkpoint
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["xk"][i] = k2
        cache["xv"][i] = v2
    return _ln(params["dec_ln_f"], x, cfg.norm_eps)


def decode_full(params, cfg, tokens, enc_out):
    """Teacher-forced decoder pass (training). tokens: (B, S)."""
    x = _decoder(params, cfg, tokens, enc_out)
    return x @ params["unembed"]["w"].to(x.dtype)


def forward(params, cfg, tokens, *, frames=None, **_):
    enc = encode(params, cfg, frames)
    return (decode_full(params, cfg, tokens, enc),
            torch.zeros((), dtype=F32, device=enc.device))


def loss_fn(params, cfg, batch):
    logits, _ = forward(params, cfg, batch["tokens"], frames=batch["frames"])
    return L.cross_entropy(logits, batch["labels"])


def init_cache(cfg, batch: int, max_seq: int, device="cpu"):
    hd = cfg.resolved_head_dim
    dt = cfg.activation_dtype
    self_shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, hd)
    cross_shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(self_shape, dtype=dt, device=device),
        "v": torch.zeros(self_shape, dtype=dt, device=device),
        # cross-attention K/V, computed from the encoder output at prefill
        "xk": torch.zeros(cross_shape, dtype=dt, device=device),
        "xv": torch.zeros(cross_shape, dtype=dt, device=device),
        "pos": torch.full((batch, max_seq), -1, dtype=torch.int32, device=device),
    }


def prefill(params, cfg, tokens, *, frames=None, max_seq=None, **_):
    """Encoder + teacher-forced decoder prompt pass; returns (last logits,
    cache), the cache allocated once at ``max_seq`` self-attention slots."""
    enc = encode(params, cfg, frames)
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    cache = init_cache(cfg, b, max_seq, enc.device)
    x = _decoder(params, cfg, tokens, enc, cache)
    logits = x[:, -1] @ params["unembed"]["w"].to(x.dtype)
    cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32, device=enc.device)
    return logits, cache


def decode_step(params, cfg, cache, token, pos: int):
    """One step; the cache is updated IN PLACE and returned (the reference
    returns new arrays; the values are the same).

    The self-attention slots are a ring masked by ``window_pos``, and its
    attention is the plain einsum path, as the reference's is on every
    backend; the cross-attention reads each layer's ``xk[l]``, ``xv[l]``
    (contiguous slices of the cache) through ``decode_attn`` with every
    encoder position valid.
    """
    pos = int(pos)
    s_cache = cache["k"].shape[2]
    x = L.embed(params, cfg, token)[:, None, :]
    b = x.shape[0]
    pe_pos = torch.tensor([min(pos, s_cache - 1)], device=x.device)
    x = x + _sinusoid(pe_pos, cfg.d_model).to(x.dtype)[None]
    slot = pos % s_cache
    cache["pos"][:, slot] = pos
    length = min(pos + 1, s_cache)
    enc_len = cache["xk"].shape[2]
    for i in range(cfg.num_layers):
        lp = layer(params["dec_layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = _ln(lp["ln_self"], x, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["self_attn"], cfg, h)
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        attn = L.decode_attention(q[:, 0], kc, vc, length,
                                  window_pos=cache["pos"])
        x = x + L.attn_out(lp["self_attn"], attn[:, None], x.dtype)
        h = _ln(lp["ln_cross"], x, cfg.norm_eps)
        q2, _, _ = L.attn_qkv(lp["cross_attn"], cfg, h)
        xatt = L.decode_attention(q2[:, 0], cache["xk"][i], cache["xv"][i],
                                  enc_len)
        x = x + L.attn_out(lp["cross_attn"], xatt[:, None], x.dtype)
        h = _ln(lp["ln_mlp"], x, cfg.norm_eps)
        x = x + _gelu_mlp(lp["mlp"], h)
    x = _ln(params["dec_ln_f"], x, cfg.norm_eps)
    logits = (x @ params["unembed"]["w"].to(x.dtype))[:, 0]
    return logits, cache
