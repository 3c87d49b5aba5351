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

Tensor-parallel over ``model_axis`` (a ``sharding.collectives.ModelAxis``
on every entry point), through ``models/layers.py``'s layers: the
attentions over the rank's heads (``attn_qkv`` / ``attn_q`` column-
parallel, ``attn_out`` row-parallel), the GELU MLP with ``wi`` and ``bi``
column-parallel and ``wo`` row-parallel (``bo`` added once, after the
all-reduce), the embedding, unembedding and loss vocab-parallel where the
vocabulary divides (Whisper-large-v3's 51,866 does not over 4: whole
there).  The encoder output enters the decoder's cross-attentions through
one ``copy_to``, and each layer's cross k, v and the cache's ``xk`` /
``xv`` hold the rank's kv heads, so ``decode_attn`` runs on the rank's
(B, H/M, KV/M, encoder_seq, D).  Where the heads do not divide (20 on 8)
every rank runs every head, and as the rules cut the caches' ``head_dim``
there, each rank holds every kv head over its block of each cache's
slots (``layers.cache_block``: 188 of the 1,500 cross slots at M = 8);
its attentions merge the blocks' partials over the axis.  ``forward``
returns the rank's vocabulary block of the logits, ``loss_fn`` the whole
loss, ``prefill`` and ``decode_step`` the whole logits.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.remat import checkpoint, full_only
from repro_torch.models.transformer import layer, stack_specs
from repro_torch.sharding import collectives as C
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


def _gelu_mlp(p, x, cfg=None, model_axis=None):
    """``jax.nn.gelu``'s default, the tanh approximation, in f32; over a
    model axis whose rank holds its ``mlp`` block of the hidden units,
    column- then row-parallel, an all-reduce and then ``bo``."""
    split = cfg is not None and p["bi"].shape[0] != cfg.d_ff
    if split:
        x = C.copy_to(x, model_axis)
    h = x @ p["wi"].to(x.dtype) + p["bi"].to(x.dtype)
    h = torch.nn.functional.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    y = h @ p["wo"].to(x.dtype)
    if split:
        y = C.reduce_from(y, model_axis)
    return y + p["bo"].to(x.dtype)


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


def encode(params, cfg, frames, model_axis=None):
    """frames: (B, encoder_seq, d_model) stub embeddings -> encoder output."""
    x = _add_positions(cfg, frames.to(cfg.activation_dtype))

    def body(lp, x):  # each layer under cfg.remat ("full" only)
        h = _ln(lp["ln_attn"], x, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["attn"], cfg, h, model_axis)
        attn = L.causal_attention(q, L.head_kv(k, cfg, model_axis),
                                  L.head_kv(v, cfg, model_axis), causal=False)
        x = x + L.attn_out(lp["attn"], attn, x.dtype, cfg, model_axis)
        h = _ln(lp["ln_mlp"], x, cfg.norm_eps)
        return x + _gelu_mlp(lp["mlp"], h, cfg, model_axis)

    policy = full_only(cfg.remat)
    for i in range(cfg.encoder_layers):
        x = checkpoint(body, policy, layer(params["enc_layers"], i), x)
    return _ln(params["enc_ln_f"], x, cfg.norm_eps)


def _cross_kv(lp, cfg, enc_out, model_axis=None):
    """One decoder layer's cross-attention k, v (B, encoder_seq, KV, D),
    of the rank's kv heads over a model axis (every kv head where the
    caches' slots are cut, ``layers.slot_cut``).  ``enc_out`` may be a
    pair (the encoder output for k, for v)."""
    ca = L.head_leaves(lp["cross_attn"], cfg, model_axis, L.KV_KEYS)
    enc_k, enc_v = enc_out if isinstance(enc_out, tuple) else (enc_out,) * 2
    dt = enc_k.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_k, ca["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_v, ca["wv"].to(dt))
    if cfg.qkv_bias:
        k = k + ca["bk"].to(dt)
        v = v + ca["bv"].to(dt)
    return k, v


def _to_cross(cfg, enc_out, model_axis):
    """The encoder output as the cross-attentions take it: through
    ``copy_to`` where each rank runs its block of the heads (their k and
    v projections are column-parallel), so that its gradient is summed
    over the ranks once."""
    if L._split(model_axis) and L.head_plan(cfg, model_axis).split:
        return C.copy_to(enc_out, model_axis)
    return enc_out


def cache_axes(cfg) -> dict:
    """The self- and cross-attention caches' logical dims (the
    reference's)."""
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"k": kv, "v": kv,
            "xk": ("layers", "batch", "pos", "kv_heads", "head_dim"),
            "xv": ("layers", "batch", "pos", "kv_heads", "head_dim"),
            "pos": ("batch", "seq")}


def precompute_cross_kv(params, cfg, enc_out, model_axis=None):
    """Every decoder layer's cross k, v, stacked (L, B, encoder_seq, KV, D)."""
    kvs = [_cross_kv(layer(params["dec_layers"], i), cfg, enc_out, model_axis)
           for i in range(cfg.num_layers)]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def _decoder(params, cfg, tokens, enc_out, cache=None, model_axis=None,
             at: int = 0):
    """Teacher-forced decoder pass from position 0: the final normed
    activations; with ``cache``, each layer's self and cross k, v are
    written into it (its self slot 0 the whole cache's ``at``; the
    rank's blocks where the caches' slots are cut, ``layers.
    cache_block``)."""
    x = _add_positions(cfg, L.embed(params, cfg, tokens, model_axis))
    enc_out = _to_cross(cfg, enc_out, model_axis)
    ma = model_axis
    xblk = L.cache_block(cfg, ma, enc_out.shape[1])

    def own(k, v):  # the kv heads of the rank's q heads
        return L.head_kv(k, cfg, ma), L.head_kv(v, cfg, ma)

    def block(lp, x, enc_out):
        h = _ln(lp["ln_self"], x, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["self_attn"], cfg, h, ma)
        attn = L.causal_attention(q, *own(k, v))
        x = x + L.attn_out(lp["self_attn"], attn, x.dtype, cfg, ma)
        h = _ln(lp["ln_cross"], x, cfg.norm_eps)
        q2 = L.attn_q(lp["cross_attn"], cfg, h, ma)
        k2, v2 = _cross_kv(lp, cfg, enc_out, ma)
        xatt = L.causal_attention(q2, *own(k2, v2), causal=False)
        x = x + L.attn_out(lp["cross_attn"], xatt, x.dtype, cfg, ma)
        h = _ln(lp["ln_mlp"], x, cfg.norm_eps)
        return x + _gelu_mlp(lp["mlp"], h, cfg, ma), k, v, k2, v2

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
        L.write_block(cache["k"][i], k, at)
        L.write_block(cache["v"][i], v, at)
        cache["xk"][i] = k2 if xblk is None else k2[:, xblk]
        cache["xv"][i] = v2 if xblk is None else v2[:, xblk]
    return _ln(params["dec_ln_f"], x, cfg.norm_eps)


def decode_full(params, cfg, tokens, enc_out, model_axis=None):
    """Teacher-forced decoder pass (training). tokens: (B, S).  Over a
    model axis, the rank's vocabulary block of the logits."""
    x = _decoder(params, cfg, tokens, enc_out, model_axis=model_axis)
    return L.unembed(params, cfg, x, model_axis)


def forward(params, cfg, tokens, *, frames=None, model_axis=None, **_):
    enc = encode(params, cfg, frames, model_axis)
    return (decode_full(params, cfg, tokens, enc, model_axis),
            torch.zeros((), dtype=F32, device=enc.device))


def loss_fn(params, cfg, batch, model_axis=None, batch_axis=None):
    """Mean next-token cross-entropy: a mean of the samples' losses, so a
    client's batch split over ``batch_axis`` needs nothing from it."""
    logits, _ = forward(params, cfg, batch["tokens"], frames=batch["frames"],
                        model_axis=model_axis)
    return L.cross_entropy(logits, batch["labels"], cfg, model_axis)


def init_cache(cfg, batch: int, max_seq: int, device="cpu", model_axis=None):
    """The self- and cross-attention caches: over ``model_axis`` the kv
    heads of the rank's q heads (``layers.head_plan``), or every kv head
    over the rank's block of each cache's slots (``layers.cache_block``;
    the positions whole)."""
    hd = cfg.resolved_head_dim
    dt = cfg.activation_dtype
    kv = len(L.cache_kv(cfg, model_axis))
    self_shape = (cfg.num_layers, batch,
                  L.cache_slots(cfg, model_axis, max_seq), kv, hd)
    cross_shape = (cfg.num_layers, batch,
                   L.cache_slots(cfg, model_axis, cfg.encoder_seq), kv, hd)
    return {
        "k": torch.zeros(self_shape, dtype=dt, device=device),
        "v": torch.zeros(self_shape, dtype=dt, device=device),
        # cross-attention K/V, computed from the encoder output at prefill
        "xk": torch.zeros(cross_shape, dtype=dt, device=device),
        "xv": torch.zeros(cross_shape, dtype=dt, device=device),
        "pos": torch.full((batch, max_seq), -1, dtype=torch.int32, device=device),
    }


def prefill(params, cfg, tokens, *, frames=None, max_seq=None,
            model_axis=None, seq_axis=None, **_):
    """Encoder + teacher-forced decoder prompt pass; returns (last logits,
    cache), the cache allocated once at ``max_seq`` self-attention slots
    (``seq_axis``: the rank's block of them, ``layers.prompt_slots``)."""
    enc = encode(params, cfg, frames, model_axis)
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    slots, first, at = L.prompt_slots(cfg, model_axis, seq_axis, max_seq)
    cache = init_cache(cfg, b, slots, enc.device, model_axis)
    x = _decoder(params, cfg, tokens, enc, cache, model_axis, at)
    logits = L.gather_vocab(L.unembed(params, cfg, x[:, -1], model_axis), cfg,
                            model_axis)
    L.prompt_positions(cache["pos"], s, first)
    return logits, cache


def decode_step(params, cfg, cache, token, pos: int, model_axis=None,
                seq_axis=None, **_):
    """One step; the cache is updated IN PLACE and returned (the reference
    returns new arrays; the values are the same).

    The self-attention slots are a ring masked by ``window_pos``, and its
    attention is the plain einsum path, as the reference's is on every
    backend; the cross-attention reads each layer's ``xk[l]``, ``xv[l]``
    (contiguous slices of the cache) through ``decode_attn`` with every
    encoder position valid.  ``seq_axis``: the self-attention slots are
    the rank's block of the ring, as ``transformer.decode_step``'s; where
    both caches' slots are cut over the model axis (``layers.slot_cut``)
    each attention runs over the rank's block of them (the cross one
    through the kernel's partials entry) and merges over the axis.
    """
    pos = int(pos)
    ma = model_axis
    cut = L.decode_cut(cfg, ma, seq_axis, cache["pos"], pos, True)
    slot = cut.slot
    x = L.embed(params, cfg, token, ma)[:, None, :]
    pe_pos = torch.tensor([min(pos, cut.token.window - 1)], device=x.device)
    x = x + _sinusoid(pe_pos, cfg.d_model).to(x.dtype)[None]
    cross = dict(slot_axis=cut.slot_axis, rows=cut.rows)
    enc_len = cache["xk"].shape[2]  # the rank's cross slots, all valid
    for i in range(cfg.num_layers):
        lp = layer(params["dec_layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = _ln(lp["ln_self"], x, cfg.norm_eps)
        q, k, v = L.attn_qkv(lp["self_attn"], cfg, h, ma)
        if slot is not None:
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
        attn = L.decode_attention(q[:, 0], kc, vc, cut.length, **cut.kw)
        x = x + L.attn_out(lp["self_attn"], attn[:, None], x.dtype, cfg, ma)
        h = _ln(lp["ln_cross"], x, cfg.norm_eps)
        q2 = L.attn_q(lp["cross_attn"], cfg, h, ma)
        xatt = L.decode_attention(q2[:, 0], cache["xk"][i], cache["xv"][i],
                                  enc_len, **cross)
        x = x + L.attn_out(lp["cross_attn"], xatt[:, None], x.dtype, cfg, ma)
        h = _ln(lp["ln_mlp"], x, cfg.norm_eps)
        x = x + _gelu_mlp(lp["mlp"], h, cfg, ma)
    x = _ln(params["dec_ln_f"], x, cfg.norm_eps)
    logits = L.gather_vocab(L.unembed(params, cfg, x, ma)[:, 0], cfg, ma)
    return logits, cache
