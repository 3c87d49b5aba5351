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
  torch, as the reference's is plain ``jnp`` outside any kernel;
* a cache whose slots are split over a serve step's data ranks (the
  long_500k ring, ``seq_axis``): each rank attends over its slots on the
  plain path and the partial softmaxes are merged
  (``collectives.merge_softmax``); ``cache_slot`` says which rank writes a
  step's token.

Tensor parallelism over a ``model`` axis (``model_axis``, a
``sharding.collectives.ModelAxis``; None, or an axis of one, runs the
functions as they are).  Each rank holds its block of every leaf, cut by
the rules (``sharding/rules.py``), and the layers compute on blocks:

* ``embed``: vocab-parallel (rows outside the rank's range give zero,
  then an all-reduce);
* ``attn_qkv``: column-parallel over the rank's heads, which run whole
  GQA groups (``head_plan``); ``attn_out``: row-parallel, then an
  all-reduce;
* ``mlp_apply``: ``wi_gate`` and ``wi_up`` column-parallel on ``mlp``,
  ``wo`` row-parallel, then an all-reduce;
* ``unembed`` and ``cross_entropy``: vocab-parallel (each rank's
  log-sum-exp over its block, the blocks' combined; the label's logit from
  the rank that holds it), the same loss; a tied embedding alike.

Where the rules shard a dim the layer cannot split its work on, the layer
gathers that leaf over ``model`` before use, and its gradient returns to
the block: ``q_norm`` / ``k_norm`` (``head_dim``), and ``wk``, ``wv``,
``bk``, ``bv`` when the kv heads do not divide over the axis (they fall
back to ``head_dim``: the rank gathers them and keeps the kv heads its q
heads read).  When the q heads do not divide (24 or 28 heads on 16), the
attention runs whole on every rank from gathered leaves; an ``mlp`` or
vocab that does not divide is held whole by the rules and runs whole.

The reference's ``_replicate`` (``repro/models/layers.py:211-225``) is a
GSPMD hint, a sharding constraint on an activation inside one program;
with explicit blocks and collectives it has no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.remat import dot
from repro_torch.sharding import collectives as C
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
                     window_pos: Optional[torch.Tensor] = None,
                     seq_axis=None):
    """Single-token attention against a KV cache.

    q: (B, H, D); caches: (B, S, KV, D); ``length``: number of valid cache
    entries (a Python int).  Without ``window_pos`` this is the
    ``decode_attn`` kernel (its plain version on the CPU).  ``window_pos``
    (ring-buffer mode): absolute positions per cache slot (B, S), -1 for an
    empty slot, used for masking instead of the slot index; that mode is
    the reference's plain einsum path here as there.  ``seq_axis`` (a
    ``ModelAxis`` over the ranks that split the cache's slots, with
    ``window_pos``): the caches are the rank's slots, each rank attends
    over its own and ``collectives.merge_softmax`` puts them together.
    """
    if window_pos is None:
        _unsplit(seq_axis)
        return ops.decode_attn(q, k_cache, v_cache, length)
    b, s, kv, d = k_cache.shape
    h = q.shape[1]
    groups = h // max(kv, 1)
    qf = q.to(F32).reshape(b, kv, groups, d)
    s_ = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(F32)) / math.sqrt(d)
    valid = window_pos >= 0
    s_ = torch.where(valid[:, None, None, :], s_, -torch.inf)
    if _split(seq_axis):
        return _merged(s_, None, v_cache, seq_axis).reshape(b, h, d).to(
            q.dtype)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return out.reshape(b, h, d).to(q.dtype)


def _unsplit(seq_axis) -> None:
    """Slots split over ranks are masked by their positions: a split
    cache without ``window_pos`` has none to attend by."""
    if _split(seq_axis):
        raise ValueError("a cache whose slots are split over ranks "
                         "(seq_axis) needs window_pos")


def _merged(s_, v_scale, v_cache, seq_axis):
    """(B, KV, G, D) attention over every rank's slots from this rank's
    masked scores ``s_`` (B, KV, G, S_rank): its partial max, sum and
    unnormalised output (an int8 cache's ``v_scale`` on the probability
    rows), merged over ``seq_axis``.  A rank with no valid slot gives a
    max of -inf, no NaN, and adds nothing."""
    m = s_.amax(-1)
    p = torch.exp(s_ - m[..., None])
    p = torch.where(torch.isfinite(m)[..., None], p, 0.0)
    l = p.sum(-1)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return C.merge_softmax(m, l, o, seq_axis)


@dataclasses.dataclass(frozen=True)
class CacheSlot:
    """Where one decode step's token goes in a cache whose slots may be
    split over ``seq_axis``: ``window`` the whole cache's slots, ``local``
    the token's slot in this rank's block (None where another rank owns
    it), ``length`` the valid slots of the whole cache."""

    window: int
    local: Optional[int]
    length: int


def cache_slot(pos: int, slots: int, ring: bool, seq_axis=None) -> CacheSlot:
    """The slot of position ``pos`` in a cache of which this rank holds
    ``slots`` (block ``seq_axis.rank`` of ``seq_axis.size`` equal blocks;
    all of them without the axis): ``pos % window`` in a ring, ``pos``
    otherwise.  Only a ring's slots may be split: a cache without one
    attends through the ``decode_attn`` kernel, which has no merge."""
    if _split(seq_axis) and not ring:
        raise ValueError("a cache whose slots are split over ranks "
                         "(seq_axis) must be a ring: a decode's batch "
                         "that the data axis divides keeps them whole")
    n = seq_axis.size if _split(seq_axis) else 1
    r = seq_axis.rank if n > 1 else 0
    window = slots * n
    slot = pos % max(window, 1) if ring else pos
    if slot >= window:
        raise IndexError(f"position {pos} is past the cache's {window} "
                         f"slots")
    local = slot - r * slots
    return CacheSlot(window, local if 0 <= local < slots else None,
                     min(pos + 1, window))


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
                       window_pos: Optional[torch.Tensor] = None,
                       seq_axis=None):
    """``decode_attention`` over an int8 cache; the scales multiply the
    score and probability rows, so the dequantised cache never exists.
    Plain torch, as the reference's is plain ``jnp``.  ``seq_axis`` as
    ``decode_attention``'s.

    q: (B, H, D); kq, vq: (B, S, KV, D) int8; scales: (B, S, KV) f32."""
    b, s, kv, d = kq.shape
    h = q.shape[1]
    groups = h // max(kv, 1)
    qf = q.to(F32).reshape(b, kv, groups, d)
    s_ = torch.einsum("bkgd,bskd->bkgs", qf, kq.to(F32)) / math.sqrt(d)
    s_ = s_ * k_scale.permute(0, 2, 1)[:, :, None, :]  # (B,KV,1,S)
    if window_pos is None:
        _unsplit(seq_axis)
        valid = (torch.arange(s, device=q.device) < length)[None].expand(b, s)
    else:
        valid = window_pos >= 0
    s_ = torch.where(valid[:, None, None, :], s_, -torch.inf)
    if _split(seq_axis):
        return _merged(s_, v_scale, vq, seq_axis).reshape(b, h, d).to(q.dtype)
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


def _split(axis) -> bool:
    return axis is not None and axis.size > 1


def whole(w, shape, axis, grad: str):
    """Leaf ``w`` whole: gathered over ``axis`` along the dim its block
    is cut on (the one where its shape and ``shape`` differ), or itself
    when it is not cut.  ``grad`` as ``collectives.gather``'s."""
    if tuple(w.shape) == tuple(shape):
        return w
    dim = next(i for i, (a, b) in enumerate(zip(w.shape, shape)) if a != b)
    return C.gather(w, axis, dim, grad)


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """How a rank of the model axis splits the attention: ``split``, it
    runs its block of hl q heads (else every head); ``kv`` the global kv
    head of each of its kv slots (its q head j reads slot j // (hl //
    len(kv))); ``kv_block``, those are its block of ``wk`` and ``wv``
    (else it gathers them and keeps these heads)."""

    split: bool
    kv: Tuple[int, ...]
    kv_block: bool


def head_plan(cfg, axis) -> HeadPlan:
    """The rank's heads.  Its q heads are its block when they divide over
    the axis (as the rules shard ``heads``); their kv heads, each once when
    every one serves the same number of them, else one a q head (a group
    cut by a block boundary)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if not _split(axis) or h % axis.size:
        return HeadPlan(False, tuple(range(kv)), True)
    hl = h // axis.size
    h0 = axis.rank * hl
    of = [j // (h // kv) for j in range(h0, h0 + hl)]
    uniq = sorted(set(of))
    even = all(of.count(u) == hl // len(uniq) for u in uniq)
    return HeadPlan(True, tuple(uniq) if even else tuple(of),
                    kv % axis.size == 0)


def gathered_leaves(cfg, m: int) -> tuple:
    """The attention leaves of a layer that a rank of a model axis of
    ``m`` gathers before use (``attn_qkv``, ``attn_out``): (name, whole
    shape, the gradient's return: "sum" or "slice") each."""
    from repro_torch.sharding.collectives import ModelAxis
    from repro_torch.sharding.rules import RULES_TRAIN, logical_to_pspec

    if m == 1:
        return ()
    plan = head_plan(cfg, ModelAxis(None, 0, m))
    out = []
    for name, sp in sorted(attn_specs(cfg).items()):
        if not logical_to_pspec(sp.dims, sp.shape, RULES_TRAIN, {"model": m}):
            continue  # whole on every rank
        if not plan.split:
            out.append((name, sp.shape, "slice"))
        elif name in ("q_norm", "k_norm") or (
                name in ("wk", "wv", "bk", "bv") and not plan.kv_block):
            out.append((name, sp.shape, "sum"))
    return tuple(out)


Q_KEYS = ("wq", "bq", "q_norm")  # the leaves the queries read
KV_KEYS = ("wk", "wv", "bk", "bv", "k_norm")  # the keys' and values'


def head_leaves(p, cfg, model_axis, keys=Q_KEYS + KV_KEYS) -> dict:
    """Attention ``p`` with its leaves ``keys`` as the rank's heads read
    them (``head_plan``): its blocks, where the q heads divide over the
    axis, with ``q_norm`` / ``k_norm`` gathered ("sum") and, where the kv
    heads do not divide, ``wk`` / ``wv`` / ``bk`` / ``bv`` gathered
    ("sum") and cut to the kv heads its q heads read; every leaf gathered
    ("slice") where the q heads do not divide (every rank runs every
    head)."""
    p = dict(p)
    if not _split(model_axis):
        return p
    hd = cfg.resolved_head_dim
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    plan = head_plan(cfg, model_axis)
    full = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
            "bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd),
            "q_norm": (hd,), "k_norm": (hd,)}
    if not plan.split:  # every rank runs every head
        for key in full:
            if key in p and key in keys:
                p[key] = whole(p[key], full[key], model_axis, "slice")
        return p
    if not plan.kv_block:  # (a host list to the card waits for it)
        idx = torch.tensor(plan.kv, device=p["wk"].device)
        for key, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if key in p and key in keys:
                p[key] = whole(p[key], full[key], model_axis,
                               "sum").index_select(dim, idx)
    for key in ("q_norm", "k_norm"):
        if key in p and key in keys:
            p[key] = whole(p[key], full[key], model_axis, "sum")
    return p


def _project(p, cfg, x, w: str, b: str, norm: str | None = None):
    """One of the attention's input projections (B, S, heads, D)."""
    y = dot(x, p[w].to(x.dtype), "bsd,dhk->bshk")
    if cfg.qkv_bias:
        y = y + p[b].to(x.dtype)
    if cfg.qk_norm and norm:
        y = rms_norm(y, p[norm], cfg.norm_eps)
    return y


def _column(p, cfg, x, model_axis, keys):
    """``head_leaves`` of ``p`` and ``x`` as the rank's heads take it:
    through ``copy_to`` where the rank runs its block of the heads (a
    column-parallel region)."""
    p = head_leaves(p, cfg, model_axis, keys)
    if _split(model_axis) and head_plan(cfg, model_axis).split:
        x = C.copy_to(x, model_axis)
    return p, x


def attn_qkv(p, cfg, x, model_axis=None):
    """q (B, S, hl, D), k and v (B, S, len(kv), D) of the rank's heads
    (``head_plan``; all of them without a model axis)."""
    p, x = _column(p, cfg, x, model_axis, Q_KEYS + KV_KEYS)
    return (_project(p, cfg, x, "wq", "bq", "q_norm"),
            _project(p, cfg, x, "wk", "bk", "k_norm"),
            _project(p, cfg, x, "wv", "bv"))


def attn_q(p, cfg, x, model_axis=None):
    """``attn_qkv``'s q alone (a cross-attention's queries)."""
    p, x = _column(p, cfg, x, model_axis, Q_KEYS)
    return _project(p, cfg, x, "wq", "bq", "q_norm")


def attn_out(p, x_attn, dtype, cfg=None, model_axis=None):
    """The output projection: row-parallel over the rank's heads, then an
    all-reduce; with every head on the rank, ``wo`` whole."""
    if not _split(model_axis):
        return dot(x_attn, p["wo"].to(dtype), "bshk,hkd->bsd")
    if head_plan(cfg, model_axis).split:
        return C.reduce_from(dot(x_attn, p["wo"].to(dtype), "bshk,hkd->bsd"),
                             model_axis)
    wo = whole(p["wo"], (cfg.num_heads, cfg.resolved_head_dim, cfg.d_model),
               model_axis, "slice")
    return dot(x_attn, wo.to(dtype), "bshk,hkd->bsd")


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


def mlp_apply(p, x, model_axis=None, d_ff: int = 0):
    """SwiGLU; over a model axis whose rank holds its ``mlp`` block of the
    ``d_ff`` hidden units, column- then row-parallel and an all-reduce."""
    split = _split(model_axis) and p["wi_gate"].shape[1] != d_ff
    if split:
        x = C.copy_to(x, model_axis)
    g = dot(x, p["wi_gate"].to(x.dtype))
    u = dot(x, p["wi_up"].to(x.dtype))
    y = dot(silu_f32(g) * u, p["wo"].to(x.dtype))
    return C.reduce_from(y, model_axis) if split else y


def cross_entropy(logits, labels, cfg=None, model_axis=None):
    """Mean next-token cross-entropy over all positions, in f32.  Over a
    model axis ``logits`` are the rank's vocabulary block
    (``unembed``'s): the blocks' log-sum-exps are gathered and combined,
    and the label's logit comes from the rank that holds it."""
    lf = logits.to(F32)
    if not _split(model_axis) or lf.shape[-1] == cfg.vocab_size:
        lse = torch.logsumexp(lf, dim=-1)
        label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        return torch.mean(lse - label_logit)
    vl = lf.shape[-1]
    lse_r = torch.logsumexp(lf, dim=-1, keepdim=True)
    lse = torch.logsumexp(C.gather(lse_r, model_axis, -1, "slice"), dim=-1)
    idx = labels.long() - model_axis.rank * vl
    ok = (idx >= 0) & (idx < vl)
    pick = torch.gather(lf, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    label_logit = C.reduce_from(torch.where(ok, pick, 0.0), model_axis)
    return torch.mean(lse - label_logit)


def embed_specs(cfg) -> dict:
    return {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="small")}


def embed(params, cfg, tokens, model_axis=None):
    """Token embeddings; vocab-parallel over a model axis (the rank's rows
    give their embeddings, the others zero, then an all-reduce)."""
    tok = params["embed"]["tok"]
    vl = tok.shape[0]
    if not _split(model_axis) or vl == cfg.vocab_size:
        return tok[tokens.long()].to(cfg.activation_dtype)
    idx = tokens.long() - model_axis.rank * vl
    ok = (idx >= 0) & (idx < vl)
    x = tok[idx.clamp(0, vl - 1)].to(cfg.activation_dtype)
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return C.reduce_from(x, model_axis)


def unembed(params, cfg, x, model_axis=None):
    """Project to vocab logits (tied or untied): over a model axis, the
    rank's vocabulary block of them (``gather_vocab`` puts them
    together)."""
    w = (params["embed"]["tok"] if cfg.tie_embeddings
         else params["unembed"]["w"])
    vl = w.shape[0] if cfg.tie_embeddings else w.shape[1]
    if _split(model_axis) and vl != cfg.vocab_size:
        x = C.copy_to(x, model_axis)
    if cfg.tie_embeddings:
        return x @ w.to(x.dtype).T
    return x @ w.to(x.dtype)


def gather_vocab(logits, cfg, model_axis=None):
    """Every vocabulary block of ``unembed``'s logits, put together."""
    if not _split(model_axis) or logits.shape[-1] == cfg.vocab_size:
        return logits
    return C.gather(logits, model_axis, logits.dim() - 1, "slice")
