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
* a cache whose slots are split over ranks: over a serve step's data
  ranks where its batch does not divide them (``seq_axis``), over the
  model axis where the rules cut the cache's ``head_dim`` (``slot_axis``,
  ``slot_cut``: the port cuts its slots, ``rules.model_slots``), the model
  block nested in the data block.  Each rank attends over its slots, by
  the ``decode_attn`` kernel's partials entry (a ring, ``window_pos``: the
  plain path's), and the partial softmaxes are merged over the model
  axis, then the data axis (``collectives.merge_partials``);
  ``cache_slot`` says which rank writes a step's token and how many of a
  rank's slots are valid, ``decode_cut`` the whole layout of a step.

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
heads read; where a serve cache's slots are cut over the axis,
``slot_cut``, ``attn_qkv`` gives every kv head's k and v, which
``head_kv`` cuts back for a whole-sequence attention, and the rank
gathers q over the axis for the decode attention, ``q_rows``).  When the q heads do not divide (24 or 28
heads on 16), the attention runs whole on every rank from gathered
leaves; an ``mlp`` or vocab that does not divide is held whole by the
rules and runs whole.

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
from repro_torch.sharding.rules import ParamSpec, model_slots

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
                     seq_axis=None, slot_axis=None,
                     rows: Optional[slice] = None):
    """Single-token attention against a KV cache.

    q: (B, H, D); caches: (B, S, KV, D); ``length``: the valid entries of
    the caches given, from slot 0 (a Python int: a rank's own count where
    its slots are a block of the cache's, ``CacheSlot.local_length``).
    Without ``window_pos`` this is the ``decode_attn`` kernel (its plain
    version on the CPU).  ``window_pos`` (ring-buffer mode): absolute
    positions per cache slot (B, S), -1 for an empty slot, used for
    masking instead of the slot index; that mode is the reference's plain
    einsum path here as there.

    A cache whose slots are split over ranks: ``slot_axis`` (the model
    axis, where the rules cut the cache's ``head_dim``: ``slot_cut``) and
    ``seq_axis`` (a ``ModelAxis`` over a serve step's data ranks, whose
    block holds the model blocks).  Each rank attends over its slots, by
    the kernel's partials entry (``ops.decode_attn_partials``; with
    ``window_pos`` the plain path's), and the partials are merged over
    ``slot_axis``, then ``seq_axis`` (``collectives.merge_partials``).
    ``rows``: q holds the rank's block ``rows`` of the heads (``q_rows``):
    it is gathered over ``slot_axis`` first, as every rank's slots serve
    every head, and the model merge's result is cut back to ``rows``.
    """
    if rows is not None:
        q = C.all_gather_(q, slot_axis, 1)
    split = _split(seq_axis) or _split(slot_axis)
    if window_pos is None:
        if not split:
            return ops.decode_attn(q, k_cache, v_cache, length)
        part = ops.decode_attn_partials(q, k_cache, v_cache, length)
        return _merged(part, slot_axis, seq_axis, rows).to(q.dtype)
    b, s, kv, d = k_cache.shape
    h = q.shape[1]
    groups = h // max(kv, 1)
    qf = q.to(F32).reshape(b, kv, groups, d)
    s_ = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(F32)) / math.sqrt(d)
    valid = window_pos >= 0
    s_ = torch.where(valid[:, None, None, :], s_, -torch.inf)
    if split:
        return _merged(_partials(s_, None, v_cache), slot_axis, seq_axis,
                       rows).to(q.dtype)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return out.reshape(b, h, d).to(q.dtype)


def _partials(s_, v_scale, v_cache) -> tuple:
    """The partial softmax of masked scores ``s_`` (B, KV, G, S_rank) over
    the rank's slots, in head order, as ``ops.decode_attn_partials`` gives
    it: (m (B, H), l (B, H), o (B, H, D)) f32, an int8 cache's
    ``v_scale`` on the probability rows.  A rank with no valid slot gives
    m = -inf, l = o = 0, no NaN."""
    b, kv, g, s = s_.shape
    m = s_.amax(-1) if s else s_.new_full((b, kv, g), -torch.inf)
    p = torch.exp(s_ - m[..., None])
    p = torch.where(torch.isfinite(m)[..., None], p, 0.0)
    l = p.sum(-1)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(F32))
    return m.reshape(b, kv * g), l.reshape(b, kv * g), o.reshape(b, kv * g, -1)


def _merged(part: tuple, slot_axis, seq_axis, rows) -> torch.Tensor:
    """(B, H, D) f32 attention from the rank's partials ``part``: merged
    over ``slot_axis`` (then cut to ``rows``) and over ``seq_axis``."""
    m, l, o = C.merge_partials(*part, slot_axis)
    if rows is not None:
        m, l, o = m[:, rows], l[:, rows], o[:, rows]
    return C.merge_softmax(m, l, o, seq_axis)


@dataclasses.dataclass(frozen=True)
class CacheSlot:
    """Where one decode step's token goes in a cache whose slots may be
    split over ranks: ``window`` the whole cache's slots, ``local`` the
    token's slot in this rank's block (None where another rank owns it),
    ``length`` the valid slots of the whole cache, ``start`` and ``size``
    the rank's block of them."""

    window: int
    local: Optional[int]
    length: int
    start: int
    size: int

    @property
    def local_length(self) -> int:
        """The valid slots of the rank's block of a cache without a ring
        (the whole cache's valid slots are its first ``length``)."""
        return min(max(self.length - self.start, 0), self.size)

    def within(self, block: slice) -> "CacheSlot":
        """The same token in ``block`` of the rank's slots (the model
        axis's cut, ``cache_block``)."""
        size = block.stop - block.start
        local = None if self.local is None else self.local - block.start
        return CacheSlot(self.window,
                         local if local is not None and 0 <= local < size
                         else None, self.length, self.start + block.start,
                         size)


def cache_slot(pos: int, slots: int, ring: bool, seq_axis=None) -> CacheSlot:
    """The slot of position ``pos`` in a cache of which this rank holds
    ``slots`` (block ``seq_axis.rank`` of ``seq_axis.size`` equal blocks;
    all of them without the axis): ``pos % window`` in a ring, ``pos``
    otherwise.  ``CacheSlot.within`` cuts the model axis's block out of
    the rank's slots."""
    n = seq_axis.size if _split(seq_axis) else 1
    r = seq_axis.rank if n > 1 else 0
    window = slots * n
    slot = pos % max(window, 1) if ring else pos
    if slot >= window:
        raise IndexError(f"position {pos} is past the cache's {window} "
                         f"slots")
    local = slot - r * slots
    return CacheSlot(window, local if 0 <= local < slots else None,
                     min(pos + 1, window), r * slots, slots)


@dataclasses.dataclass(frozen=True)
class DecodeCut:
    """One decode step's layout on this rank (``decode_cut``): ``token``
    the token in the whole cache (``window``, ``length``), ``slot`` its
    slot in the rank's k and v block (None where another rank writes it),
    ``length`` the valid slots of that block (``CacheSlot.
    local_length``), and ``decode_attention``'s layout arguments."""

    token: CacheSlot
    slot: Optional[int]
    length: int
    window_pos: Optional[torch.Tensor]
    seq_axis: object
    slot_axis: object
    rows: Optional[slice]

    @property
    def kw(self) -> dict:
        """``decode_attention``'s keywords over the step's cache."""
        return dict(window_pos=self.window_pos, seq_axis=self.seq_axis,
                    slot_axis=self.slot_axis, rows=self.rows)


def decode_cut(cfg, model_axis, seq_axis, pos_cache, pos: int,
               ring: bool) -> DecodeCut:
    """Where a decode step's token at ``pos`` and the valid slots lie once
    a cache's slots are cut over ``seq_axis`` (a serve step's data ranks)
    and over ``model_axis`` (``cache_block``, nested in the data block):
    writes ``pos`` into ``pos_cache`` (B, slots), the rank's positions,
    whole on the model axis, where the rank holds the token's slot.  A
    ring (``ring``) passes its block of the positions as ``window_pos``."""
    sa = seq_axis if _split(seq_axis) else None
    slots = pos_cache.shape[1]
    token = cache_slot(pos, slots, ring, sa)
    blk = cache_block(cfg, model_axis, slots)
    kvs = token if blk is None else token.within(blk)
    if token.local is not None:
        pos_cache[:, token.local] = pos
    wpos = None
    if ring:
        wpos = pos_cache if blk is None else pos_cache[:, blk]
    return DecodeCut(token, kvs.local, kvs.local_length, wpos, sa,
                     None if blk is None else model_axis,
                     q_rows(cfg, model_axis))


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
                       seq_axis=None, slot_axis=None,
                       rows: Optional[slice] = None):
    """``decode_attention`` over an int8 cache; the scales multiply the
    score and probability rows, so the dequantised cache never exists.
    Plain torch, as the reference's is plain ``jnp``; a split cache's
    rank masks its slots past ``length`` (its own count) and merges as
    ``decode_attention``'s, whose other arguments these are.

    q: (B, H, D); kq, vq: (B, S, KV, D) int8; scales: (B, S, KV) f32."""
    if rows is not None:
        q = C.all_gather_(q, slot_axis, 1)
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
    if _split(seq_axis) or _split(slot_axis):
        return _merged(_partials(s_, v_scale, vq), slot_axis, seq_axis,
                       rows).to(q.dtype)
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


def cache_block(cfg, model_axis, slots: int) -> Optional[slice]:
    """The rank's block of a serve cache's ``slots`` where the rules cut
    its ``head_dim`` over ``model_axis`` (``rules.model_slots``: the port
    cuts its slots there), else None (the rank holds every slot)."""
    if not _split(model_axis) or not cfg.num_heads:
        return None
    return model_slots(slots, cfg.num_kv_heads, cfg.resolved_head_dim,
                       model_axis.size, model_axis.rank)


def cache_slots(cfg, model_axis, slots: int) -> int:
    """How many of a serve cache's ``slots`` a rank holds: its block's
    (``cache_block``), or every one."""
    blk = cache_block(cfg, model_axis, slots)
    return slots if blk is None else blk.stop - blk.start


def slot_cut(cfg, model_axis):
    """``model_axis`` where a serve cache's slots are cut over it
    (``cache_block``), else None."""
    return None if cache_block(cfg, model_axis, 0) is None else model_axis


def cache_kv(cfg, model_axis) -> tuple:
    """The kv heads a rank's serve cache holds: every one where its slots
    are cut (``slot_cut``), else those its q heads read (``head_plan``)."""
    if slot_cut(cfg, model_axis) is not None:
        return tuple(range(cfg.num_kv_heads))
    return head_plan(cfg, model_axis).kv


def q_rows(cfg, model_axis) -> Optional[slice]:
    """Where the rank runs its block of the q heads over a cache cut on
    its slots: that block, whose q it gathers over the axis before the
    decode attention and whose rows it keeps after the merge
    (``decode_attention(rows=)``); else None."""
    if slot_cut(cfg, model_axis) is None or not head_plan(
            cfg, model_axis).split:
        return None
    hl = cfg.num_heads // model_axis.size
    return slice(model_axis.rank * hl, (model_axis.rank + 1) * hl)


def head_kv(t, cfg, model_axis):
    """Of ``t`` (B, S, KV, D), ``attn_qkv``'s k or v, the kv heads the
    rank's q heads read (``head_plan``), for an attention over the whole
    sequence: ``t`` itself unless it holds every kv head where the rank
    runs its block of the q heads (a cache cut on its slots,
    ``slot_cut``)."""
    plan = head_plan(cfg, model_axis)
    if not plan.split or slot_cut(cfg, model_axis) is None:
        return t
    return t.index_select(2, torch.tensor(plan.kv, device=t.device))


def prompt_slots(cfg, model_axis, seq_axis, max_seq: int) -> tuple:
    """Where a prefill's cache of ``max_seq`` slots lies on this rank:
    (its slots, ``max_seq`` or its block of them over ``seq_axis``, a
    serve step's data axis of equal blocks; the whole slot of its first;
    the whole slot of the first its k and v hold, past the model block's
    start where they are cut over ``model_axis``, ``cache_block``)."""
    n = seq_axis.size if _split(seq_axis) else 1
    if max_seq % n:
        raise ValueError(f"{max_seq} cache slots do not divide over {n} "
                         f"ranks")
    slots = max_seq // n
    first = (seq_axis.rank if n > 1 else 0) * slots
    blk = cache_block(cfg, model_axis, slots)
    return slots, first, first + (0 if blk is None else blk.start)


def write_block(dst, t, at: int) -> None:
    """A prompt's ``t`` (B, S, ...) into ``dst`` (B, slots, ...), a rank's
    block of a cache whose slot 0 is the whole cache's slot ``at``: the
    prompt's entries that fall in it."""
    lo, hi = max(at, 0), min(at + dst.shape[1], t.shape[1])
    if hi > lo:
        dst[:, lo - at:hi - at] = t[:, lo:hi].to(dst.dtype)


def prompt_positions(pos, s: int, first: int) -> None:
    """A prefill's positions (B, slots) in place: whole slot ``first`` + j
    holds position ``first`` + j of a prompt of ``s``, -1 past it."""
    whole = first + torch.arange(pos.shape[1], dtype=torch.int32,
                                 device=pos.device)
    pos.copy_(torch.where(whole < s, whole, -1).expand_as(pos))


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
    ("sum") and cut to the kv heads its q heads read (every kv head where
    a serve cache's slots are cut, ``slot_cut``: the cache holds them
    all); every leaf gathered ("slice") where the q heads do not divide
    (every rank runs every head)."""
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
        every = slot_cut(cfg, model_axis) is not None
        idx = torch.tensor(plan.kv, device=p["wk"].device)
        for key, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if key in p and key in keys:
                w = whole(p[key], full[key], model_axis, "sum")
                p[key] = w if every else w.index_select(dim, idx)
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
    (``head_plan``; all of them without a model axis); where a serve
    cache's slots are cut over the axis (``slot_cut``) k and v of every kv
    head, which ``head_kv`` cuts to the rank's."""
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
