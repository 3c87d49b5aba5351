"""Analytic step calculator (per arch x shape x world), the port of
``src/repro/launch/calculator.py`` with its formulas unchanged, so that
its values equal the reference's exactly: pure Python over
``ModelConfig`` and ``InputShape``.

The dry-run plan (``launch/dryrun.py``) and ``chip_smoke.py`` read these
FLOPs and HBM bytes for the roofline terms (``launch/roofline.py``) and
for a step's bound.  ``step_analytics`` defaults the model-parallel
degree ``mp`` to the reference's production mesh (16 at a world of 256
or more, else half the world); the port's callers pass their mesh's
model axis (``launch/dryrun.py --model M``: ``model_parallel=M``).

Formulas (documented napkin math):
* dense/moe/vlm attention layer fwd FLOPs per token (context c):
    qkvo projections 2*d*(2*H*hd + 2*KV*hd) + scores/values 2*2*c*H*hd
* MLP 3 matmuls (SwiGLU): 3*2*d*f; MoE: shared + top_k routed + router.
* Mamba2 (SSD): projections 2*d*(2*di + 2*n + h) + out 2*di*d
    + SSD intra-chunk 2*2*Q*di + state path 2*2*di*n.
* vocab head 2*d*V (+ tied embed read).
* train = 3x fwd (fwd + 2x bwd); AFL adds 4 elementwise passes over the
  client states (sparsify/error/aggregate/apply) — memory, not flops.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import InputShape, ModelConfig

BYTES = {"bfloat16": 2, "float32": 4, "float16": 2}


def _attn_layer_flops(cfg: ModelConfig, ctx: float) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * d * (2 * h * hd + 2 * kv * hd)
    attn = 2 * 2 * ctx * h * hd
    return proj + attn


def _mlp_layer_flops(cfg: ModelConfig) -> float:
    if not cfg.is_moe:
        return 3 * 2 * cfg.d_model * cfg.d_ff
    f = cfg.moe_d_ff or cfg.d_ff
    routed = cfg.num_experts_per_tok * 3 * 2 * cfg.d_model * f
    shared = cfg.num_shared_experts * 3 * 2 * cfg.d_model * f
    router = 2 * cfg.d_model * cfg.num_experts
    return routed + shared + router


def _mamba_layer_flops(cfg: ModelConfig, chunk_eff: float) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = cfg.ssm_heads or di // 64
    proj = 2 * d * (2 * di + 2 * n + h) + 2 * di * d
    ssd = 2 * 2 * chunk_eff * di + 2 * 2 * di * n
    return proj + ssd


def fwd_flops_per_token(cfg: ModelConfig, ctx: float, decode: bool = False) -> float:
    """Forward FLOPs per (decoder) token at attention context ``ctx``."""
    v = 2 * cfg.d_model * cfg.vocab_size
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        if cfg.sliding_window:
            ctx = min(ctx, cfg.sliding_window)
        per_layer = _attn_layer_flops(cfg, ctx) + _mlp_layer_flops(cfg)
        return cfg.num_layers * per_layer + v
    if fam == "ssm":
        chunk_eff = 1.0 if decode else cfg.ssm_chunk
        return cfg.num_layers * _mamba_layer_flops(cfg, chunk_eff) + v
    if fam == "hybrid":
        chunk_eff = 1.0 if decode else cfg.ssm_chunk
        n_attn = max((cfg.num_layers - 1) // cfg.attn_every, 1)
        mamba = cfg.num_layers * _mamba_layer_flops(cfg, chunk_eff)
        attn = n_attn * _attn_layer_flops(cfg, ctx)
        return mamba + attn + v
    if fam == "audio":
        # decoder: self-attn (ctx) + cross-attn (encoder_seq) + gelu mlp
        d, f = cfg.d_model, cfg.d_ff
        self_a = _attn_layer_flops(cfg, ctx)
        cross = _attn_layer_flops(cfg, cfg.encoder_seq)
        mlp = 2 * 2 * d * f
        return cfg.num_layers * (self_a + cross + mlp) + v
    raise ValueError(fam)


def encoder_flops(cfg: ModelConfig) -> float:
    """Whisper encoder, per sequence (not per decoder token)."""
    if cfg.family != "audio":
        return 0.0
    s = cfg.encoder_seq
    per_tok = cfg.encoder_layers * (
        _attn_layer_flops(cfg, s) + 2 * 2 * cfg.d_model * cfg.d_ff
    )
    return per_tok * s


@dataclasses.dataclass
class Analytic:
    flops_total: float  # whole step, all devices
    flops_per_device: float
    hbm_bytes_per_device: float
    tokens: int


def step_analytics(cfg: ModelConfig, shape: InputShape, world: int,
                   num_params: int, *, num_clients: int = 0,
                   model_parallel: int = 0) -> Analytic:
    b, s = shape.global_batch, shape.seq_len
    pb = BYTES.get(cfg.param_dtype, 2)
    ab = BYTES.get(cfg.dtype, 2)
    # model-parallel degree: parameters are sharded over `model` (16) by
    # default; the dp_client rules variant replicates params (mp=1)
    mp = model_parallel or (16 if world >= 256 else max(world // 2, 1))

    if shape.kind == "train":
        tokens = b * s
        f_tok = fwd_flops_per_token(cfg, ctx=s / 2)
        flops = 3.0 * f_tok * tokens + encoder_flops(cfg) * b * 3.0
        # HBM per device: each client slice touches its 3 states + grads +
        # upload/error temporaries: ~9 model-sized passes over params/mp,
        # plus activations once fwd + once bwd.
        params_dev = num_params / mp * pb
        act_dev = tokens / max(world // mp, 1) * cfg.d_model * max(cfg.num_layers, 1) * 6 * ab
        hbm = 9.0 * params_dev + 2.0 * act_dev
        return Analytic(flops, flops / world, hbm, tokens)

    if shape.kind == "prefill":
        tokens = b * s
        f_tok = fwd_flops_per_token(cfg, ctx=s / 2)
        flops = f_tok * tokens + encoder_flops(cfg) * b
        params_dev = num_params / mp * pb
        act_dev = tokens / max(world // mp, 1) * cfg.d_model * max(cfg.num_layers, 1) * 4 * ab
        hbm = params_dev + act_dev
        return Analytic(flops, flops / world, hbm, tokens)

    # decode
    tokens = b
    ctx = s
    f_tok = fwd_flops_per_token(cfg, ctx=ctx, decode=True)
    flops = f_tok * tokens
    params_dev = num_params / mp * pb
    if cfg.is_moe and getattr(cfg, "expert_dtype", "") == "int8":
        f = cfg.moe_d_ff or cfg.d_ff
        expert_params = cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * f
        params_dev -= expert_params / mp * (pb - 1)  # experts stored 1B/elem
    kv_b = 1 if getattr(cfg, "kv_cache_dtype", "") == "int8" else ab
    # KV-cache read per token decode
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        eff = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        if cfg.family == "hybrid":
            n_kv_layers = max((cfg.num_layers - 1) // cfg.attn_every, 1)
            eff = min(ctx, 8192)
        else:
            n_kv_layers = cfg.num_layers
        cache = b * eff * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * kv_b * n_kv_layers
    else:
        cache = 0.0
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm_expand * cfg.d_model
        h = cfg.ssm_heads or di // 64
        cache += cfg.num_layers * b * h * 64 * cfg.ssm_state * 4 * 2  # f32 rw
    # the cache is sharded over BOTH mesh axes (batch/seq on data, heads or
    # head_dim on model), so per-device traffic is cache/world.
    hbm = params_dev + cache / world
    return Analytic(flops, flops / world, hbm, tokens)
