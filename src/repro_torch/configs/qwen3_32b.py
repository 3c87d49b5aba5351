"""Qwen3-32B [hf:Qwen/Qwen3-8B family card, 32B variant].

Dense: 64L, d_model=5120, 64 heads (GQA kv=8), d_ff=25600, vocab=151936.
qk_norm (per-head RMSNorm on q/k) — Qwen3 signature; no QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B",
    )
)
