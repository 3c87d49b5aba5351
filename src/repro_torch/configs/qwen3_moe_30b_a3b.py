"""Qwen3-MoE-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

MoE: 48L, d_model=2048, 32 heads (GQA kv=4), vocab=151936,
128 routed experts top-8 (no shared experts), expert d_ff=768, qk_norm.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        moe_d_ff=768,
        vocab_size=151936,
        qk_norm=True,
        num_experts=128,
        num_experts_per_tok=8,
        num_shared_experts=0,
        rope_theta=1e6,
        source="hf:Qwen/Qwen3-30B-A3B",
    )
)
