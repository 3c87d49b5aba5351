"""Qwen2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

MoE: 24L, d_model=2048, 16 heads (GQA kv=16), vocab=151936,
60 routed experts top-4 + 4 shared experts, expert d_ff=1408.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        moe_d_ff=1408,
        vocab_size=151936,
        qkv_bias=True,
        num_experts=60,
        num_experts_per_tok=4,
        num_shared_experts=4,
        rope_theta=1e6,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )
)
