"""Qwen2-7B [arXiv:2407.10671].

Dense: 28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064.
QKV bias enabled (Qwen2 signature).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        source="arXiv:2407.10671",
    )
)
