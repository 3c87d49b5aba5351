"""Zamba2-7B [arXiv:2411.15242].

Hybrid: 81-layer Mamba2 backbone with a SHARED attention block applied
every 6 layers. d_model=3584, 32 heads (kv=32) in the shared block,
d_ff=14336, vocab=32000, ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_heads=112,  # d_inner=7168 / 64
        ssm_chunk=256,
        conv_kernel=4,
        attn_every=6,
        norm_eps=1e-5,
        source="arXiv:2411.15242",
    )
)
