"""Mamba2-2.7B — SSD (state-space duality) [arXiv:2405.21060].

SSM (attention-free): 64L, d_model=2560, vocab=50280, ssm_state=128.
expand=2 -> d_inner=5120, head_dim=64 -> 80 SSD value heads.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_heads=80,  # d_inner / 64
        ssm_chunk=256,
        conv_kernel=4,
        norm_eps=1e-5,
        source="arXiv:2405.21060",
    )
)
