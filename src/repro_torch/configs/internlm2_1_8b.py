"""InternLM2-1.8B [arXiv:2403.17297].

Dense: 24L, d_model=2048, 16 heads (GQA kv=8), d_ff=8192, vocab=92544.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92544,
        rope_theta=1e6,
        source="arXiv:2403.17297",
    )
)
