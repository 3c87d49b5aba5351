"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B family card, 3B variant].

Dense: 28L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=128256.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3.2-3b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=5e5,
        tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B",
    )
)
