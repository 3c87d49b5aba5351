"""Qwen2-VL-72B language backbone [arXiv:2409.12191].

VLM: 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064.
M-RoPE (temporal/height/width sections over the head dim); the vision
encoder (ViT + merger) is a STUB, as in the reference: ``vision_embeds``
arrive as precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        mrope_sections=(16, 24, 24),  # t/h/w per Qwen2-VL (sums to head_dim/2)
        source="arXiv:2409.12191",
    )
)
