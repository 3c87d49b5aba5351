"""Whisper-large-v3 [arXiv:2212.04356].

Audio encoder-decoder: 32L decoder (+32L encoder), d_model=1280,
20 heads (kv=20, i.e. MHA), d_ff=5120, vocab=51866.
The mel-spectrogram + conv frontend is a STUB, as in the reference:
``frames`` arrive as precomputed frame embeddings (1500 frames).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        qkv_bias=True,
        encoder_layers=32,
        encoder_seq=1500,
        norm_eps=1e-5,
        source="arXiv:2212.04356",
    )
)
