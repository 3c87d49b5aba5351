"""ResNet-9 on CIFAR-10 — the paper's own image-classification model (§VI).

Nine conv layers + BN + ReLU, two residual blocks, global pooling, FC head;
6,573,130 parameters at full width (``build_model(cfg).num_params()``).
``d_model`` doubles as the base channel width (64 at full size).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="resnet9-cifar10",
        family="vision",
        num_layers=9,
        d_model=64,  # base width
        vocab_size=10,  # classes
        dtype="float32",
        param_dtype="float32",
        source="paper §VI / He et al. CVPR16",
    )
)
