"""LaneGCN-lite on Argoverse — the paper's trajectory-prediction model (§VI-C).

ActorNet (1D convs over the past track) + MapNet (graph convs over lane
nodes) + FusionNet (actor->map attention) + a regression head predicting
30 future positions (3 s at 10 Hz); 247,100 parameters in 20 leaves at
full width (``build_model(cfg).num_params()``).  ``d_model`` is the
feature width (128 at full size).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="lanegcn-argoverse",
        family="trajectory",
        num_layers=4,  # conv stages / gcn hops
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=0,
        dtype="float32",
        param_dtype="float32",
        source="paper §VI-C / Liang et al. ECCV20",
    )
)
